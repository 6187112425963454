#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's verdict and serving paths on one NVIDIA
card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero:

1. device: name, compute capability (must be 9.x, Hopper) and power
   limit.
2. build: the kernel ``cilium_tpu_torch/csrc/dense_verdict.cu``
   compiled by nvcc for sm_90a; then its SASS, read by cuobjdump, gives
   the instructions a (packet, entry) pair issues per pipe in the
   verdict kernel's segment loop, from which the kernel's bound is
   computed; a second bound takes the function's own three compares a
   pair on the ALU pipe.
3. refusals: on the card, a table whose endpoints are not contiguous
   raises in ``dense_segments``, and segments of other tables, or of
   tables changed in place since, raise in ``dense_verdict``.  Then
   parity: each kernel's wrapper against its plain PyTorch version on
   the card, bit-exact (tolerance 0: int32 verdicts and counters), on
   ragged batches, many entry tiles, identities >= 2**31, ports >= 32768
   and proxy-port values, and on the edges of the kernel's grouping by
   endpoint: every packet on one endpoint, an endpoint without entries,
   endpoints out of range, every packet deciding on one entry, a
   segment over two tiles, a batch that is no block multiple.
4. config1: the port's config-1 path (ipcache LPM -> 3-stage verdict ->
   per-entry counters) through both engines, hash and dense, at
   B = 2**20 packets for two policy states, BASELINE config 1 (100 rules
   x 16 endpoints) and the 10k-rule north-star state, each on two
   packet streams: the bench's uniform one (the main path) and an
   allow-heavy one (``workloads.config1_allow_heavy_packets``).  Hash
   verdicts must equal dense verdicts, both must equal the scalar
   oracle on a 4,096 packet sample, the dense kernel must have been
   launched, and the kernel must equal its plain version on the whole
   batch (verdicts and every entry's counters).  Then both engines and
   the kernel alone are timed with CUDA events, the kernel's device
   time is split by kernel with torch.profiler (the grouping's share),
   and the plain version is timed on the uniform batch.
5. v4: the v4 stateful serving step (prefilter -> service DNAT ->
   conntrack -> ipcache -> policy -> CT create -> rev-NAT -> overlay)
   through ``Datapath.process_packed`` at the full width of the
   north-star state (``workloads.v4_serving_state``: the 10k-rule policy,
   10,000 services, 1,000 prefilter CIDRs, 256 peer nodes, a 2**20-slot
   conntrack table).  Parity, with the daemon's flow table off and then
   on (4,096 slots, probe 8, the claim on every 4th call): the same port
   on the card and on the CPU, from one seed, 2 batches at B = 2**20
   then 8 at B = 2**16 across a GC and a restore of a conntrack snapshot
   taken mid-run; after every batch verdicts, events, identities, every
   NAT field, the counters, every CT field (sentinel included), every
   flow-table lane and the provenance are compared bit for bit and the
   mismatch counts printed.  Then the no-host-read check
   (``sync_check``): calls on batches already on the card under
   ``torch.cuda.set_sync_debug_mode("error")``, and calls behind a
   half-second ``torch.cuda._sleep``, traced by ``torch.profiler``, that
   must return before the sleep ends or, where a step has more kernels
   than the launch queue holds, show no synchronising or copying CUDA
   runtime call and a kernel launch as what held the host; a control
   step that reads one verdict back must be flagged.  Timing of
   ``process_packed`` (one H2D of the [10, B] matrix from a pinned
   buffer per call) and of ``process`` (ten H2D copies) with CUDA events
   after warm-up batches that fill the table, the table's occupancy,
   the shares of verdicts and events, and a ``torch.profiler``
   breakdown; then, with the flow table on, its occupancy and lost
   share after warm-up, the no-host-read check over claiming and
   claim-free calls, timing and profile.  No hand-written kernel runs
   on this path: the dense kernel's launch count, set to 0 before it,
   is read after it.
6. v6: the same for ``Datapath.process6`` over the v6 twin of that state
   (``workloads.v6_of``: every address embedded in ``fd00::/96``, the
   ICMPv6/NDP responder answering for the node's router, 1% ICMPv6
   traffic): parity with flows and provenance on, the tables' bytes on
   the card, and the no-host-read check, timing and profile with the
   flow table off and on.
7. config2: BASELINE config 2 (``workloads.build_config2``: 10,000
   endpoints x 1,000 exact INGRESS rules, 10M entries, 256 buckets of 8
   slots an endpoint) on the two-choice ``BucketVerdictEngine`` at
   B = 2**20, the identity-l4 bench's traffic (half installed keys, half
   misses).  The host build time and table sizes; the card against the
   same engine on the CPU over 3 batches (every verdict, both counter
   arrays after each); the flat-array oracle on 4,096 packets; a
   smaller mixed-kind case (exact, L3-only and wildcard entries with
   proxy ports, fragments, wrapping byte counters) card against CPU and
   the map-state oracle; the no-host-read check (``no_host_read``);
   CUDA-event timing of 60 batches and a profile.
8. l7: BASELINE configs 3-5 at ``bench_suite.py``'s shapes.  HTTP (4
   rules, 6 paths x 3 methods) and FQDN (3 selectors) at the bench
   batch (32,768) and at 2**20 rows: each engine on the card against a
   CPU twin built with the card's selection, on every row, and Python
   ``re`` (``oracle_match``) on a sample; the host ``encode_packed``
   time; ``match_device`` on pre-encoded blocks already on the card:
   no host read, CUDA-event timing, profile.  Header rules and long
   payloads at the default batch hint (the card selects ``assoc``),
   and every ``DFAEngine`` strategy x dtype, card against CPU.  Kafka
   ACLs run on the host only; their host rate is printed as such.
9. the kernels line (the dense kernel's launches on the config-2 and L7
   paths, 0, beside those of v4 and v6), the card's name and power
   limit from nvidia-smi, and a last line ``{"ok": true, "device":
   {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from cilium_tpu_torch import kernels, sass_mix
from cilium_tpu_torch.compiler.bucket_tables import compile_states_bucketed
from cilium_tpu_torch.compiler.lpm import (LPM_MISS, oracle_lpm_u32,
                                           parse_prefixes)
from cilium_tpu_torch.compiler.policy_tables import oracle_verdict
from cilium_tpu_torch.compiler.regexc import (compile_regex_set,
                                              oracle_match)
from cilium_tpu_torch.datapath import conntrack, engine, events
from cilium_tpu_torch.datapath.codes import VERDICT_DROP, WORLD_IDENTITY
from cilium_tpu_torch.datapath.pipeline import PACKED_FIELDS
from cilium_tpu_torch.device import cuda_ms, nvidia_smi, probe
from cilium_tpu_torch.l7.dns import DNSPolicyEngine
from cilium_tpu_torch.l7.http import (HTTPPolicyEngine, HTTPRequest,
                                      rule_to_combined_regex)
from cilium_tpu_torch.l7.http import request_line as http_request_line
from cilium_tpu_torch.l7.kafka import KafkaPolicyEngine
from cilium_tpu_torch.ops import dense_verdict as dv
from cilium_tpu_torch.ops.bucket_ops import BucketVerdictEngine
from cilium_tpu_torch.ops.dfa_engine import DFAEngine
from cilium_tpu_torch.policy.api import PortRuleHTTP
from cilium_tpu_torch.policy.mapstate import (PolicyKey, PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.profile_config1 import (V4_WARMUP, profile_run,
                                              profile_step)
from cilium_tpu_torch.workloads import (CONFIG2_FIELDS, FQDN_SELECTORS,
                                        HTTP_RULES, KAFKA_RULES, TRAFFICS,
                                        V4_T0, Config1Run, Config2Run,
                                        V4Run, V6Run, build_config2,
                                        config3_requests, config4_requests,
                                        config5_names, mixed_bucket_packets,
                                        mixed_bucket_states, unpack6,
                                        v4_serving_packets,
                                        v4_serving_state, v6_of,
                                        v6_serving_packets)

BATCH = 1 << 20
ORACLE_SAMPLE = 4096
# H100 SXM HBM3 rate (NVIDIA data sheet).  The operation rate is the
# card's own: its SM count and maximum SM clock, with the per-pipe lanes
# of cilium_tpu_torch/sass_mix.py, applied to the instructions the built
# kernel issues per (packet, entry) pair (read from its SASS).
HBM_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def device_breakdown(fn, calls: int) -> dict:
    """Device ms per call of each kernel (and memset) that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls after a
    warm-up; {} where the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:96]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


# the kernels of csrc/dense_verdict.cu that group the packets by endpoint
GROUPING = ("histogram_kernel", "scan_kernel", "scatter_kernel")


# Equality compares a (packet, entry) pair needs whatever the kernel:
# identity, exact meta word, L3 meta word.  The wildcard test (key_a ==
# 0) is one per entry, not per pair.
FUNCTION_COMPARES_PER_PAIR = 3


def dense_bound_ms(tables, pkt_ep, pair_s: float,
                   function_pair_s: float) -> dict:
    """Least time for the dense verdict's work on the card: the larger of
    its bytes (entries read once, packets read once, verdicts and the
    two counter arrays written once) over the memory rate and its pairs
    at ``pair_s`` seconds each (the kernel's per-pair instructions from
    its SASS over the card's rate for their pipe).  ``bound_ms`` counts
    the pairs this run's data needs: each packet against its own
    endpoint's entries.  ``function_bound_ms`` takes the same pairs at
    ``function_pair_s``, the function's own compares a pair on the ALU
    pipe, whatever any kernel spends beside them.  ``all_pairs_bound_ms``
    counts every (packet, entry) pair at ``pair_s``."""
    n, b = int(tables.ep.shape[0]), int(pkt_ep.shape[0])
    real = tables.ep[tables.ep >= 0].to(torch.int64)
    per_ep = torch.bincount(real)
    ep = pkt_ep[(pkt_ep >= 0) & (pkt_ep < per_ep.shape[0])]
    pairs = int(per_ep[ep.to(torch.int64)].sum())
    t_bytes = 4 * (4 * n + 6 * b + b + 2 * n) / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * pair_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs,
            "function_bound_ms": max(t_bytes,
                                     pairs * function_pair_s * 1e3),
            "all_pairs_bound_ms": max(t_bytes, b * n * pair_s * 1e3)}


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def _random_states(n_endpoints, n_rules, seed, wide, pool=16):
    """Random per-endpoint states over ``pool`` identities and ports;
    ``wide`` draws identities >= 2**31 and ports >= 32768 too.  Every
    state carries L3-only and wildcard keys and proxy-port values."""
    rng = np.random.default_rng(seed)
    idents = rng.integers(256, 4096, pool)
    ports = rng.integers(1, 2048, pool)
    if wide:
        idents = np.r_[idents, rng.integers(2 ** 31, 2 ** 32, 8)]
        ports = np.r_[ports, rng.integers(32768, 65536, 8)]
    states = []
    for _ in range(n_endpoints):
        st = PolicyMapState()
        for _ in range(n_rules):
            st[PolicyKey(identity=int(rng.choice(idents)),
                         dest_port=int(rng.choice(ports)), nexthdr=6,
                         direction=int(rng.integers(0, 2)))] = \
                PolicyMapStateEntry(proxy_port=int(rng.integers(0, 3) *
                                                   11000))
        st[PolicyKey(identity=int(rng.choice(idents)))] = \
            PolicyMapStateEntry()
        st[PolicyKey(identity=0, dest_port=80, nexthdr=6)] = \
            PolicyMapStateEntry(proxy_port=15001)
        states.append(st)
    return states, idents, ports


def _random_packets(n_endpoints, idents, ports, batch, seed):
    rng = np.random.default_rng(seed)
    ident_pool = np.r_[idents, rng.integers(0, 2 ** 32, 16)]
    cols = (rng.integers(0, n_endpoints, batch),
            ident_pool.astype(np.uint32).view(np.int32)[
                rng.integers(0, len(ident_pool), batch)],
            rng.choice(np.r_[ports, 80, 0], batch),
            rng.choice([6, 6, 6, 0, 17], batch),
            rng.integers(0, 2, batch),
            rng.integers(40, 65536, batch))
    return [np.asarray(c, np.int32) for c in cols]


def compare_dense(tables, pkts, segments) -> dict:
    """Kernel (``dense_verdict``) vs plain version on the same tensors;
    raises unless verdict and both counter deltas are bit-equal."""
    got = dv.dense_verdict(tables, *pkts, segments=segments)
    want = dv.dense_verdict_reference(tables, *pkts)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("verdict", "d_packets", "d_bytes"), got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"dense_verdict kernel != plain: {name}")
        err = max(err, int((g.to(torch.int64) - w).abs().max().item())
                  if g.numel() else 0)
    v = got[0]
    return {"max_abs_err": err, "b": int(pkts[0].shape[0]),
            "n": int(tables.ep.shape[0]),
            "drops": int((v == VERDICT_DROP).sum()),
            "allows": int((v == 0).sum()),
            "proxied": int((v > 0).sum())}


def _case(n_ep, n_rules, batch, seed, wide, pool=16):
    states, idents, ports = _random_states(n_ep, n_rules, 100 + seed, wide,
                                           pool)
    return states, _random_packets(n_ep, idents, ports, batch, 200 + seed)


def _parity_cases():
    """(name, map states, packet columns on the host) of each parity
    case.  The first four hold the kernel's tails and key ranges; the
    rest the edges of its grouping: one endpoint for every packet, an
    endpoint with no entries, endpoints out of range, every packet on
    one entry, a segment over two tiles with a ragged tail, a batch that
    is no multiple of a verdict block (512 packets) or of a grouping
    block (4,096), and more endpoints than a grouping block counts in
    shared memory."""
    yield ("ragged-b1000", *_case(4, 24, 1000, 0, False))
    yield ("ragged-b4097-wide", *_case(8, 60, 4097, 1, True))
    yield ("many-tiles-n-not-tile-multiple",
           *_case(16, 700, 1 << 14, 2, True))
    yield ("one-packet", *_case(3, 10, 1, 3, True))

    states, pk = _case(4, 60, 1 << 20, 4, True)
    pk[0][:] = 2
    yield "one-endpoint-all-2^20-packets", states, pk

    states, pk = _case(5, 40, 1 << 16, 5, True)
    states[1] = PolicyMapState()  # receives packets, holds no entry
    states[4] = PolicyMapState()  # beyond the last real row: E = 4
    yield "endpoint-without-entries", states, pk

    states, pk = _case(6, 40, 1 << 16, 6, True)
    rng = np.random.default_rng(6)
    odd = rng.random(pk[0].shape[0]) < 0.3
    pk[0][odd] = rng.choice(np.array([-1, -5, 6, 7, 1 << 20, -(1 << 31)],
                                     np.int32), int(odd.sum()))
    yield "endpoints-out-of-range", states, pk

    st = PolicyMapState()
    st[PolicyKey(identity=0, dest_port=80, nexthdr=6)] = \
        PolicyMapStateEntry(proxy_port=15001)
    _, pk = _case(1, 1, 1 << 20, 7, True)
    pk[0][:], pk[2][:], pk[3][:], pk[4][:] = 0, 80, 6, 0
    yield "every-packet-on-one-entry", [st], pk

    states, pk = _case(2, 3000, 1 << 14, 8, True, pool=64)
    yield "segment-over-two-tiles-ragged", states, pk

    yield ("b-not-block-multiple", *_case(6, 80, 5 * 1024 + 77, 9, True))

    # more endpoints than a grouping block keeps bins for in shared
    # memory (4,096): the bins are bumped in global memory instead
    yield ("endpoints-over-shared-bins", *_case(4100, 2, 1 << 16, 10, True))


def phase_refusals(dev) -> None:
    """On the card: a table whose endpoints are not contiguous is
    refused by ``dense_segments``; segments of other tables with the same
    N and E, or of tables changed in place since, by ``dense_verdict``."""
    col = torch.tensor([0, 0, 1, 0] + [-1] * 124, dtype=torch.int32,
                       device=dev)
    split = dv.DenseTables(col, col.clone(), col.clone(), col.clone())
    refused = []
    try:
        dv.dense_segments(split)
    except ValueError as exc:
        refused.append(str(exc))
    states, pk = _case(4, 24, 1000, 0, False)
    tables = dv.compile_dense(states, device=dev)
    twin = dv.compile_dense(states, device=dev)
    pkts = tuple(torch.as_tensor(c, device=dev) for c in pk)
    for name, segments in (("other-tables", dv.dense_segments(twin)),
                           ("changed-in-place",
                            dv.dense_segments(tables))):
        if name == "changed-in-place":
            tables.value.add_(1)
        try:
            dv.dense_verdict(tables, *pkts, segments=segments)
        except ValueError as exc:
            refused.append(str(exc))
    if len(refused) != 3:
        raise AssertionError(f"refused {len(refused)} of 3: {refused}")
    emit("refusals", kernel="dense_verdict", refused=refused)


def phase_parity(dev) -> float:
    worst = 0
    for name, states, pk in _parity_cases():
        tables = dv.compile_dense(states, device=dev)
        segments = dv.dense_segments(tables)
        pkts = tuple(torch.as_tensor(c, device=dev) for c in pk)
        res = compare_dense(tables, pkts, segments)
        seg = np.diff(segments.offsets.cpu().numpy())
        # kTile = 1024 entries in csrc/dense_verdict.cu
        if name.startswith("many-tiles") and res["n"] % 1024 == 0:
            raise AssertionError("entry count must not be a tile multiple")
        if name.startswith("segment-over") and \
                not (seg.max() > 2048 and seg.max() % 1024):
            raise AssertionError(f"{name}: segments {seg.tolist()}")
        if name.startswith("every-packet") and \
                res["allows"] + res["proxied"] != res["b"]:
            raise AssertionError(f"{name}: not every packet decided")
        if name.startswith("endpoints-over") and \
                segments.n_endpoints <= 4096:
            raise AssertionError(f"{name}: {segments.n_endpoints} endpoints")
        if name.startswith("endpoint-without") and \
                (segments.n_endpoints != 4 or seg[1] != 0):
            raise AssertionError(f"{name}: segments {seg.tolist()}")
        if res["b"] > 1 and not name.startswith("every-packet") and \
                (res["allows"] == 0 or res["proxied"] == 0):
            raise AssertionError(f"{name}: no allow or proxy verdicts")
        worst = max(worst, res["max_abs_err"])
        emit("parity", kernel="dense_verdict", case=name,
             endpoints=segments.n_endpoints, longest_segment=int(seg.max())
             if seg.size else 0, **res)
    return worst


# ---------------------------------------------------------------------------
# phase 4: the config-1 path
# ---------------------------------------------------------------------------

def run_traffic(run, label, traffic, oracle_sample, iters, pair_s,
                function_pair_s) -> dict:
    """Drive ``run`` (a ``Config1Run``) on the packet stream ``traffic``:
    one step through each engine with the kernel's launches counted from
    0, the checks, the whole-batch kernel = plain check, then the timed
    calls.  ``iters``: {"hash": n, "dense": n, "kernel": n, "plain": n}
    timed calls (plain 0: not timed); ``pair_s`` and ``function_pair_s``:
    least seconds per (packet, entry) pair, from the kernel's SASS and
    from the function's own compares."""
    run.set_traffic(traffic)
    batch = run.batch
    torch.cuda.reset_peak_memory_stats()
    dv.dense_verdict.launches = 0
    hv, hident, h_counters = run.hash_step()
    dvv, dident, d_pk, d_by = run.dense_step()
    torch.cuda.synchronize()
    launches = dv.dense_verdict.launches
    if launches < 1:
        raise AssertionError("dense_verdict kernel was not launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    where = f"{label} ({traffic})"
    if not torch.equal(hv, dvv):
        raise AssertionError(f"{where}: hash verdicts != dense verdicts")
    if not torch.equal(hident, dident):
        raise AssertionError(f"{where}: hash identities != dense")
    pk = run.pkt
    passed = hv != VERDICT_DROP
    non_drop = int(passed.sum())
    counted = {"hash": int(h_counters.packets.sum(dtype=torch.int64)),
               "dense": int(d_pk.sum(dtype=torch.int64))}
    if counted["hash"] != non_drop or counted["dense"] != non_drop:
        raise AssertionError(f"{where}: counted {counted} != non-drop "
                             f"{non_drop}")
    want_bytes = int(pk["length"][passed].sum(dtype=torch.int64))
    if int(d_by.sum(dtype=torch.int64)) != want_bytes:
        raise AssertionError(f"{where}: dense byte counters off")

    # scalar oracle on a sample, spread over the batch
    idx = np.linspace(0, batch - 1, min(oracle_sample, batch)).astype(int)
    parsed = parse_prefixes(run.prefixes)
    v_host, id_host = hv.cpu().numpy(), hident.cpu().numpy()
    host = run.host
    src = host["src_addr"].view(np.uint32)
    for i in idx:
        want_id = oracle_lpm_u32(parsed, int(src[i]))
        want_id = WORLD_IDENTITY if want_id == LPM_MISS else want_id
        want_v = oracle_verdict(run.states[host["endpoint"][i]], want_id,
                                int(host["dport"][i]), 6, 1)
        if id_host[i] != want_id or v_host[i] != want_v:
            raise AssertionError(f"{where}: packet {i} oracle mismatch")

    # the kernel against its plain version on the whole batch: verdicts
    # and every entry's packet and byte deltas
    args = (pk["endpoint"], dident, pk["dport"], pk["proto"],
            pk["direction"], pk["length"])
    parity = compare_dense(run.dense, args, run.segments)

    # timing: each engine's whole step, then the kernel alone
    engines = {}
    for name, fn in (("hash", run.hash_step), ("dense", run.dense_step)):
        ms = cuda_ms(fn, iters[name])
        engines[name] = {
            "verdicts_per_s": batch * len(ms) / (sum(ms) / 1e3),
            "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)), "samples": len(ms)}

    def kernel_once():
        dv.dense_verdict(run.dense, *args, segments=run.segments)

    k_ms = cuda_ms(kernel_once, iters["kernel"])
    parts = device_breakdown(kernel_once, 3)
    grouping = sum(ms for name, ms in parts.items()
                   if any(g in name for g in GROUPING))
    result = {"label": label, "traffic": traffic, "batch": batch,
              "entries": int(run.dense.ep.shape[0]),
              "launches": launches, "non_drop": non_drop,
              "oracle_sample": len(idx), "peak_gb": peak_gb,
              "engines": engines, "kernel_ms": float(np.median(k_ms)),
              "kernel_samples": len(k_ms), "parity": parity,
              "device_breakdown": parts,
              "grouping_share": grouping / sum(parts.values())
              if parts else None,
              **dense_bound_ms(run.dense, pk["endpoint"], pair_s,
                               function_pair_s)}
    if iters["plain"]:
        result["plain_ms"] = float(np.median(cuda_ms(
            lambda: dv.dense_verdict_reference(run.dense, *args),
            iters["plain"])))
    emit("config1", **result)
    return result


def run_state(label, n_rules, dev, batch, oracle_sample, iters, pair_s,
              function_pair_s) -> dict:
    """One policy state through both traffics; ``iters`` maps each
    traffic to ``run_traffic``'s timed calls.  The uniform stream, the
    bench's, runs first: it is the main path."""
    t0 = time.perf_counter()
    run = Config1Run(n_rules, batch, dev)
    torch.cuda.synchronize()
    emit("state", label=label, rules=n_rules,
         entries=int(run.dense.ep.shape[0]),
         endpoints=run.segments.n_endpoints,
         lpm_prefixes=len(run.prefixes), policy_slots=run.compiled.slots,
         policy_probe=run.compiled.max_probe, lpm_slots=run.lpm.slots,
         lpm_probe=run.lpm.max_probe,
         setup_s=time.perf_counter() - t0)
    return {traffic: run_traffic(run, label, traffic, oracle_sample,
                                 iters[traffic], pair_s, function_pair_s)
            for traffic in TRAFFICS}


# ---------------------------------------------------------------------------
# phases 5 and 6: the v4 and v6 stateful steps
# ---------------------------------------------------------------------------

V4_STATE = {}           # v4_serving_state() arguments: full width
V4_BATCH = 1 << 20
V4_SMALL = 1 << 16
V4_FLOWS = 1 << 16
V4_CT_SLOTS = 1 << 20
V4_CT_PROBE = 8
V4_TIMED = {"process_packed": 40, "process": 20, "flows": 30}
V6_TIMED = {"off": 30, "flows": 30}
# the daemon's flow table (DaemonConfig hubble_flow_slots / probe) and
# the engine's claim stripe
FLOW_SLOTS = 1 << 12
FLOW_PROBE = 8
FLOW_CLAIM_EVERY = 4
# batches served with flows on before their timing, to fill the table
FLOW_WARMUP = 8
# about half a second of torch.cuda._sleep at the H100's 1.98 GHz
SLEEP_CYCLES = 1_000_000_000


def enable_flows(dp) -> None:
    dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=FLOW_PROBE,
                               claim_every=FLOW_CLAIM_EVERY)


def mismatches(outs_g, outs_c, gpu, cpu, family6: bool) -> dict:
    """Elements that differ between the card's and the CPU's step, per
    output: verdict, event, identity, every NAT field, both counters,
    every field of the family's CT (sentinel included, the discard slot
    left out), every lane of the flow table when it is on, and the
    provenance slot and tier."""
    pairs = [(name, g, c) for name, g, c in
             zip(("verdict", "event", "identity"), outs_g[:3], outs_c[:3])]
    pairs += [(f"nat.{f}", getattr(outs_g[3], f), getattr(outs_c[3], f))
              for f in outs_g[3]._fields]
    pairs += [(f"counters.{f}", getattr(gpu.counters, f),
               getattr(cpu.counters, f)) for f in ("packets", "bytes")]
    ct_g, ct_c = (gpu.ct6, cpu.ct6) if family6 else (gpu.ct, cpu.ct)
    n = ct_g.slots + 1
    ct_name = "ct6" if family6 else "ct"
    pairs += [(f"{ct_name}.{f}", ct_g.state[i, :n], ct_c.state[i, :n])
              for i, f in enumerate(conntrack.FIELDS)]
    if gpu.flows is not None:
        for lane, f in enumerate(("src", "dst", "meta", "last_seen")):
            pairs.append((f"flows.{f}", gpu.flows.state.keys[:, lane],
                          cpu.flows.state.keys[:, lane]))
        for lane, f in enumerate(("packets", "bytes")):
            pairs.append((f"flows.{f}", gpu.flows.state.counters[:, lane],
                          cpu.flows.state.counters[:, lane]))
    if gpu.provenance_enabled:
        pairs += [(f"provenance.{f}", getattr(gpu.last_provenance, f),
                   getattr(cpu.last_provenance, f))
                  for f in ("match_slot", "tier")]
    return {name: int((g.cpu() != c).sum()) for name, g, c in pairs}


def serve_parity(label, dev, load, step, streams, family6: bool,
                 flows: bool) -> dict:
    """The port on the card and on the CPU, from one seed and one state
    (``load(dp)``), provenance on, the flow table on with ``flows``: 2
    batches at B = 2**20 from ``streams[0]``, then 8 at B = 2**16 from
    ``streams[1]`` after a 60 s pause (so SYN-only and closed entries
    have expired), with a CT snapshot after the 5th batch, a GC after
    the 6th and, after the 8th, a restore of that snapshot into both.
    ``step(dp, batch, now)`` serves one batch.  Raises on any
    mismatch."""
    pair = []
    for where in (dev, torch.device("cpu")):
        dp = engine.Datapath(ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=where)
        load(dp)
        dp.enable_provenance()
        if flows:
            enable_flows(dp)
        pair.append(dp)
    gpu, cpu = pair
    total = {}
    snapshot = None
    fam = 1 if family6 else 0
    for k in range(10):
        b = V4_BATCH if k < 2 else V4_SMALL
        now = V4_T0 + k if k < 2 else V4_T0 + 60 + k
        host = torch.as_tensor(next(streams[0] if k < 2 else streams[1]))
        claiming = flows and gpu._flow_tick % FLOW_CLAIM_EVERY == 0
        outs_g = step(gpu, host.to(dev), now)
        outs_c = step(cpu, host, now)
        torch.cuda.synchronize()
        extra = {}
        if k == 4:
            snapshot = gpu.snapshot_ct()
        if k == 5:
            extra["gc_deleted"] = [gpu.gc(now), cpu.gc(now)]
        if k == 7:
            extra["restored"] = [gpu.restore_ct_snapshots(*snapshot),
                                 cpu.restore_ct_snapshots(*snapshot)]
        mism = mismatches(outs_g, outs_c, gpu, cpu, family6)
        for name, (g, c) in extra.items():
            mism[name] = int(g != c)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        if flows:
            extra["flows"] = gpu.flow_stats()
            extra["claiming"] = claiming
        emit(f"{label}-parity", batch_index=k, b=b, now=now,
             flows_on=flows, mismatches=sum(mism.values()),
             ct_entries=gpu.ct_entries()[fam], **extra,
             nonzero={n: v for n, v in mism.items() if v})
        if any(mism.values()):
            raise AssertionError(f"{label} step: card != CPU at batch {k}: "
                                 f"{ {n: v for n, v in mism.items() if v} }")
    return {"batches": 10, "flows_on": flows, "mismatches": total}


# CUDA runtime calls that make the host wait for the device, or copy
# between host and device: none may run inside a step
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
              "cudaMemcpy2D", "cudaMemcpy2DAsync")


def behind_sleep(run, batch) -> dict:
    """One ``run.step`` behind a ``torch.cuda._sleep`` that holds the
    stream for about half a second, traced by ``torch.profiler``: the
    host time of the call and the CUDA runtime calls made inside it.  A
    host read would show as a synchronise or copy call that lasts until
    the sleep ends; a step of more kernels than the launch queue holds
    blocks instead in a kernel launch, which reads nothing."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        with record_function("serving-step"):
            run.step(batch)
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    evs = prof.events()
    span = [e for e in evs if e.name == "serving-step"][0].time_range
    runtime = [e for e in evs if e.device_type == DeviceType.CPU
               and e.name.startswith("cuda")
               and span.start <= e.time_range.start <= span.end]
    counts: dict = {}
    for e in runtime:
        counts[e.name] = counts.get(e.name, 0) + 1
    longest = max(runtime, key=lambda e: e.time_range.elapsed_us(),
                  default=None)
    return {"host_ms": host_ms,
            "host_waits": {n: c for n, c in counts.items()
                           if n in HOST_WAITS},
            "launches": counts.get("cudaLaunchKernel", 0),
            "longest_call": None if longest is None else longest.name,
            "longest_call_ms": 0.0 if longest is None
            else longest.time_range.elapsed_us() / 1e3}


def sync_check(run, calls: int) -> dict:
    """No host read inside ``run.step``, shown two ways on batches
    already on the card, provenance on and off in turn; with the flow
    table on, ``calls`` >= the claim stripe puts a claiming and a
    claim-free call in each half:

    - under ``set_sync_debug_mode("error")`` every synchronising call
      PyTorch detects raises;
    - behind a ``torch.cuda._sleep`` (``behind_sleep``) the call must
      return on the host before the sleep ends, or, where the step has
      more kernels than the launch queue holds, the profiler must show
      that it made no synchronising or copying runtime call and that
      what held the host was a kernel launch."""
    batches = [torch.as_tensor(run.next_batch(), device=run.device)
               for _ in range(2 * calls)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    dp = run.dp
    claiming = []
    probes = []
    for i in range(2 * calls):
        (dp.enable_provenance if i % 2 == 0 else dp.disable_provenance)()
        if dp.flows is not None:
            claiming.append(dp._flow_tick % FLOW_CLAIM_EVERY == 0)
        if i < calls:
            torch.cuda.set_sync_debug_mode("error")
            try:
                run.step(batches[i])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            probe = behind_sleep(run, batches[i])
            probe["returned_before_sleep_ended"] = \
                probe["host_ms"] < sleep_ms
            probe["held_by_launch_queue"] = \
                not probe["host_waits"] and probe["launches"] > 0 and \
                probe["longest_call"] == "cudaLaunchKernel"
            probes.append(probe)
        torch.cuda.synchronize()
        run.advance()
    dp.enable_provenance()
    bad = [p for p in probes if p["host_waits"] or not (
        p["returned_before_sleep_ended"] or p["held_by_launch_queue"])]
    if bad:
        raise AssertionError(f"the step may read the card: {bad} behind a "
                             f"{sleep_ms} ms sleep")
    if dp.flows is not None and not (any(claiming[:calls]) and
                                     any(claiming[calls:])):
        raise AssertionError(f"no claiming call in a half: {claiming}")
    return {"calls": 2 * calls, "sync_debug_mode": "error",
            "raised": False, "flows_on": dp.flows is not None,
            "claiming": claiming, "sleep_ms": sleep_ms,
            "host_ms_behind_sleep": [p["host_ms"] for p in probes],
            "behind_sleep": probes}


class _ReadsBack:
    """``run`` whose step also reads a verdict back on the host: the
    control that ``behind_sleep`` must flag."""

    def __init__(self, run):
        self.run = run

    def step(self, batch):
        out = self.run.step(batch)
        return int(out[0][0])


def sleep_control(run) -> dict:
    """``behind_sleep`` on a step followed by a host read of one
    verdict: it must report the read (so its silence on the real steps
    means something on this machine)."""
    batch = torch.as_tensor(run.next_batch(), device=run.device)
    probe = behind_sleep(_ReadsBack(run), batch)
    run.advance()
    if not probe["host_waits"]:
        raise AssertionError(f"the sleep probe missed a host read: {probe}")
    return probe


def serve_timed(run, calls: int, entry: str) -> dict:
    """Per-batch device time of ``calls`` fresh batches, CUDA events
    around the host-to-device copy and the step (clock, GC and the
    next batch's generation outside): ``process_packed`` and
    ``process6`` copy their batch matrix once from a pinned staging
    buffer; ``process`` makes its batch with ``make_full_batch`` (ten
    copies).  Also the shares of verdicts and events over the timed
    batches."""
    stage = None
    ms, event_counts, verdict_counts = [], {}, {}
    for _ in range(calls):
        host = run.next_batch()
        if stage is None:
            stage = torch.empty(host.shape, dtype=torch.int32).pin_memory()
        stage.copy_(torch.from_numpy(host))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if entry == "process":
            cols = {f: host[i] for i, f in enumerate(PACKED_FIELDS)}
            out = run.dp.process(engine.make_full_batch(
                **cols, device=run.device), now=run.now)
        else:
            out = run.step(stage.to(run.device, non_blocking=True))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        verdict, event = out[0], out[1]
        for name, mask in (("drop", verdict < 0), ("allow", verdict == 0),
                           ("proxy", verdict > 0)):
            verdict_counts[name] = verdict_counts.get(name, 0) + \
                int(mask.sum())
        codes, counts = torch.unique(event, return_counts=True)
        for c, n in zip(codes.tolist(), counts.tolist()):
            key = events.event_name(c)
            event_counts[key] = event_counts.get(key, 0) + n
        run.advance()
    n_pk = sum(verdict_counts.values())
    return {"entry": entry, "flows_on": run.dp.flows is not None,
            "batch": run.batch, "samples": len(ms),
            "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)),
            "verdicts_per_s": run.batch / (float(np.median(ms)) / 1e3),
            "verdict_share": {k: v / n_pk
                              for k, v in verdict_counts.items()},
            "event_share": {k: v / n_pk for k, v in event_counts.items()},
            "name_power_limit": nvidia_smi("name,power.limit")}


def warm_up(run, batches: int) -> int:
    """Serve ``batches`` batches; returns the CT entries GC deleted."""
    deleted = 0
    for _ in range(batches):
        run.step(torch.as_tensor(run.next_batch(), device=run.device))
        deleted += run.advance()
    torch.cuda.synchronize()
    return deleted


def flows_leg(run, label: str) -> dict:
    """Turn the daemon's flow table on, serve ``FLOW_WARMUP`` batches,
    and report its occupancy and lost share."""
    enable_flows(run.dp)
    t0 = time.perf_counter()
    warm_up(run, FLOW_WARMUP)
    stats = run.dp.flow_stats()
    res = {"batches": FLOW_WARMUP, **stats,
           "occupancy": stats["occupied"] / stats["slots"],
           "lost_share": stats["lost"] / max(1, stats["updates"]),
           "seconds": time.perf_counter() - t0}
    emit(f"{label}-flows", **res)
    return res


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) NamedTuple of tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(tensor_bytes(x) for x in obj)
    return 0


def check_shares(label, shares, names) -> None:
    for name in names:
        if not shares.get(name):
            raise AssertionError(f"{label} step: no packet took {name!r}")


def phase_v4(dev):
    """The v4 phase; returns (the dense kernel's launches during it, the
    state).  The path runs no hand-written kernel."""
    t0 = time.perf_counter()
    state = v4_serving_state(**V4_STATE)
    emit("v4-state", endpoints=len(state.ep_identity),
         policy_entries=sum(len(s) for s in state.states),
         ipcache_prefixes=len(state.prefixes),
         services=len(state.services),
         backends=sum(len(s.backends) for s in state.services),
         backendless_last=len(state.services[-1].backends) == 0,
         prefilter_cidrs=len(state.prefilter),
         peer_nodes=len(state.tunnel), ct_slots=V4_CT_SLOTS,
         ct_probe=V4_CT_PROBE, setup_s=time.perf_counter() - t0)

    dv.dense_verdict.launches = 0
    for flows in (False, True):
        t0 = time.perf_counter()
        parity = serve_parity(
            "v4", dev, state.load,
            lambda dp, x, now: dp.process_packed(x, now=now),
            (v4_serving_packets(state, V4_BATCH, n_flows=V4_FLOWS, seed=5),
             v4_serving_packets(state, V4_SMALL, n_flows=V4_FLOWS // 16,
                                seed=6)), family6=False, flows=flows)
        emit("v4-parity-total", seconds=time.perf_counter() - t0, **parity)

    run = V4Run(V4_BATCH, dev, ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                state=state, n_flows=V4_FLOWS)
    t0 = time.perf_counter()
    deleted = warm_up(run, V4_WARMUP)
    emit("v4-warmup", batches=V4_WARMUP, gc_deleted=deleted,
         ct_entries=run.dp.ct_entries()[0],
         ct_occupancy=run.dp.ct_entries()[0] / V4_CT_SLOTS,
         seconds=time.perf_counter() - t0)
    emit("v4-sync", **sync_check(run, 2))
    emit("v4-sync-control", **sleep_control(run))
    timed = [serve_timed(run, V4_TIMED["process_packed"], "process_packed"),
             serve_timed(run, V4_TIMED["process"], "process")]
    for res in timed:
        emit("v4-timing", **res)
    occupancy = run.dp.ct_entries()[0] / V4_CT_SLOTS
    prof = profile_run(run, 5)
    emit("v4-profile", batch=V4_BATCH, flows_on=False, **prof)

    flows = flows_leg(run, "v4")
    emit("v4-sync", **sync_check(run, FLOW_CLAIM_EVERY))
    timed_f = serve_timed(run, V4_TIMED["flows"], "process_packed")
    emit("v4-timing", **timed_f)
    prof_f = profile_run(run, 4)
    emit("v4-profile", batch=V4_BATCH, flows_on=True, **prof_f,
         flows_busy_ms=prof_f["busy_ms"] - prof["busy_ms"])
    launches = dv.dense_verdict.launches
    check_shares("v4", timed[0]["event_share"],
                 ("to-endpoint", "to-overlay", "Policy denied (L3/L4)",
                  "Prefilter denied"))
    emit("v4", ct_occupancy=occupancy,
         hand_kernel_launches={"dense_verdict": launches},
         median_batch_ms=timed[0]["median_batch_ms"],
         p99_batch_ms=timed[0]["p99_batch_ms"],
         verdicts_per_s=timed[0]["verdicts_per_s"],
         flows_median_batch_ms=timed_f["median_batch_ms"],
         flows_verdicts_per_s=timed_f["verdicts_per_s"],
         flow_occupancy=flows["occupancy"],
         flow_lost_share=flows["lost_share"])
    return launches, state


def phase_v6(dev, state4) -> int:
    """The v6 phase: ``Datapath.process6`` over the v6 twin of the v4
    state; returns the dense kernel's launches during it."""
    t0 = time.perf_counter()
    state = v6_of(state4)
    embed_s = time.perf_counter() - t0

    dv.dense_verdict.launches = 0
    t0 = time.perf_counter()
    parity = serve_parity(
        "v6", dev, state.load,
        lambda dp, x, now: dp.process6(unpack6(x), now=now),
        (v6_serving_packets(state, V4_BATCH, n_flows=V4_FLOWS, seed=5),
         v6_serving_packets(state, V4_SMALL, n_flows=V4_FLOWS // 16,
                            seed=6)), family6=True, flows=True)
    emit("v6-parity-total", seconds=time.perf_counter() - t0, **parity)

    t0 = time.perf_counter()
    run = V6Run(V4_BATCH, dev, ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                state=state, n_flows=V4_FLOWS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dp = run.dp
    t6 = dp._tables6
    emit("v6-state", endpoints=len(state4.ep_identity),
         policy_entries=sum(len(s) for s in state4.states),
         ipcache6_prefixes=len(state.prefixes6),
         ipcache6_lengths=int(t6.ipcache6.kb.shape[0]),
         ipcache6_slots=int(t6.ipcache6.kb.shape[1]),
         ipcache6_probe=dp._statics6["lpm6_probe"],
         services6=len(state.services6),
         backends6=sum(len(s.backends) for s in state.services6),
         backendless_last=len(state.services6[-1].backends) == 0,
         lb6_slots=int(t6.lb6.svc_kb.shape[0]),
         lb6_probe=dp._statics6["lb6_probe"],
         prefilter6_cidrs=len(state.prefilter6),
         prefilter6_lengths=int(t6.pf6.kb.shape[0]),
         router6=state.router6, ct6_slots=V4_CT_SLOTS,
         ct6_probe=V4_CT_PROBE,
         table_bytes={"v6_tables": tensor_bytes(t6),
                      "ct6": tensor_bytes(dp.ct6.state),
                      "counters": tensor_bytes(dp._counters)},
         embed_s=embed_s, load_s=load_s)

    t0 = time.perf_counter()
    deleted = warm_up(run, V4_WARMUP)
    emit("v6-warmup", batches=V4_WARMUP, gc_deleted=deleted,
         ct6_entries=dp.ct_entries()[1],
         ct6_occupancy=dp.ct_entries()[1] / V4_CT_SLOTS,
         seconds=time.perf_counter() - t0)
    emit("v6-sync", **sync_check(run, 2))
    timed = serve_timed(run, V6_TIMED["off"], "process6")
    emit("v6-timing", **timed)
    prof = profile_run(run, 5)
    emit("v6-profile", batch=V4_BATCH, flows_on=False, **prof)

    flows = flows_leg(run, "v6")
    emit("v6-sync", **sync_check(run, FLOW_CLAIM_EVERY))
    timed_f = serve_timed(run, V6_TIMED["flows"], "process6")
    emit("v6-timing", **timed_f)
    prof_f = profile_run(run, 4)
    emit("v6-profile", batch=V4_BATCH, flows_on=True, **prof_f,
         flows_busy_ms=prof_f["busy_ms"] - prof["busy_ms"])
    launches = dv.dense_verdict.launches
    check_shares("v6", timed["event_share"],
                 ("to-endpoint", "Policy denied (L3/L4)",
                  "Prefilter denied", "icmp6-ns-reply", "icmp6-echo-reply",
                  "Unknown ICMPv6 ND target"))
    emit("v6", ct6_occupancy=dp.ct_entries()[1] / V4_CT_SLOTS,
         hand_kernel_launches={"dense_verdict": launches},
         median_batch_ms=timed["median_batch_ms"],
         p99_batch_ms=timed["p99_batch_ms"],
         verdicts_per_s=timed["verdicts_per_s"],
         flows_median_batch_ms=timed_f["median_batch_ms"],
         flows_p99_batch_ms=timed_f["p99_batch_ms"],
         flows_verdicts_per_s=timed_f["verdicts_per_s"],
         flow_occupancy=flows["occupancy"],
         flow_lost_share=flows["lost_share"])
    return launches


# ---------------------------------------------------------------------------
# phase 7: BASELINE config 2 on the bucket engine
# ---------------------------------------------------------------------------

CONFIG2_STATE = {}      # build_config2() arguments: the full BASELINE width
CONFIG2_BATCH = 1 << 20
CONFIG2_PARITY_BATCHES = 3
CONFIG2_TIMED = 60
MIXED_STATE = (256, 200)  # endpoints x entries of the mixed-kind case
MIXED_BATCH = 1 << 16


class _Call:
    """A no-argument call as a ``run`` for ``behind_sleep``."""

    def __init__(self, fn):
        self.fn = fn

    def step(self, _batch):
        return self.fn()


def no_host_read(fn) -> dict:
    """``fn`` (a step on inputs already on the card) makes no host read:
    it raises nothing under ``set_sync_debug_mode("error")``, and behind
    a ``torch.cuda._sleep`` it returns on the host before the sleep ends
    with no synchronising or copying CUDA runtime call (these steps
    launch far fewer kernels than the launch queue holds)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    probe = behind_sleep(_Call(fn), None)
    probe["sleep_ms"] = sleep_ms
    probe["returned_before_sleep_ended"] = probe["host_ms"] < sleep_ms
    if probe["host_waits"] or not probe["returned_before_sleep_ended"]:
        raise AssertionError(f"the step may read the card: {probe}")
    return {"sync_debug_mode": "error", "raised": False, **probe}


def timing(ms, rows: int) -> dict:
    return {"samples": len(ms), "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)),
            "rows_per_s": rows / (float(np.median(ms)) / 1e3),
            "name_power_limit": nvidia_smi("name,power.limit")}


def bucket_mismatches(got, want, eng_g, eng_c) -> dict:
    """Differing verdicts of one step, and differing entries of both
    counter arrays, between the card's engine and the CPU's."""
    return {"verdict": int((got.cpu() != want).sum()),
            "packets": int((eng_g.counters.packets.cpu() !=
                            eng_c.counters.packets).sum()),
            "bytes": int((eng_g.counters.bytes.cpu() !=
                          eng_c.counters.bytes).sum())}


def bucket_bytes_bound_ms(run) -> float:
    """Least time for the bucket step's bytes: per packet its 7 input
    words read and its verdict written, 3 stages x 2 bucket rows x 3
    table words x W slots read, and two counter words read and
    written."""
    w = run.engine.width
    per_packet = 4 * (7 + 1 + 3 * 2 * 3 * w + 2 * 2)
    return run.batch * per_packet / HBM_BYTES_PER_S * 1e3


def phase_config2(dev) -> int:
    """BASELINE config 2 (10,000 endpoints x 1,000 exact INGRESS rules,
    10M entries) on the two-choice bucket engine at B = 2**20; returns
    the dense kernel's launches during it (the path runs none)."""
    dv.dense_verdict.launches = 0
    t0 = time.perf_counter()
    state = build_config2(**CONFIG2_STATE)
    gen_s = time.perf_counter() - t0 - state.build_s
    torch.cuda.reset_peak_memory_stats()
    run = Config2Run(CONFIG2_BATCH, dev, state=state)
    cpu = BucketVerdictEngine(state.tables, device="cpu")
    torch.cuda.synchronize()
    tables = state.tables
    emit("config2-state", endpoints=tables.num_endpoints,
         rules_per_ep=int(state.ident.shape[1]),
         entries=tables.entry_count(), buckets_per_ep=tables.buckets_per_ep,
         width=tables.width, slots=int(tables.key_a.size),
         table_mb=tables.nbytes() / 1e6,
         counters_mb=(run.engine.nbytes() - tables.nbytes()) / 1e6,
         build_s=state.build_s, generate_s=gen_s)

    # the card against the same engine on the CPU, 3 batches
    total = {}
    first = run.packets(seed=4)
    for k in range(CONFIG2_PARITY_BATCHES):
        host = first if k == 0 else run.packets(seed=4 + k)
        got = run.step(run.to_device(host))
        want = cpu(*[torch.as_tensor(host[f]) for f in CONFIG2_FIELDS])
        torch.cuda.synchronize()
        mism = bucket_mismatches(got, want, run.engine, cpu)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        emit("config2-parity", batch_index=k, b=CONFIG2_BATCH,
             mismatches=mism, allowed=int((want == 0).sum()),
             dropped=int((want == VERDICT_DROP).sum()))
        if any(mism.values()):
            raise AssertionError(f"config2: card != CPU at batch {k}: {mism}")
    counted = int(run.engine.counters.packets.sum(dtype=torch.int64))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the flat-array oracle on a sample of the first batch
    verdict = run.step(run.to_device(first)).cpu().numpy()
    idx = np.linspace(0, CONFIG2_BATCH - 1, ORACLE_SAMPLE).astype(int)
    bad = [int(i) for i in idx if verdict[i] != state.oracle_verdict(
        *(int(first[f][i]) for f in ("endpoint", "identity", "dport",
                                     "proto", "direction", "is_fragment")))]
    if bad:
        raise AssertionError(f"config2: {len(bad)} oracle mismatches, "
                             f"first at packet {bad[0]}")

    mixed = phase_config2_mixed(dev)

    pkts = run.to_device(run.packets(seed=9))
    sync = no_host_read(lambda: run.step(pkts))
    ms = cuda_ms(lambda: run.step(pkts), CONFIG2_TIMED)
    prof = profile_step(lambda: run.step(pkts), 5)
    res = {"batch": CONFIG2_BATCH, **timing(ms, CONFIG2_BATCH),
           "peak_gb": peak_gb, "counted_packets": counted,
           "oracle_sample": len(idx), "oracle_mismatches": 0,
           "parity_mismatches": total,
           "bytes_bound_ms": bucket_bytes_bound_ms(run)}
    emit("config2-sync", **sync)
    emit("config2-profile", batch=CONFIG2_BATCH, **prof)
    launches = dv.dense_verdict.launches
    emit("config2", **res, mixed=mixed,
         hand_kernel_launches={"dense_verdict": launches})
    return launches


def phase_config2_mixed(dev) -> dict:
    """Exact, L3-only and L4-wildcard entries with proxy ports, both
    directions, 10% fragments and byte counters that wrap: the stages
    the config-2 traffic never reaches.  Card against CPU over 3
    batches, and the map-state oracle on a sample."""
    states = mixed_bucket_states(*MIXED_STATE, seed=11)
    tables = compile_states_bucketed(states, revision=1)
    gpu = BucketVerdictEngine(tables, device=dev)
    cpu = BucketVerdictEngine(tables, device="cpu")
    total, verdicts = {}, {}
    for k in range(3):
        host = mixed_bucket_packets(states, MIXED_BATCH, seed=30 + k)
        got = gpu(*[torch.as_tensor(host[f], device=dev)
                    for f in CONFIG2_FIELDS])
        want = cpu(*[torch.as_tensor(host[f]) for f in CONFIG2_FIELDS])
        torch.cuda.synchronize()
        mism = bucket_mismatches(got, want, gpu, cpu)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        if any(mism.values()):
            raise AssertionError(f"config2 mixed: card != CPU at {k}: {mism}")
        codes, counts = torch.unique(want, return_counts=True)
        for c, n in zip(codes.tolist(), counts.tolist()):
            verdicts[str(c)] = verdicts.get(str(c), 0) + n
        for i in range(0, MIXED_BATCH, MIXED_BATCH // 512):
            if host["is_fragment"][i]:
                continue
            want_i = oracle_verdict(
                states[host["endpoint"][i]], int(host["identity"][i]),
                int(host["dport"][i]), int(host["proto"][i]),
                int(host["direction"][i]))
            if int(want[i]) != want_i:
                raise AssertionError(f"config2 mixed: oracle at {k}/{i}")
    for code in ("-2", "-1", "0", "15001"):
        if not verdicts.get(code):
            raise AssertionError(f"config2 mixed: no verdict {code}")
    return {"endpoints": MIXED_STATE[0], "entries": tables.entry_count(),
            "batches": 3, "b": MIXED_BATCH, "mismatches": total,
            "verdicts": verdicts}


# ---------------------------------------------------------------------------
# phase 8: BASELINE configs 3-5, the L7 engines
# ---------------------------------------------------------------------------

L7_BATCHES = (32768, 1 << 20)   # the bench's batch, and 2**20 rows
L7_TIMED = 50
L7_SMALL = 4096                 # the header, long-payload and sweep cases
HEADER_RULES = (PortRuleHTTP(method="GET", path="/api/.*",
                             headers=("X-Token abc.1",)),
                PortRuleHTTP(method="POST", path="/upload",
                             headers=("Content-Type", "x-req-id 7")),
                PortRuleHTTP(method="DELETE"))


def _l7_rows(name, gpu, cpu, sample_oracle, encode, match, batch) -> dict:
    """One L7 engine on the card against its twin on the CPU (built with
    the card's selection) over every row, the Python ``re`` oracle on a
    sample, the host encode time, then ``match`` on pre-encoded blocks
    already on the card: no host read, CUDA-event timing, profile."""
    if gpu.engine_report() != cpu.engine_report():
        raise AssertionError(f"{name}: CPU twin selects otherwise")
    t0 = time.perf_counter()
    enc = encode(gpu)
    encode_s = time.perf_counter() - t0
    got = match(gpu, enc).cpu()
    want = match(cpu, enc)
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"{name} at {batch}: {mism} card != CPU rows")
    oracle_bad = sample_oracle(got.numpy())
    if oracle_bad:
        raise AssertionError(f"{name} at {batch}: {oracle_bad} oracle "
                             "mismatches")
    on_card = tuple(None if e is None else e.to(gpu.device) for e in enc)
    sync = no_host_read(lambda: match(gpu, on_card))
    ms = cuda_ms(lambda: match(gpu, on_card), L7_TIMED)
    prof = profile_step(lambda: match(gpu, on_card), 5)
    res = {"engine": name, "batch": batch, "rows": int(got.shape[0]),
           "allowed": int(got.reshape(got.shape[0], -1).any(1).sum()),
           "mismatches": mism, "oracle_mismatches": 0,
           "encode_packed_s": encode_s,
           "encode_rows_per_s": batch / encode_s,
           **timing(ms, batch), "describe": gpu.engine_report()}
    emit("l7-sync", engine=name, batch=batch, **sync)
    emit("l7-profile", engine=name, batch=batch, **prof)
    emit("l7", **res)
    return res


def _http_oracle(reqs, patterns):
    def check(got) -> int:
        idx = np.linspace(0, len(reqs) - 1, ORACLE_SAMPLE).astype(int)
        return sum(bool(got[i]) != any(
            oracle_match(p, http_request_line(reqs[i]).encode())
            for p in patterns) for i in idx)
    return check


def _dns_oracle(names, selectors):
    def check(got) -> int:
        idx = np.linspace(0, len(names) - 1, ORACLE_SAMPLE).astype(int)
        return sum(bool(got[i].any()) != any(
            oracle_match(s.to_regex(), names[i].lower().rstrip(".")
                         .encode()) for s in selectors) for i in idx)
    return check


def _http_case(name, rules, reqs, batch_hint, dev) -> dict:
    """An HTTP rule set on the card against the CPU twin, whole batch."""
    gpu = HTTPPolicyEngine(rules, batch_hint=batch_hint, device=dev)
    cpu = HTTPPolicyEngine(rules, batch_hint=batch_hint, device="cpu",
                           on_accel=gpu.device.type == "cuda")
    if gpu.engine_report() != cpu.engine_report():
        raise AssertionError(f"{name}: CPU twin selects otherwise")
    got, want = gpu.check(reqs), cpu.check(reqs)
    mism = int((got != want).sum())
    if mism or not 0 < want.sum() < len(reqs):
        raise AssertionError(f"{name}: {mism} mismatches, "
                             f"{int(want.sum())} allowed")
    return {"case": name, "rows": len(reqs), "mismatches": mism,
            "allowed": int(want.sum()), "describe": gpu.engine_report()}


def _strategy_sweep(dev) -> list:
    """Every strategy x dtype of ``DFAEngine`` over the config-3 table on
    the card, against the same engine on the CPU."""
    compiled = compile_regex_set([rule_to_combined_regex(r)
                                  for r in HTTP_RULES])
    data = HTTPPolicyEngine(list(HTTP_RULES), device="cpu").encode(
        config3_requests(L7_SMALL))[0]
    out = []
    for prefer in ("stride", "compose", "assoc"):
        for dtype in (np.int8, np.int16, np.int32):
            kw = dict(max_len=512, prefer=prefer, dtype=dtype,
                      stride_budget=200_000)
            gpu = DFAEngine(compiled, device=dev, **kw)
            cpu = DFAEngine(compiled, device="cpu", **kw)
            want = cpu.match(data)
            mism = int((gpu.match(data).cpu() != want).sum()) + int(
                (gpu.match_encoded(gpu.encode(data).to(dev)).cpu() !=
                 want).sum())
            if mism:
                raise AssertionError(f"DFAEngine {prefer}/{dtype}: {mism}")
            out.append({"tag": gpu.describe()["tag"], "mismatches": mism})
    return out


def phase_l7(dev) -> int:
    """BASELINE configs 3-5 (``bench_suite.py``'s http-regex, kafka-acl
    and fqdn shapes); returns the dense kernel's launches during it."""
    dv.dense_verdict.launches = 0
    card = dev.type == "cuda"   # each CPU twin takes the card's selection
    results = []
    for batch in L7_BATCHES:
        reqs = config3_requests(batch)
        gpu = HTTPPolicyEngine(list(HTTP_RULES), batch_hint=batch,
                               device=dev)
        cpu = HTTPPolicyEngine(list(HTTP_RULES), batch_hint=batch,
                               device="cpu", on_accel=card)
        patterns = [rule_to_combined_regex(r) for r in HTTP_RULES]
        results.append(_l7_rows(
            "http", gpu, cpu, _http_oracle(reqs, patterns),
            lambda e: e.encode_packed(reqs),
            lambda e, enc: e.match_device(*enc)[:batch], batch))

        names = config5_names(batch)
        gpu = DNSPolicyEngine(list(FQDN_SELECTORS), batch_hint=batch,
                              device=dev)
        cpu = DNSPolicyEngine(list(FQDN_SELECTORS), batch_hint=batch,
                              device="cpu", on_accel=card)
        results.append(_l7_rows(
            "fqdn", gpu, cpu, _dns_oracle(names, FQDN_SELECTORS),
            lambda e: (e.encode_packed(names),),
            lambda e, enc: e.match_device(enc[0])[:batch], batch))

    # the card's own choice where it differs from the bench's: header
    # rules and long payloads select assoc at the default batch hint
    rng = np.random.default_rng(12)
    hdrs = [None, {"X-Token": "abc.1"}, {"Content-Type": "json",
                                         "X-Req-Id": "7"},
            {"x-token": "abc.2"}, {"content-type": "json"}]
    header_reqs = [HTTPRequest(
        method=("GET", "POST", "DELETE", "PUT")[i % 4],
        path=("/api/v1", "/upload", "/x")[i % 3],
        headers=hdrs[rng.integers(0, len(hdrs))]) for i in range(L7_SMALL)]
    long_reqs = [HTTPRequest(method="GET", path="/public/" + "p" * int(n),
                             host="admin.example.com")
                 for n in rng.integers(200, 520, L7_SMALL)]
    cases = [_http_case("http-headers", list(HEADER_RULES), header_reqs,
                        2048, dev),
             _http_case("http-long-payload", list(HTTP_RULES), long_reqs,
                        2048, dev)]
    strategies = {c["describe"][part]["strategy"] for c in cases
                  for part in c["describe"]}
    if card and "assoc" not in strategies:
        raise AssertionError(f"no assoc case on the card: {strategies}")
    for case in cases:
        emit("l7-case", **case)
    sweep = _strategy_sweep(dev)
    emit("l7-sweep", engines=sweep)

    # config 4: Kafka ACLs run on the host only
    kafka = KafkaPolicyEngine(list(KAFKA_RULES))
    kreqs = config4_requests(8192)
    kafka.check(kreqs)
    t0 = time.perf_counter()
    for _ in range(10):
        verdicts = kafka.check(kreqs)
    kafka_s = (time.perf_counter() - t0) / 10
    emit("l7-kafka", device="host (no device work)", batch=len(kreqs),
         allowed=sum(verdicts), batch_s=kafka_s,
         requests_per_s=len(kreqs) / kafka_s)
    launches = dv.dense_verdict.launches
    emit("l7-summary", hand_kernel_launches={"dense_verdict": launches},
         **{f"{r['engine']}_{r['batch']}_median_ms": r["median_batch_ms"]
            for r in results})
    return launches



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    feats = probe()
    emit("device", **feats)
    if not feats["hopper"]:
        raise RuntimeError(f"capability {feats['capability']}: the kernels "
                           "are built for sm_90a (Hopper)")

    t0 = time.perf_counter()
    built = kernels.build("dense_verdict")
    emit("build", source="cilium_tpu_torch/csrc/dense_verdict.cu",
         seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in (built or {"log": ""})["log"]
                .splitlines() if "registers" in ln or "spill" in ln])

    # the bound's operation rate: the kernel's per-pair instructions from
    # its SASS, over the card's lanes for each pipe
    mix = sass_mix.hot_loop_mix(
        kernels.sass("dense_verdict"), "segment_verdict_kernel",
        dv.PACKETS_PER_THREAD)
    clock_hz = float(feats["max_sm_clock"].split()[0]) * 1e6
    pair = sass_mix.pair_seconds(mix["per_pair"], feats["sm_count"],
                                 clock_hz)
    pair_s = pair["seconds"]
    function_pair_s = FUNCTION_COMPARES_PER_PAIR / (
        sass_mix.LANES["alu"] * feats["sm_count"] * clock_hz)
    emit("sass", kernel="dense_verdict", **mix, sm_count=feats["sm_count"],
         max_sm_clock_hz=clock_hz, pair_seconds=pair_s,
         bound_pipe=pair["pipe"], function_pair_seconds=function_pair_s)

    phase_refusals(dev)
    parity_err = phase_parity(dev)

    base = run_state("baseline-config1", 100, dev, BATCH, ORACLE_SAMPLE, {
        "uniform": {"hash": 1000, "dense": 1000, "kernel": 200, "plain": 3},
        "allow-heavy": {"hash": 200, "dense": 200, "kernel": 200,
                        "plain": 0}}, pair_s, function_pair_s)
    north = run_state("north-star-10k", 10_000, dev, BATCH, ORACLE_SAMPLE, {
        "uniform": {"hash": 1000, "dense": 50, "kernel": 100, "plain": 1},
        "allow-heavy": {"hash": 200, "dense": 50, "kernel": 100,
                        "plain": 0}}, pair_s, function_pair_s)

    v4_launches, state4 = phase_v4(dev)
    v6_launches = phase_v6(dev, state4)
    config2_launches = phase_config2(dev)
    l7_launches = phase_l7(dev)

    def at(res):
        return {"b": res["batch"], "n": res["entries"],
                "ms": res["kernel_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "function_bound_ms": res["function_bound_ms"],
                "all_pairs_bound_ms": res["all_pairs_bound_ms"],
                "launches": res["launches"],
                "max_abs_err": res["parity"]["max_abs_err"],
                "grouping_share": res["grouping_share"]}

    runs = [res for state in (base, north) for res in state.values()]
    main_b, main_n = base["uniform"], north["uniform"]
    print(json.dumps({"kernels": [{
        "name": "dense_verdict", "route": "cuda",
        "source": "cilium_tpu_torch/csrc/dense_verdict.cu",
        "replaces": "cilium_tpu/ops/dense_verdict.py:155",
        "launches": main_b["launches"] + main_n["launches"],
        "max_abs_err": max([parity_err] + [res["parity"]["max_abs_err"]
                                           for res in runs]),
        "ms": main_b["kernel_ms"], "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "function_bound_ms": main_b["function_bound_ms"],
        "all_pairs_bound_ms": main_b["all_pairs_bound_ms"],
        "library_ms": None, "kernels_per_launch": list(GROUPING) +
        ["segment_verdict_kernel"],
        "shape": {"b": main_b["batch"], "n": main_b["entries"]},
        "grouping_share": main_b["grouping_share"],
        "v4_path_launches": v4_launches,
        "v6_path_launches": v6_launches,
        "config2_path_launches": config2_launches,
        "l7_path_launches": l7_launches,
        "north_star": {**at(main_n), "plain_ms": main_n["plain_ms"]},
        "allow_heavy": {"baseline": at(base["allow-heavy"]),
                        "north_star": at(north["allow-heavy"])}}]}),
          flush=True)
    print(feats["name_power_limit"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
