#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's verdict paths on one NVIDIA card.

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
   conntrack table).  Parity: the same port on the card and on the CPU,
   from one seed, 2 batches at B = 2**20 then 8 at B = 2**16 across a GC
   and a restore of a conntrack snapshot taken mid-run; after every
   batch verdicts, events, identities, every NAT field, the counters,
   every CT field (sentinel included) and the provenance are compared
   bit for bit and the mismatch counts printed.  Then ``process_packed``
   on batches already on the card under
   ``torch.cuda.set_sync_debug_mode("error")``, and behind a half-second
   ``torch.cuda._sleep`` before which it must return (a host read in the
   step fails the run), timing of ``process_packed`` (one H2D of the [10, B]
   matrix from a pinned buffer per call) and of ``process`` (ten H2D
   copies from the host columns) with CUDA events after warm-up batches
   that fill the table, the table's occupancy, the shares of verdicts and
   events, and a ``torch.profiler`` breakdown of the step.  No
   hand-written kernel runs on this path: the dense kernel's launch
   count, set to 0 before it, is read after it.
6. the kernels line, the card's name and power limit from nvidia-smi,
   and a last line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cilium_tpu_torch import kernels, sass_mix
from cilium_tpu_torch.compiler.lpm import (LPM_MISS, oracle_lpm_u32,
                                           parse_prefixes)
from cilium_tpu_torch.compiler.policy_tables import oracle_verdict
from cilium_tpu_torch.datapath import conntrack, engine, events
from cilium_tpu_torch.datapath.codes import VERDICT_DROP, WORLD_IDENTITY
from cilium_tpu_torch.datapath.pipeline import PACKED_FIELDS
from cilium_tpu_torch.device import cuda_ms, probe
from cilium_tpu_torch.ops import dense_verdict as dv
from cilium_tpu_torch.policy.mapstate import (PolicyKey, PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.profile_config1 import V4_WARMUP, profile_v4
from cilium_tpu_torch.workloads import (TRAFFICS, V4_T0,
                                        Config1Run, V4Run,
                                        v4_serving_packets,
                                        v4_serving_state)

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
# phase 5: the v4 stateful step
# ---------------------------------------------------------------------------

V4_STATE = {}           # v4_serving_state() arguments: full width
V4_BATCH = 1 << 20
V4_SMALL = 1 << 16
V4_FLOWS = 1 << 16
V4_CT_SLOTS = 1 << 20
V4_CT_PROBE = 8
V4_TIMED = {"process_packed": 60, "process": 30}
# about half a second of torch.cuda._sleep at the H100's 1.98 GHz
SLEEP_CYCLES = 1_000_000_000


def v4_mismatches(outs_g, outs_c, gpu, cpu) -> dict:
    """Elements that differ between the card's and the CPU's step, per
    output: verdict, event, identity, every NAT field, both counters,
    every CT field (sentinel included, the discard slot left out) and
    the provenance slot and tier."""
    pairs = [(name, g, c) for name, g, c in
             zip(("verdict", "event", "identity"), outs_g[:3], outs_c[:3])]
    pairs += [(f"nat.{f}", getattr(outs_g[3], f), getattr(outs_c[3], f))
              for f in outs_g[3]._fields]
    pairs += [(f"counters.{f}", getattr(gpu.counters, f),
               getattr(cpu.counters, f)) for f in ("packets", "bytes")]
    n = gpu.ct.slots + 1
    pairs += [(f"ct.{f}", gpu.ct.state[i, :n], cpu.ct.state[i, :n])
              for i, f in enumerate(conntrack.FIELDS)]
    if gpu.provenance_enabled:
        pairs += [(f"provenance.{f}", getattr(gpu.last_provenance, f),
                   getattr(cpu.last_provenance, f))
                  for f in ("match_slot", "tier")]
    return {name: int((g.cpu() != c).sum()) for name, g, c in pairs}


def v4_parity(state, dev) -> dict:
    """The port on the card and on the CPU, from one seed and one state:
    2 batches at B = 2**20, then 8 at B = 2**16 after a 60 s pause (so
    SYN-only and closed entries have expired), with a snapshot after the
    5th batch, a GC after the 6th and, after the 8th, a restore of that
    snapshot into both.  Raises on any mismatch."""
    pair = []
    for where in (dev, torch.device("cpu")):
        dp = engine.Datapath(ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                             device=where)
        state.load(dp)
        dp.enable_provenance()
        pair.append(dp)
    gpu, cpu = pair
    total = {}
    big = v4_serving_packets(state, V4_BATCH, n_flows=V4_FLOWS, seed=5)
    small = v4_serving_packets(state, V4_SMALL, n_flows=V4_FLOWS // 16,
                               seed=6)
    snapshot = None
    for k in range(10):
        b, stream = (V4_BATCH, big) if k < 2 else (V4_SMALL, small)
        now = V4_T0 + k if k < 2 else V4_T0 + 60 + k
        host = torch.as_tensor(next(stream))
        outs_g = gpu.process_packed(host.to(dev), now=now)
        outs_c = cpu.process_packed(host, now=now)
        torch.cuda.synchronize()
        extra = {}
        if k == 4:
            snapshot = gpu.snapshot_ct()
        if k == 5:
            extra["gc_deleted"] = [gpu.gc(now), cpu.gc(now)]
        if k == 7:
            extra["restored"] = [gpu.restore_ct_snapshots(*snapshot),
                                 cpu.restore_ct_snapshots(*snapshot)]
        mism = v4_mismatches(outs_g, outs_c, gpu, cpu)
        for name, (g, c) in extra.items():
            mism[name] = int(g != c)
        for name, bad in mism.items():
            total[name] = total.get(name, 0) + bad
        emit("v4-parity", batch_index=k, b=b, now=now,
             mismatches=sum(mism.values()),
             ct_entries=gpu.ct_entries()[0], **extra,
             nonzero={n: v for n, v in mism.items() if v})
        if any(mism.values()):
            raise AssertionError(f"v4 step: card != CPU at batch {k}: "
                                 f"{ {n: v for n, v in mism.items() if v} }")
    return {"batches": 10, "mismatches": total}


def v4_sync_check(run: V4Run) -> dict:
    """No host read inside ``process_packed``, shown two ways on batches
    already on the card, provenance on and off:

    - under ``set_sync_debug_mode("error")`` every synchronising call
      PyTorch detects raises;
    - behind a ``torch.cuda._sleep`` that holds the stream for about
      half a second, the call must return on the host before the sleep
      ends: a read anywhere in the step would wait for it."""
    batches = [torch.as_tensor(run.next_batch(), device=run.device)
               for _ in range(4)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    host_ms = []
    for i, prov in enumerate((True, False)):
        (run.dp.enable_provenance if prov else run.dp.disable_provenance)()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run.step(batches[i])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        run.advance()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        run.step(batches[2 + i])
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        run.advance()
    if max(host_ms) >= sleep_ms:
        raise AssertionError(f"process_packed waited for the card: host "
                             f"{host_ms} ms behind a {sleep_ms} ms sleep")
    return {"calls": 4, "sync_debug_mode": "error", "raised": False,
            "sleep_ms": sleep_ms, "host_ms_behind_sleep": host_ms}


def v4_timed(run: V4Run, calls: int, packed_path: bool) -> dict:
    """Per-batch device time of ``calls`` fresh batches, CUDA events
    around the host-to-device copy and the step (clock, GC and the
    next batch's generation outside): ``process_packed`` copies the
    [10, B] matrix once from a pinned staging buffer; ``process`` makes
    its batch with ``make_full_batch`` (ten copies).  Also the shares of
    verdicts and events over the timed batches."""
    stage = torch.empty((len(PACKED_FIELDS), run.batch),
                        dtype=torch.int32).pin_memory()
    ms, event_counts, verdict_counts = [], {}, {}
    for _ in range(calls):
        host = run.next_batch()
        stage.copy_(torch.from_numpy(host))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if packed_path:
            out = run.step(stage.to(run.device, non_blocking=True))
        else:
            cols = {f: host[i] for i, f in enumerate(PACKED_FIELDS)}
            out = run.dp.process(engine.make_full_batch(
                **cols, device=run.device), now=run.now)
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
    return {"entry": "process_packed" if packed_path else "process",
            "batch": run.batch, "samples": len(ms),
            "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)),
            "verdicts_per_s": run.batch / (float(np.median(ms)) / 1e3),
            "verdict_share": {k: v / n_pk
                              for k, v in verdict_counts.items()},
            "event_share": {k: v / n_pk for k, v in event_counts.items()}}


def phase_v4(dev) -> int:
    """The v4 phase; returns the dense kernel's launches during it (the
    path runs no hand-written kernel)."""
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
    t0 = time.perf_counter()
    parity = v4_parity(state, dev)
    emit("v4-parity-total", seconds=time.perf_counter() - t0, **parity)

    run = V4Run(V4_BATCH, dev, ct_slots=V4_CT_SLOTS, ct_probe=V4_CT_PROBE,
                state=state, n_flows=V4_FLOWS)
    t0 = time.perf_counter()
    deleted = 0
    for _ in range(V4_WARMUP):
        run.step(torch.as_tensor(run.next_batch(), device=dev))
        deleted += run.advance()
    torch.cuda.synchronize()
    emit("v4-warmup", batches=V4_WARMUP, gc_deleted=deleted,
         ct_entries=run.dp.ct_entries()[0],
         ct_occupancy=run.dp.ct_entries()[0] / V4_CT_SLOTS,
         seconds=time.perf_counter() - t0)
    sync = v4_sync_check(run)
    emit("v4-sync", **sync)
    timed = [v4_timed(run, V4_TIMED["process_packed"], True),
             v4_timed(run, V4_TIMED["process"], False)]
    for res in timed:
        emit("v4-timing", **res)
    occupancy = run.dp.ct_entries()[0] / V4_CT_SLOTS
    prof = profile_v4(run, 5)
    emit("v4-profile", batch=V4_BATCH, **prof)
    launches = dv.dense_verdict.launches
    shares = timed[0]["event_share"]
    for name in ("to-endpoint", "to-overlay", "Policy denied (L3/L4)",
                 "Prefilter denied"):
        if not shares.get(name):
            raise AssertionError(f"v4 step: no packet took {name!r}")
    emit("v4", ct_occupancy=occupancy,
         hand_kernel_launches={"dense_verdict": launches},
         median_batch_ms=timed[0]["median_batch_ms"],
         p99_batch_ms=timed[0]["p99_batch_ms"],
         verdicts_per_s=timed[0]["verdicts_per_s"])
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

    v4_launches = phase_v4(dev)

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
