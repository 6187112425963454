#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's config-1 verdict path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero:

1. device: name, compute capability (must be 9.x, Hopper) and power
   limit.
2. build: the kernel ``cilium_tpu_torch/csrc/dense_verdict.cu``
   compiled by nvcc for sm_90a; then its SASS, read by cuobjdump, gives
   the instructions a (packet, entry) pair issues per pipe, from which
   the kernel's bound is computed.
3. parity: each kernel's wrapper against its plain PyTorch version on
   the card, bit-exact (tolerance 0: int32 verdicts and counters), on
   ragged batches, many entry tiles, identities >= 2**31, ports >= 32768
   and proxy-port values.
4. config1: the port's config-1 path (ipcache LPM -> 3-stage verdict ->
   per-entry counters) through both engines, hash and dense, at
   B = 2**20 packets for two policy states: BASELINE config 1 (100 rules
   x 16 endpoints) and the 10k-rule north-star state.  Hash verdicts must
   equal dense verdicts, both must equal the scalar oracle on a 4,096
   packet sample, the dense kernel must have been launched, and the
   kernel must equal its plain version on the whole batch (verdicts and
   every entry's counters).  Then both engines, the kernel alone and the
   plain version are timed with CUDA events.
5. the kernels line, the card's name and power limit from nvidia-smi,
   and a last line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from cilium_tpu_torch import kernels, sass_mix
from cilium_tpu_torch.compiler.lpm import (LPM_MISS, oracle_lpm_u32,
                                           parse_prefixes)
from cilium_tpu_torch.compiler.policy_tables import oracle_verdict
from cilium_tpu_torch.datapath.codes import VERDICT_DROP, WORLD_IDENTITY
from cilium_tpu_torch.device import probe
from cilium_tpu_torch.ops import dense_verdict as dv
from cilium_tpu_torch.policy.mapstate import (PolicyKey, PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.workloads import Config1Run

BATCH = 1 << 20
ORACLE_SAMPLE = 4096
# H100 SXM HBM3 rate (NVIDIA data sheet).  The operation rate is the
# card's own: its SM count and maximum SM clock, with the per-pipe lanes
# of cilium_tpu_torch/sass_mix.py, applied to the instructions the built
# kernel issues per (packet, entry) pair (read from its SASS).
HBM_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int) -> list:
    """Per-call device time of ``fn`` in ms, one CUDA event pair each,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def dense_bound_ms(tables, pkt_ep, pair_s: float) -> dict:
    """Least time for the dense verdict's work on the card: the larger of
    its bytes (entries read once, packets read once, verdicts and the
    two counter arrays written once) over the memory rate and its pairs
    at ``pair_s`` seconds each (the kernel's per-pair instructions over
    the card's rate for their pipe).  ``bound_ms`` counts the pairs this
    run's data needs: each packet against its own endpoint's entries.
    ``all_pairs_bound_ms`` counts every (packet, entry) pair, the work
    of the kernel as it stands."""
    n, b = int(tables.ep.shape[0]), int(pkt_ep.shape[0])
    real = tables.ep[tables.ep >= 0].to(torch.int64)
    per_ep = torch.bincount(real, minlength=int(pkt_ep.max()) + 1)
    pairs = int(per_ep[pkt_ep.to(torch.int64)].sum())
    t_bytes = 4 * (4 * n + 6 * b + b + 2 * n) / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * pair_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs, "all_pairs_bound_ms": max(
                t_bytes, b * n * pair_s * 1e3)}


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------

def _random_states(n_endpoints, n_rules, seed, wide):
    """Random per-endpoint states; ``wide`` draws identities >= 2**31
    and ports >= 32768 too.  Every state carries L3-only and wildcard
    keys and proxy-port values."""
    rng = np.random.default_rng(seed)
    idents = rng.integers(256, 4096, 16)
    ports = rng.integers(1, 2048, 16)
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


def _random_packets(n_endpoints, idents, ports, batch, seed, dev):
    rng = np.random.default_rng(seed)
    ident_pool = np.r_[idents, rng.integers(0, 2 ** 32, 16)]
    cols = (rng.integers(0, n_endpoints, batch),
            ident_pool.astype(np.uint32).view(np.int32)[
                rng.integers(0, len(ident_pool), batch)],
            rng.choice(np.r_[ports, 80, 0], batch),
            rng.choice([6, 6, 6, 0, 17], batch),
            rng.integers(0, 2, batch),
            rng.integers(40, 65536, batch))
    return tuple(torch.as_tensor(np.asarray(c, np.int32), device=dev)
                 for c in cols)


def compare_dense(tables, pkts) -> dict:
    """Kernel (``dense_verdict``) vs plain version on the same tensors;
    raises unless verdict and both counter deltas are bit-equal."""
    got = dv.dense_verdict(tables, *pkts)
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


def phase_parity(dev) -> float:
    cases = [  # (name, endpoints, rules, batch, wide keys)
        ("ragged-b1000", 4, 24, 1000, False),
        ("ragged-b4097-wide", 8, 60, 4097, True),
        ("many-tiles-n-not-tile-multiple", 16, 700, 1 << 14, True),
        ("one-packet", 3, 10, 1, True),
    ]
    worst = 0
    for i, (name, n_ep, n_rules, batch, wide) in enumerate(cases):
        states, idents, ports = _random_states(n_ep, n_rules, 100 + i,
                                               wide)
        tables = dv.compile_dense(states, device=dev)
        pkts = _random_packets(n_ep, idents, ports, batch, 200 + i, dev)
        res = compare_dense(tables, pkts)
        # kTile = 2048 entries in csrc/dense_verdict.cu
        if name.startswith("many-tiles") and res["n"] % 2048 == 0:
            raise AssertionError("entry count must not be a tile multiple")
        if batch > 1 and (res["allows"] == 0 or res["proxied"] == 0):
            raise AssertionError(f"{name}: no allow or proxy verdicts")
        worst = max(worst, res["max_abs_err"])
        emit("parity", kernel="dense_verdict", case=name, **res)
    return worst


# ---------------------------------------------------------------------------
# phase 4: the config-1 path
# ---------------------------------------------------------------------------

def run_state(label, n_rules, dev, batch, oracle_sample, iters,
              pair_s) -> dict:
    """``iters``: {"hash": n, "dense": n, "kernel": n, "plain": n} timed
    calls; ``pair_s``: least seconds per (packet, entry) pair."""
    t0 = time.perf_counter()
    run = Config1Run(n_rules, batch, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = int(run.dense.ep.shape[0])

    # the main path, once through each engine, kernel launches counted
    torch.cuda.reset_peak_memory_stats()
    dv.dense_verdict.launches = 0
    hv, hident, h_counters = run.hash_step()
    dvv, dident, d_pk, d_by = run.dense_step()
    torch.cuda.synchronize()
    launches = dv.dense_verdict.launches
    if launches < 1:
        raise AssertionError("dense_verdict kernel was not launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if not torch.equal(hv, dvv):
        raise AssertionError(f"{label}: hash verdicts != dense verdicts")
    if not torch.equal(hident, dident):
        raise AssertionError(f"{label}: hash identities != dense")
    non_drop = int((hv != VERDICT_DROP).sum())
    counted = {"hash": int(h_counters.packets.sum(dtype=torch.int64)),
               "dense": int(d_pk.sum(dtype=torch.int64))}
    if counted["hash"] != non_drop or counted["dense"] != non_drop:
        raise AssertionError(f"{label}: counted {counted} != non-drop "
                             f"{non_drop}")
    if int(d_by.sum(dtype=torch.int64)) != 512 * non_drop:
        raise AssertionError(f"{label}: dense byte counters off")

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
            raise AssertionError(f"{label}: packet {i} oracle mismatch")

    # timing: each engine's whole step, then the kernel alone
    pk = run.pkt

    def kernel_once():
        dv.dense_verdict(run.dense, pk["endpoint"], dident, pk["dport"],
                         pk["proto"], pk["direction"], pk["length"])

    engines = {}
    for name, fn in (("hash", run.hash_step), ("dense", run.dense_step)):
        ms = cuda_ms(fn, iters[name])
        engines[name] = {
            "verdicts_per_s": batch * len(ms) / (sum(ms) / 1e3),
            "median_batch_ms": float(np.median(ms)),
            "p99_batch_ms": float(np.percentile(ms, 99)),
            "max_batch_ms": float(max(ms)), "samples": len(ms)}
    k_ms = cuda_ms(kernel_once, iters["kernel"])
    result = {"label": label, "rules": n_rules, "entries": n,
              "lpm_prefixes": len(run.prefixes),
              "policy_slots": run.compiled.slots,
              "policy_probe": run.compiled.max_probe,
              "lpm_slots": run.lpm.slots, "lpm_probe": run.lpm.max_probe,
              "batch": batch, "setup_s": setup_s, "launches": launches,
              "non_drop": non_drop, "oracle_sample": len(idx),
              "peak_gb": peak_gb, "engines": engines,
              "kernel_ms": float(np.median(k_ms)), "kernel_samples": len(k_ms),
              **dense_bound_ms(run.dense, pk["endpoint"], pair_s)}

    # the kernel against its plain version on the whole main-path batch:
    # verdicts and every entry's packet and byte deltas
    args = (pk["endpoint"], dident, pk["dport"], pk["proto"],
            pk["direction"], pk["length"])
    result["parity"] = compare_dense(run.dense, args)
    result["plain_ms"] = float(np.median(cuda_ms(
        lambda: dv.dense_verdict_reference(run.dense, *args),
        iters["plain"])))
    emit("config1", **result)
    return result


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
    mix = sass_mix.hot_loop_mix(kernels.sass("dense_verdict"),
                                "dense_verdict_kernel")
    clock_hz = float(feats["max_sm_clock"].split()[0]) * 1e6
    pair = sass_mix.pair_seconds(mix["per_pair"], feats["sm_count"],
                                 clock_hz)
    emit("sass", kernel="dense_verdict", **mix, sm_count=feats["sm_count"],
         max_sm_clock_hz=clock_hz, pair_seconds=pair["seconds"],
         bound_pipe=pair["pipe"])

    parity_err = phase_parity(dev)

    base = run_state("baseline-config1", 100, dev, BATCH, ORACLE_SAMPLE,
                     {"hash": 1000, "dense": 1000, "kernel": 200,
                      "plain": 3}, pair["seconds"])
    north = run_state("north-star-10k", 10_000, dev, BATCH, ORACLE_SAMPLE,
                      {"hash": 1000, "dense": 20, "kernel": 10, "plain": 1},
                      pair["seconds"])

    print(json.dumps({"kernels": [{
        "name": "dense_verdict", "route": "cuda",
        "source": "cilium_tpu_torch/csrc/dense_verdict.cu",
        "replaces": "cilium_tpu/ops/dense_verdict.py:155",
        "launches": base["launches"] + north["launches"],
        "max_abs_err": max(parity_err, base["parity"]["max_abs_err"],
                           north["parity"]["max_abs_err"]),
        "ms": base["kernel_ms"], "plain_ms": base["plain_ms"],
        "bound_ms": base["bound_ms"], "bound_by": base["bound_by"],
        "all_pairs_bound_ms": base["all_pairs_bound_ms"],
        "library_ms": None,
        "shape": {"b": base["batch"], "n": base["entries"]},
        "north_star": {"b": north["batch"], "n": north["entries"],
                       "ms": north["kernel_ms"],
                       "plain_ms": north["plain_ms"],
                       "bound_ms": north["bound_ms"],
                       "bound_by": north["bound_by"],
                       "all_pairs_bound_ms": north["all_pairs_bound_ms"]}}]}),
          flush=True)
    print(feats["name_power_limit"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
