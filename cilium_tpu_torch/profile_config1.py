"""Where the config-1 step's, or a serving step's, device time goes.

    python3 -m cilium_tpu_torch.profile_config1        # config 1
    python3 -m cilium_tpu_torch.profile_config1 --v4   # the v4 step
    python3 -m cilium_tpu_torch.profile_config1 --v6   # the v6 step

Needs one CUDA card.  For BASELINE config 1 (100 rules) and the 10k-rule
north-star state, both at B = 2**20 packets, and for each engine (hash,
dense), it warms the step up, records a few steps under
``torch.profiler`` and prints one JSON line: host wall ms per step
(ending in a synchronise, profiler on), device busy ms per step (the sum
of the kernels' own device time), the busy share of the wall time, and
the kernels with the most device time, with their launches per step.
With ``--v4`` it does the same for ``Datapath.process_packed`` on the
full-width v4 serving state (``workloads.V4Run``) at B = 2**20, after
warm-up batches that fill the conntrack table; each profiled step
serves the stream's next batch, already on the card.  The end-to-end
numbers are ``chip_smoke.py``'s, taken with the profiler off.  With
``--v6`` it does the same for ``Datapath.process6`` on the full-width v6
serving state (``workloads.V6Run``).  Either serving step is profiled
with the flow table off, then, after warm-up batches with it on, with
the daemon's flow table (4,096 slots, probe 8, claim every 4th call).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .workloads import Config1Run, V4Run, V6Run

STATES = ((100, {"hash": 20, "dense": 20}),
          (10_000, {"hash": 20, "dense": 3}))
# v4 batches served before a measurement, to fill the conntrack table
V4_WARMUP = 12


def profile_step(step, steps: int, top: int = 8) -> dict:
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    return {"steps": steps, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top": [{"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3 / steps,
                     "launches": e.count / steps} for e in ranked[:top]]}


def profile_run(run, steps: int, top: int = 12) -> dict:
    """``profile_step`` over ``steps`` batches of ``run`` (a ``V4Run`` or
    ``V6Run``), each moved to the card before the profiled window; the
    clock and GC advance between steps, outside it."""
    batches = [torch.as_tensor(run.next_batch(), device=run.device)
               for _ in range(steps + 1)]

    def step():
        run.step(batches.pop())
        run.advance()
    return profile_step(step, steps, top)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    family = parser.add_mutually_exclusive_group()
    family.add_argument("--v4", action="store_true",
                        help="profile the v4 stateful step")
    family.add_argument("--v6", action="store_true",
                        help="profile the v6 stateful step")
    args = parser.parse_args()
    dev = torch.device("cuda:0")
    if args.v4 or args.v6:
        run = (V6Run if args.v6 else V4Run)(1 << 20, dev)
        label = "profile-v6" if args.v6 else "profile-v4"
        for flows_on in (False, True):
            if flows_on:
                run.dp.enable_flow_aggregation(slots=1 << 12, max_probe=8,
                                               claim_every=4)
            for _ in range(V4_WARMUP):
                run.step(torch.as_tensor(run.next_batch(), device=dev))
                run.advance()
            print(json.dumps({"phase": label, "batch": 1 << 20,
                              "flows_on": flows_on,
                              "ct_entries": run.dp.ct_entries(),
                              "flows": run.dp.flow_stats(),
                              **profile_run(run, 5)}), flush=True)
        return
    for n_rules, steps in STATES:
        run = Config1Run(n_rules, 1 << 20, dev)
        for engine, step in (("hash", run.hash_step),
                             ("dense", run.dense_step)):
            print(json.dumps({"phase": "profile", "rules": n_rules,
                              "engine": engine,
                              **profile_step(step, steps[engine])}),
                  flush=True)


if __name__ == "__main__":
    main()
