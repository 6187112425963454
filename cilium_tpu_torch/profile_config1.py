"""Where the config-1 step's device time goes, per engine and state.

    python3 -m cilium_tpu_torch.profile_config1

Needs one CUDA card.  For BASELINE config 1 (100 rules) and the 10k-rule
north-star state, both at B = 2**20 packets, and for each engine (hash,
dense), it warms the step up, records a few steps under
``torch.profiler`` and prints one JSON line: host wall ms per step
(ending in a synchronise, profiler on), device busy ms per step (the sum
of the kernels' own device time), the busy share of the wall time, and
the kernels with the most device time, with their launches per step.
The end-to-end numbers are ``chip_smoke.py``'s, taken with the profiler
off.
"""

from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .workloads import Config1Run

STATES = ((100, {"hash": 20, "dense": 20}),
          (10_000, {"hash": 20, "dense": 3}))


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


def main() -> None:
    dev = torch.device("cuda:0")
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
