"""The harness: finds a cell's configuration, traffic mix, driver and
metrics by the names in ``BENCHMARK.json``, runs it once and prints the
result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own:

- ``benchmark/configs/<config>.json`` (the path ``BENCHMARK.json``
  gives): the deployment's sizes, engine settings and L7 redirects;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters and the
  driver (``benchmark/drivers/<driver>.py``) that serves it;
- ``benchmark/metrics/<metric>.json``: a per-layer metric's reader
  (``benchmark/readers/<reader>.py``) and what it reads.

So a later change adds a cell, a mix, a configuration or a metric by
adding files.  ``run_cell`` is the whole run; ``benchmark/run.py`` is its
command line and refuses to run without the card the cell asks for.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

# modules whose presence after the window refuses the run: the JAX
# stack and the JAX package the port was made from, compared by whole
# top-level name (the port's own name only begins with the latter)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cilium_tpu")


def process_elapsed_s() -> float:
    """Seconds since this process started (Linux: the process's start
    tick in ``/proc/self/stat`` against the boot clock)."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - \
        start_ticks / os.sysconf("SC_CLK_TCK")


def cache_dirs(root: Path) -> Dict[str, str]:
    """Fixed build and kernel cache directories inside the checkout, so
    that only a cell's first run in a checkout builds anything."""
    base = root / ".bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN_MODULES))


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One ``workloads`` entry with everything found by its names."""

    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]     # BENCHMARK.json entry + its metric file


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(root / configs[w["config"]]["file"])
    traffic = _load(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    per_layer = []
    for m in bench["per_layer"]:
        if _applies(m, workload):
            spec = _load(root / "benchmark" / "metrics" / f"{m['name']}.json")
            per_layer.append({**spec, **m})
    return Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=per_layer)


class Clock:
    """Completion of queued device work, the same on a card and on the
    CPU (where work is done when it is queued)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.device = device

    def mark(self):
        """An event at the current end of the stream (None on the CPU)."""
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    def wait(self, ev) -> None:
        if ev is not None:
            ev.synchronize()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def host(self, shape):
        """An int32 host tensor, page-locked on a card."""
        return self.torch.empty(shape, dtype=self.torch.int32,
                                pin_memory=self.cuda)


def on_device(tree, device):
    """A snapshot (tensors, possibly in nested dicts) on ``device``."""
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclass
class RunContext:
    root: Path
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    process_start: float                 # perf_counter at process start
    make_system: Callable                # (node, config, device) -> system
    log: Callable = field(default=lambda *a: print(*a, file=sys.stderr,
                                                   flush=True))


@dataclass
class Outcome:
    """What a driver hands back: requests attempted and failed, the
    end-to-end values, the per-layer readings, the checks (name, value,
    limit) and the device figures."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    per_layer: Dict[str, float]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    device_extra: Dict = field(default_factory=dict)
    breakdown: Optional[Dict] = None


def default_system(node, config, device):
    from .program import PortSystem
    return PortSystem(node, config, device)


def device_info(device, count: int) -> Dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import shutil
    import subprocess
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout else None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, process_start: float,
             make_system: Callable = default_system) -> Tuple[Dict, List]:
    """One run of one cell on ``device``: (result line, checks)."""
    cell = find_cell(root, workload)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    ctx = RunContext(root=root, cell=cell, seed=seed, seconds=seconds,
                     trace=trace, device=device,
                     process_start=process_start, make_system=make_system)
    out: Outcome = driver.run(ctx)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = out.per_layer if trace else out.end_to_end
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]],
                           "unit": units[m["name"]]}
               for m in wanted if values.get(m["name"]) is not None}
    correct = out.failed == 0 and all(v <= lim for _, v, lim in out.checks)
    dev = {**device_info(device, cell.chips),
           "memory_peak_bytes": out.memory_peak_bytes, **out.device_extra}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out.checks}
    return result, out.checks
