"""Per-layer readings from a ``torch.profiler`` trace of the window.

Stages are marked from outside the program: ``stage_ranges`` wraps the
port functions that the metric files name (``"functions"``:
``module:attribute``, patched where the step looks them up) in
``record_function`` ranges named ``stage:<stage>``.  Each device
activity (kernel, copy, fill) goes to the innermost stage range that
was open on the launching thread when its runtime call was made; kernel
names are never used for this.  The harness marks its own phases with
``bench:<phase>`` ranges, which name the host's work in the idle gaps.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

STAGE = "stage:"
BENCH = "bench:"
SPAN = BENCH + "span"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")


def stage_ranges(specs: Sequence[Dict]):
    """Wrap every function a metric names; returns the undo."""
    undo = []
    seen = set()
    for spec in specs:
        for ref in spec.get("functions", ()):
            if ref in seen:
                continue
            seen.add(ref)
            mod_name, attr = ref.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            label = STAGE + spec["stage"]

            def wrapped(*a, __f=orig, __label=label, **k):
                with torch.profiler.record_function(__label):
                    return __f(*a, **k)
            setattr(mod, attr, wrapped)
            undo.append((mod, attr, orig))

    def restore():
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)
    return restore


def read_metrics(specs: Sequence[Dict], trace, facts: Dict) -> Dict:
    """Each per-layer metric its reader (``benchmark/readers/<reader>.py``)
    finds something to read for; the others are left out."""
    out = {}
    for spec in specs:
        reader = importlib.import_module(
            f"benchmark.readers.{spec['reader']}")
        value = reader.read(trace, spec, facts)
        if value is not None:
            out[spec["name"]] = value
    return out


def _kind(e) -> str:
    """The activity kind of a profiler event: from the event where this
    PyTorch says it, else from its device and name (runtime calls are
    ``cuda*`` / ``cu*`` on the host, copies ``Memcpy*`` and fills
    ``Memset*`` on the card)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        kind = at()
        return kind if isinstance(kind, str) else str(kind)
    name = e.name()
    ours = name.startswith((STAGE, BENCH))
    if "CUDA" in str(e.device_type()):
        if ours:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if ours:
        return "user_annotation"
    if name.startswith("cu") and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List]:
    """(covered ns, merged intervals) of [start, end) intervals."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class _Ranges:
    """The ranges of one kind on one thread, to find the innermost one
    open at a time.  Ranges of one kind nest a few deep at most."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 16), -1):
            s, e, name = self.ranges[j]
            if s <= t < e:
                return name
        return None


class DeviceTrace:
    """The device activities of a traced span, each with its stage."""

    def __init__(self, prof, batches: int):
        self.batches = batches
        events = prof.profiler.kineto_results.events()
        ranges: Dict[int, List] = defaultdict(list)
        launches: Dict[int, Tuple[int, int]] = {}
        device = []
        for e in events:
            kind = _kind(e)
            if kind == "user_annotation":
                ranges[e.start_thread_id()].append(
                    (e.start_ns(), e.end_ns(), e.name()))
            elif kind in RUNTIME_KINDS:
                for cid in (e.correlation_id(), e.linked_correlation_id()):
                    if cid:
                        launches[cid] = (e.start_ns(), e.start_thread_id())
            elif kind in DEVICE_KINDS:
                device.append(e)
        self.stages = {tid: _Ranges([x for x in r
                                     if x[2].startswith(STAGE)])
                       for tid, r in ranges.items()}
        self.phases = {tid: _Ranges([x for x in r
                                     if x[2].startswith(BENCH) and
                                     x[2] != SPAN])
                       for tid, r in ranges.items()}
        # the span is the harness's ``bench:span`` range
        spans = [(s, e, tid) for tid, r in ranges.items()
                 for s, e, name in r if name == SPAN]
        if len(spans) != 1:
            raise ValueError(f"expected one {SPAN} range, found "
                             f"{len(spans)}")
        lo, hi, self.main_thread = spans[0]
        self.span = (lo, hi)
        self.acts = []          # (start, end, kind, name, stage)
        unlinked = 0
        for e in device:
            s, end = e.start_ns(), e.end_ns()
            if end <= lo or s >= hi:
                continue
            launch = launches.get(e.correlation_id()) or \
                launches.get(e.linked_correlation_id())
            stage = None
            if launch is None:
                unlinked += 1
            else:
                r = self.stages.get(launch[1])
                if r is not None:
                    stage = r.at(launch[0])
            self.acts.append((max(s, lo), min(end, hi), _kind(e), e.name(),
                              stage and stage[len(STAGE):]))
        self.unlinked = unlinked

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    def busy_s(self) -> float:
        covered, _ = _union([(s, e) for s, e, *_ in self.acts])
        return covered / 1e9

    def stage_ms(self, stage: str) -> Optional[float]:
        """Device ms a batch of the activities the stage launched."""
        times = [e - s for s, e, _, _, st in self.acts if st == stage]
        if not times:
            return None
        return sum(times) / 1e6 / self.batches

    def kernels(self) -> int:
        return sum(1 for a in self.acts if a[2] == "kernel")

    def copy_ms(self, name_part: str) -> Optional[float]:
        times = [e - s for s, e, kind, name, _ in self.acts
                 if kind == "gpu_memcpy" and name_part in name]
        if not times:
            return None
        return sum(times) / 1e6 / self.batches

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for s, e, _, name, _ in self.acts:
            total[name] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        # kernel names cut to 160 letters (their template arguments run on)
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time inside the span, summed by the
        harness phase (``bench:`` range) open on the main thread when
        each gap began."""
        _, merged = _union([(s, e) for s, e, *_ in self.acts])
        lo, hi = self.span
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        r = self.phases.get(self.main_thread)
        total: Dict[str, int] = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                phase = r.at(a) if r is not None else None
                total[phase[len(BENCH):] if phase else "other"] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]
