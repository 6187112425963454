"""Per-layer readings from the program's own ranges.

The port names its layers itself: ranges ``dp:<span>``
(``dp:<span>#<tag>`` where a tag, such as a dispatch's sequence number,
rides on the name), opened inside the functions that do the work while
a profiler runs (``cilium_tpu_torch/observability/stages.py``).  They
are recorded as functions, not user annotations, so the profiler makes
no twin of them on the card's timeline and ``trace.py``'s readings
stay as they were, whatever its ``_kind`` makes of their names.

The rule is the one ``trace.py`` keeps for its ``stage:`` ranges: a
device activity belongs to the innermost ``dp:`` range open on its
launching thread when its runtime call was made, so a span's device
time is its self time.  An activity is matched to its runtime call by
their shared correlation id alone: the linked correlation id is the id
of the operator that made the call, counted apart, so it can equal
another call's correlation id.  A span's idle time is the card's idle time
while the span was open on the harness's main thread: the part of a gap
that falls after the span closed, such as the harness's own work
between the program's calls, is left out.  A span's host time is its
wall on the main thread, split into the part inside CUDA runtime or
driver calls and the rest.

``SpanTrace.of(trace)`` keeps, beside a ``trace.DeviceTrace`` and
without changing it, the ``dp:`` ranges per thread, each device
activity's launch (thread, ns) and the runtime calls' intervals per
thread, all as plain tuples.  A program without these ranges gives
readings of None, never an error.

The reader interface hands a reader the ``DeviceTrace`` alone, which
keeps no profiler events, so ``SpanTrace.of`` takes them from the
``torch.profiler.profile`` that the calling driver holds (the nearest
caller frame with one among its locals), and raises where no caller
holds one: a lost profile is an error, not a program without spans.
"""

from __future__ import annotations

import bisect
import sys
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from .trace import DEVICE_KINDS, RUNTIME_KINDS, _kind, _union

DP = "dp:"


def span_name(label: str) -> str:
    """``dp:ct.create`` -> ``ct.create``; ``dp:engine.dispatch#7`` ->
    ``engine.dispatch``."""
    return label[len(DP):].split("#", 1)[0]


class Innermost:
    """The innermost of properly nested ranges open at a time: the
    ranges cut into pieces, each with the range innermost over it."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        points: List[Tuple[int, Optional[str]]] = []
        stack: List[Tuple[int, str]] = []
        for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= s:
                end, _ = stack.pop()
                points.append((end, stack[-1][1] if stack else None))
            stack.append((e, name))
            points.append((s, name))
        while stack:
            end, _ = stack.pop()
            points.append((end, stack[-1][1] if stack else None))
        self.times = [t for t, _ in points]
        self.names = [n for _, n in points]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.times, t)
        return self.names[i - 1] if i else None


def _overlap(a: List[List[int]], b: List[List[int]]) -> int:
    """ns covered by both of two merged, sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def caller_profile():
    """The ``torch.profiler.profile`` of the nearest caller frame that
    holds one; LookupError where none does."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    raise LookupError("no caller holds a torch.profiler.profile: the "
                      "span readers cannot find the profiler's events")


class SpanTrace:
    """The ``dp:`` ranges of a traced span and what they launched."""

    # the last trace read (weakly held) and its span trace
    _last: Tuple[object, Optional["SpanTrace"]] = (lambda: None, None)

    @classmethod
    def of(cls, trace) -> Optional["SpanTrace"]:
        """The span trace beside ``trace``, built once; None where the
        profiler's events hold no ``dp:`` range."""
        held, built = cls._last
        if held() is trace:
            return built
        built = cls(caller_profile().profiler.kineto_results.events(),
                    trace)
        if not built.ranges:
            built = None
        cls._last = (weakref.ref(trace), built)
        return built

    def __init__(self, events, trace):
        self.batches = trace.batches
        self.main_thread = trace.main_thread
        lo, hi = self.window = trace.span
        ranges: Dict[int, List] = defaultdict(list)
        runtime: Dict[int, List] = defaultdict(list)
        launches: Dict[int, Tuple[int, int]] = {}
        device = []
        for e in events:
            name = e.name()
            if name.startswith(DP):
                # a range on the host (none has a twin on the card)
                if "CUDA" not in str(e.device_type()):
                    ranges[e.start_thread_id()].append(
                        (e.start_ns(), e.end_ns(), span_name(name)))
                continue
            k = _kind(e)
            if k in RUNTIME_KINDS:
                tid = e.start_thread_id()
                runtime[tid].append((e.start_ns(), e.end_ns()))
                if e.correlation_id():
                    launches[e.correlation_id()] = (e.start_ns(), tid)
            elif k in DEVICE_KINDS:
                s, end = e.start_ns(), e.end_ns()
                if end > lo and s < hi:
                    device.append((max(s, lo), min(end, hi),
                                   e.correlation_id()))
        self.ranges = {tid: sorted(r) for tid, r in ranges.items()}
        self.runtime = {tid: _union(r)[1] for tid, r in runtime.items()}
        inner = {tid: Innermost(r) for tid, r in self.ranges.items()}
        # (start, end, span the activity's launch was innermost in)
        self.acts = []
        for s, end, cid in device:
            launch = launches.get(cid)
            name = None
            if launch is not None and launch[1] in inner:
                name = inner[launch[1]].at(launch[0])
            self.acts.append((s, end, name))
        self.busy = _union([(s, e) for s, e, _ in self.acts])[1]

    def open_on_main(self, span: str) -> List[List[int]]:
        """Merged intervals in which ``span`` was open on the main
        thread, cut to the window."""
        lo, hi = self.window
        return _union([(max(s, lo), min(e, hi)) for s, e, name in
                       self.ranges.get(self.main_thread, ())
                       if name == span and e > lo and s < hi])[1]

    def device_ms(self, span: str) -> Optional[float]:
        """Device ms a batch launched with ``span`` innermost."""
        times = [e - s for s, e, name in self.acts if name == span]
        if not times:
            return None
        return sum(times) / 1e6 / self.batches

    def idle_ms(self, span: str) -> Optional[float]:
        """Device idle ms a batch while ``span`` was open on the main
        thread: each gap cut to the span's open intervals."""
        spans = self.open_on_main(span)
        if not spans or not self.acts:
            return None
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        return _overlap(gaps, spans) / 1e6 / self.batches

    def host_ms(self, span: str, part: str) -> Optional[float]:
        """Host ms a batch in ``span`` on the main thread: ``runtime``
        inside CUDA runtime or driver calls, ``self`` the rest."""
        spans = self.open_on_main(span)
        if not spans:
            return None
        total = sum(e - s for s, e in spans)
        inside = _overlap(spans, self.runtime.get(self.main_thread, []))
        ns = inside if part == "runtime" else total - inside
        return ns / 1e6 / self.batches
