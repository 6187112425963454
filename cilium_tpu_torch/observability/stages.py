"""Host-timed pipeline stage slices and blocking boundaries.

Copy of ``cilium_tpu/observability/stages.py``.  The step is queued on
the card and returns; the host-side pipeline around it is where stalls
surface: waiting on the engine lock, packing the batch, the dispatch
call (which blocks in ``cudaLaunchKernel`` once a step queues more
kernels than the launch queue holds), and the completion wait that
blocks on real compute.  Each slice is timed where it runs into one
labeled histogram plus a running summary served by
``pipeline_report()``.

The same module names the program's own ranges on the profiler's
clock: ``span(name)`` opens a range ``dp:<name>`` while a profiler runs
(and is a shared no-op otherwise), ``host_span(family, stage, name)`` is
that range timed into ``record_stage`` on exit, and ``spanned(name)``
wraps a whole function in one.  A device activity belongs to the
innermost ``dp:`` range open on its launching thread at its runtime
call, so a range's device time is its self time.  The ranges are
recorded as functions (``_RecordFunctionFast``), not as the user
annotations ``torch.profiler.record_function`` makes: the profiler
gives a user annotation a twin on the device's timeline, which a reader
of the device's activities would have to tell apart from its kernels.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Dict, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

from ..utils.metrics import registry

SPAN_PREFIX = "dp:"

PIPELINE_STAGE_SECONDS = registry.histogram(
    "pipeline_stage_seconds",
    "Host-observed pipeline stage slices by family and stage "
    "(lock-wait, dispatch, sync, ...)",
    buckets=(1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, .01, .05, .1, .5,
             1, 5))


class _StageStat:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if seconds < self.min:
            self.min = seconds
        if seconds > self.max:
            self.max = seconds

    def to_dict(self) -> Dict:
        return {"count": self.count,
                "total-s": round(self.total, 6),
                "mean-us": round(self.total / self.count * 1e6, 2)
                if self.count else 0.0,
                "min-us": round(self.min * 1e6, 2)
                if self.count else 0.0,
                "max-us": round(self.max * 1e6, 2)}


_lock = threading.Lock()
_stats: Dict[str, Dict[str, _StageStat]] = {}

# blocking boundaries: stages whose wall time is device compute the
# host waited out, not host work — pipeline_report flags them so an
# operator reads "sync is 90% of the budget" as device-bound, not as
# a host regression.  "complete" is the serving dispatcher's ticket
# resolution (datapath/serving.py) — the ONE whitelisted sync on the
# latency-tier path, always one batch behind the launch front.
BLOCKING_STAGES = frozenset({"sync", "block", "device-sync",
                             "complete"})


def record_stage(family: str, stage: str, seconds: float) -> None:
    """Account one stage slice (hot path: one dict walk + histogram
    observe)."""
    PIPELINE_STAGE_SECONDS.observe(
        seconds, labels={"family": family, "stage": stage})
    with _lock:
        fam = _stats.get(family)
        if fam is None:
            fam = _stats[family] = {}
        st = fam.get(stage)
        if st is None:
            st = fam[stage] = _StageStat()
        st.add(seconds)


def pipeline_report() -> Dict:
    """Per-family stage breakdown with share-of-family percentages."""
    with _lock:
        snap = {fam: {stage: st.to_dict()
                      for stage, st in stages.items()}
                for fam, stages in _stats.items()}
    for fam, stages in snap.items():
        fam_total = sum(s["total-s"] for s in stages.values()) or 1.0
        for stage, s in stages.items():
            s["share-pct"] = round(s["total-s"] / fam_total * 100, 2)
            s["blocking-boundary"] = stage in BLOCKING_STAGES
    return snap


def reset() -> None:
    with _lock:
        _stats.clear()


# the one no-op context every span returns while no profiler runs
NOOP_SPAN = contextlib.nullcontext()


def span(name: str, tag: Optional[object] = None):
    """The range ``dp:<name>`` (``dp:<name>#<tag>`` with a tag, such as
    a batch's sequence number) while a profiler runs, else
    ``NOOP_SPAN``: no range is made and nothing is allocated.  The
    check is one read of the flag the profiler's start and stop set."""
    if not _autograd_profiler._is_profiler_enabled:
        return NOOP_SPAN
    label = SPAN_PREFIX + name if tag is None else \
        f"{SPAN_PREFIX}{name}#{tag}"
    return _RecordFunctionFast(label)


@contextlib.contextmanager
def host_span(family: str, stage: str, name: str):
    """``span(name)`` whose host wall time is also recorded as the
    stage slice ``(family, stage)``: the ``/debug/pipeline`` histograms
    and the trace come from one place."""
    t0 = time.perf_counter()
    with span(name):
        yield
    record_stage(family, stage, time.perf_counter() - t0)


def spanned(name: str):
    """Decorator: the whole call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
