"""Host-timed pipeline stage slices and blocking boundaries.

Copy of ``cilium_tpu/observability/stages.py``.  The step is queued on
the card and returns; the host-side pipeline around it is where stalls
surface: waiting on the engine lock, packing the batch, the dispatch
call (which blocks in ``cudaLaunchKernel`` once a step queues more
kernels than the launch queue holds), and the completion wait that
blocks on real compute.  Each slice is timed where it runs into one
labeled histogram plus a running summary served by
``pipeline_report()``.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..utils.metrics import registry

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
