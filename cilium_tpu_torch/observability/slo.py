"""The serving SLO tier: per-lane latency objectives, deadline-budget
burn rates, and queue-depth flight samples.

Copy of ``cilium_tpu/observability/slo.py``, fed from the serving
dispatcher's ticket lifecycle (``datapath/serving.py``):

- **Latency**: every resolved ticket observes submit->finalize latency
  into ``serving_slo_latency_seconds{lane}`` and a bounded per-lane
  reservoir (the p50/p99 source of ``snapshot()``); the stamps are host
  ``perf_counter`` pairs the dispatcher already takes.
- **Deadline-budget burn**: each lane has an objective latency (its
  admission deadline when one is configured, else the default).  A
  resolved ticket over the objective is a breach; the rolling burn rate
  is the breach fraction in the window over the error-budget fraction.
- **Queue-depth ring**: every launch samples (queued, inflight, pending
  weight) into a bounded ring.

Everything is host arithmetic on stamps that already exist; the module
reads nothing from the card (held by tests/test_torch_sync_lint.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..utils.metrics import registry

# serving latency spans ~100us (device round trip) to seconds
# (overload): the default bucket ladder resolves both ends
_SLO_BUCKETS = (.0001, .00025, .0005, .001, .0025, .005, .01, .025,
                .05, .1, .25, .5, 1.0, 5.0)

SERVING_SLO_LATENCY = registry.histogram(
    "serving_slo_latency_seconds",
    "Submit->finalize serving latency per resolved ticket, by lane",
    buckets=_SLO_BUCKETS)
SERVING_SLO_REQUESTS = registry.counter(
    "serving_slo_requests_total",
    "Tickets resolved through the serving SLO tier, by lane")
SERVING_SLO_BREACHES = registry.counter(
    "serving_slo_breaches_total",
    "Tickets that resolved over the lane's latency objective "
    "(deadline budget), by lane")
SERVING_SLO_BURN = registry.gauge(
    "serving_slo_budget_burn",
    "Rolling deadline-budget burn rate per lane: breach fraction in "
    "the window / error-budget fraction (>1 = burning faster than "
    "the SLO allows)")
SERVING_SLO_QUEUE = registry.gauge(
    "serving_slo_queue_depth",
    "Pending weight sampled at each serving launch, by lane")
SERVING_SLO_INFLIGHT = registry.gauge(
    "serving_slo_inflight",
    "In-flight device launches sampled at each serving launch, by "
    "lane")

# SLO defaults: 50ms objective at 99.9% — overridable per daemon
# config (serving lanes with an admission deadline use it as the
# objective instead: the deadline IS the budget being burned)
DEFAULT_OBJECTIVE_S = 0.050
DEFAULT_ERROR_BUDGET = 0.001   # allowed breach fraction (SLO 99.9%)
WINDOW = 1024                  # rolling outcomes per lane
RESERVOIR = 512                # latencies kept for p50/p99
QUEUE_RING = 256               # queue-depth samples kept per lane


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


class _LaneSLO:
    """One lane's rolling state (lock held by the tracker)."""

    __slots__ = ("lane", "shard", "objective", "requests", "breaches",
                 "latencies", "outcomes", "queue_ring", "worst")

    def __init__(self, lane: str, shard: Optional[int],
                 objective: float):
        self.lane = lane
        self.shard = shard
        self.objective = objective
        self.requests = 0
        self.breaches = 0
        self.latencies: List[float] = []   # bounded reservoir
        self.outcomes: List[bool] = []     # bounded breach window
        self.queue_ring: List[Dict] = []   # bounded flight samples
        self.worst = 0.0


class SLOTracker:
    """Process-global serving SLO state keyed by lane name (one lane
    per dispatcher; sharded planes run one lane per shard, named
    ``verdict-s<k>``, so per-shard objectives fall out naturally)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._lanes: Dict[str, _LaneSLO] = {}
        self.default_objective = DEFAULT_OBJECTIVE_S
        self.error_budget = DEFAULT_ERROR_BUDGET

    def configure(self, objective_s: Optional[float] = None,
                  error_budget: Optional[float] = None) -> None:
        with self._mu:
            if objective_s and objective_s > 0:
                self.default_objective = float(objective_s)
            if error_budget and error_budget > 0:
                self.error_budget = float(error_budget)

    def _lane(self, lane: str, shard: Optional[int],
              objective: Optional[float]) -> _LaneSLO:
        st = self._lanes.get(lane)
        if st is None:
            st = self._lanes[lane] = _LaneSLO(
                lane, shard, objective or self.default_objective)
        elif objective and st.objective != objective:
            st.objective = objective
        return st

    # ------------------------------------------------------- ingestion

    def observe(self, lane: str, latency_s: float,
                shard: Optional[int] = None,
                objective_s: Optional[float] = None) -> None:
        """One resolved ticket's submit->finalize latency.  The lane's
        objective is its admission deadline when the dispatcher has
        one (``objective_s``), else the tracker default."""
        with self._mu:
            st = self._lane(lane, shard, objective_s)
            st.requests += 1
            st.worst = max(st.worst, latency_s)
            breach = latency_s > st.objective
            if breach:
                st.breaches += 1
            st.latencies.append(latency_s)
            if len(st.latencies) > RESERVOIR:
                del st.latencies[:len(st.latencies) - RESERVOIR]
            st.outcomes.append(breach)
            if len(st.outcomes) > WINDOW:
                del st.outcomes[:len(st.outcomes) - WINDOW]
            burn = (sum(st.outcomes) / len(st.outcomes)) \
                / self.error_budget
        SERVING_SLO_LATENCY.observe(latency_s, labels={"lane": lane})
        SERVING_SLO_REQUESTS.inc(labels={"lane": lane})
        if breach:
            SERVING_SLO_BREACHES.inc(labels={"lane": lane})
        SERVING_SLO_BURN.set(round(burn, 4), labels={"lane": lane})

    def sample_queue(self, lane: str, queued: int, inflight: int,
                     pending_weight: int,
                     shard: Optional[int] = None) -> None:
        """One launch-time flight sample of the lane's queue state."""
        with self._mu:
            st = self._lane(lane, shard, None)
            st.queue_ring.append({
                "t": time.time(), "queued": queued,
                "inflight": inflight, "pending": pending_weight})
            if len(st.queue_ring) > QUEUE_RING:
                del st.queue_ring[:len(st.queue_ring) - QUEUE_RING]
        SERVING_SLO_QUEUE.set(float(pending_weight),
                              labels={"lane": lane})
        SERVING_SLO_INFLIGHT.set(float(inflight), labels={"lane": lane})

    # --------------------------------------------------------- reports

    def snapshot(self) -> Dict:
        """The ``status()`` SLO block: one row per lane with latency
        percentiles, breach/burn accounting, and the latest queue
        sample."""
        with self._mu:
            lanes = {}
            for name, st in sorted(self._lanes.items()):
                lat = sorted(st.latencies)
                window = len(st.outcomes)
                breach_frac = (sum(st.outcomes) / window) if window \
                    else 0.0
                last_q = st.queue_ring[-1] if st.queue_ring else None
                lanes[name] = {
                    "shard": st.shard,
                    "objective-ms": round(st.objective * 1e3, 3),
                    "requests": st.requests,
                    "breaches": st.breaches,
                    "burn-rate": round(breach_frac /
                                       self.error_budget, 4),
                    "p50-us": round(_percentile(lat, 0.50) * 1e6, 1),
                    "p99-us": round(_percentile(lat, 0.99) * 1e6, 1),
                    "worst-us": round(st.worst * 1e6, 1),
                    "queue": last_q,
                    "queue-samples": len(st.queue_ring),
                }
            return {"lanes": lanes,
                    "objective-ms": round(
                        self.default_objective * 1e3, 3),
                    "error-budget": self.error_budget}

    def queue_ring(self, lane: str) -> List[Dict]:
        with self._mu:
            st = self._lanes.get(lane)
            return list(st.queue_ring) if st is not None else []

    def reset(self) -> None:
        """Drop rolling state (test isolation)."""
        with self._mu:
            self._lanes = {}


# the process-global tracker the dispatchers feed (like ``tracer``)
slo_tracker = SLOTracker()
