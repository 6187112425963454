"""The incident flight recorder: a bounded ring of structured
state-transition events.

Copy of ``cilium_tpu/observability/events.py`` with the event types of
the serving tier (supervisor mode flips, breaker trips, rebuilds,
recoveries and overload watermark crossings) and of the agent (drift
audits, failing controllers, map pressure, threat mode and model pushes,
traffic analytics) and of the kvstore outage guard, and the
``DEGRADED_SIGNALS`` lint map over them (without the sharded
dataplane's series, which come with sharding).  Every transition lands
as one event stamped with a monotonic sequence number, wall time and
the owning shard, so an incident replays in order.  ``record()`` is a
lock, a list append and one counter increment; emitters sit on
transitions, never per batch.  Every event type is declared in
``EVENT_TYPES``; recording an undeclared type raises.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.metrics import registry

FLIGHT_RECORDER_EVENTS = registry.counter(
    "flight_recorder_events_total",
    "State-transition events recorded by the incident flight "
    "recorder, by event type")
FLIGHT_RECORDER_DROPPED = registry.counter(
    "flight_recorder_dropped_total",
    "Flight-recorder events evicted from the bounded ring before "
    "being read through a cursor, by evicted event type (a noisy "
    "emitter shows up as ITS type overrunning the ring, not as an "
    "anonymous aggregate)")

# ---------------------------------------------------------------------------
# Event type registry.  Each type is one degraded-condition transition;
# recording a type not declared here raises.
# ---------------------------------------------------------------------------

EVENT_DATAPLANE_TRIP = "dataplane-breaker-trip"
EVENT_DATAPLANE_DEGRADED = "dataplane-degraded"
EVENT_DATAPLANE_FAIL_STATIC = "dataplane-fail-static"
EVENT_DATAPLANE_REBUILD = "dataplane-rebuild"
EVENT_DATAPLANE_RECOVERED = "dataplane-recovered"
EVENT_SERVING_OVERLOAD = "serving-overload"
EVENT_KVSTORE_DEGRADED = "kvstore-degraded"
EVENT_KVSTORE_RECONCILING = "kvstore-reconciling"
EVENT_KVSTORE_RECOVERED = "kvstore-recovered"
EVENT_DRIFT_AUDIT = "drift-audit"
EVENT_CONTROLLER_FAILING = "controller-failing"
EVENT_MAP_PRESSURE = "map-pressure-warning"
EVENT_THREAT_MODE = "threat-mode"
EVENT_THREAT_MODEL = "threat-model-push"
EVENT_TRAFFIC_HEAVY_HITTER = "traffic-heavy-hitter"
EVENT_TRAFFIC_SCAN_SUSPECT = "traffic-scan-suspect"

EVENT_TYPES: Dict[str, str] = {
    EVENT_DATAPLANE_TRIP:
        "a device-lane fault was absorbed by a supervisor (attrs: "
        "stage, kind; fatal kinds trip the breaker immediately)",
    EVENT_DATAPLANE_DEGRADED:
        "a serving lane's supervisor mode flipped to degraded — its "
        "endpoints now serve FAIL-STATIC from the host oracle",
    EVENT_DATAPLANE_FAIL_STATIC:
        "first fail-static batch of a degradation window (attrs: "
        "records served from the host oracle so far)",
    EVENT_DATAPLANE_REBUILD:
        "a breaker-gated recovery attempt: device-table rebuild from "
        "the host-of-record + drift-audit gate (attrs: result)",
    EVENT_DATAPLANE_RECOVERED:
        "a serving lane's supervisor closed its breaker after a "
        "passing recovery gate — back on device",
    EVENT_SERVING_OVERLOAD:
        "a serving lane crossed its admission watermark pair (attrs: "
        "state on/off, pending weight)",
    EVENT_KVSTORE_DEGRADED:
        "the kvstore outage guard flipped to degraded — consumers pin "
        "last-known-good state, mutations journal",
    EVENT_KVSTORE_RECONCILING:
        "kvstore reconnect detected: journal replay + relist-and-diff "
        "repair started",
    EVENT_KVSTORE_RECOVERED:
        "kvstore reconcile completed and mode returned to ok (attrs: "
        "replayed, repaired, outage seconds)",
    EVENT_DRIFT_AUDIT:
        "a drift-audit sweep changed the compiler-correctness verdict "
        "or found divergences (attrs: status, divergences)",
    EVENT_CONTROLLER_FAILING:
        "a controller crossed the consecutive-failure threshold "
        "behind the controller-health degraded signal",
    EVENT_MAP_PRESSURE:
        "a fixed-capacity device table crossed its pressure warn "
        "threshold (attrs: map, occupancy)",
    EVENT_THREAT_MODE:
        "the inline threat-scoring plane changed enforcement mode "
        "(attrs: mode shadow/enforce/off — an enforce flip means a "
        "model can now drop/rate-limit/redirect allowed traffic)",
    EVENT_THREAT_MODEL:
        "a threat-model weight push hot-swapped through the "
        "delta-apply path (attrs: generation, repacked)",
    EVENT_TRAFFIC_HEAVY_HITTER:
        "an identity crossed the heavy-hitter byte-share threshold in "
        "a decoded analytics epoch (attrs: identity, share, bytes) — "
        "transition-edged per identity, so the timeline orders the "
        "hitter next to the overload/threat events it explains",
    EVENT_TRAFFIC_SCAN_SUSPECT:
        "the analytics scan view flagged an identity probing many "
        "distinct destination ports in one epoch (attrs: identity, "
        "ports, packets)",
}

# ---------------------------------------------------------------------------
# Degraded-signal coverage map: {status() section: (event types, metric
# names)}.  The loudness lint asserts every status section that can
# report a degraded condition appears here, every named event type is
# declared above, and every named metric is registered — a new failure
# mode cannot ship silent.
# ---------------------------------------------------------------------------

DEGRADED_SIGNALS: Dict[str, Dict[str, tuple]] = {
    "dataplane": {
        "events": (EVENT_DATAPLANE_TRIP, EVENT_DATAPLANE_DEGRADED,
                   EVENT_DATAPLANE_FAIL_STATIC, EVENT_DATAPLANE_REBUILD,
                   EVENT_DATAPLANE_RECOVERED, EVENT_SERVING_OVERLOAD),
        "metrics": ("cilium_tpu_dataplane_mode",
                    "cilium_tpu_dataplane_device_faults_total",
                    "cilium_tpu_dataplane_fail_static_verdicts_total",
                    "cilium_tpu_dataplane_recoveries_total",
                    "cilium_tpu_dataplane_overloaded"),
    },
    "kvstore": {
        "events": (EVENT_KVSTORE_DEGRADED, EVENT_KVSTORE_RECONCILING,
                   EVENT_KVSTORE_RECOVERED),
        "metrics": ("cilium_tpu_kvstore_mode",
                    "cilium_tpu_kvstore_staleness_seconds",
                    "cilium_tpu_kvstore_reconcile_total"),
    },
    "controller-health": {
        "events": (EVENT_CONTROLLER_FAILING,),
        "metrics": ("cilium_tpu_controller_runs_total",),
    },
    "provenance": {
        "events": (EVENT_DRIFT_AUDIT,),
        "metrics": ("cilium_tpu_policy_drift_total",
                    "cilium_tpu_policy_drift_audit_runs_total"),
    },
    "map-pressure": {
        "events": (EVENT_MAP_PRESSURE,),
        "metrics": ("cilium_tpu_map_pressure",
                    "cilium_tpu_map_shard_pressure"),
    },
    "threat": {
        "events": (EVENT_THREAT_MODE, EVENT_THREAT_MODEL),
        "metrics": ("cilium_tpu_threat_verdicts_total",
                    "cilium_tpu_threat_score",
                    "cilium_tpu_threat_model_generation"),
    },
    "analytics": {
        "events": (EVENT_TRAFFIC_HEAVY_HITTER,
                   EVENT_TRAFFIC_SCAN_SUSPECT),
        "metrics": ("cilium_tpu_analytics_top_bytes",
                    "cilium_tpu_analytics_drains_total",
                    "cilium_tpu_analytics_queries_total",
                    "cilium_tpu_analytics_scan_suspects"),
    },
}

@dataclass(frozen=True)
class FlightEvent:
    """One recorded state transition."""

    seq: int                  # recorder-assigned monotonic cursor
    timestamp: float          # wall time (operator-facing)
    monotonic: float          # monotonic stamp (ordering within a run)
    type: str                 # EVENT_TYPES key
    detail: str = ""
    shard: Optional[int] = None
    trace_id: str = ""
    attrs: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"seq": self.seq, "timestamp": self.timestamp,
                "monotonic": self.monotonic, "type": self.type,
                "detail": self.detail, "shard": self.shard,
                "trace-id": self.trace_id, "attrs": dict(self.attrs)}

    def describe(self) -> str:
        where = f"[shard {self.shard}] " if self.shard is not None \
            else ""
        attrs = " ".join(f"{k}={v}" for k, v in
                         sorted(self.attrs.items()))
        out = f"{where}{self.type}"
        if self.detail:
            out += f": {self.detail}"
        if attrs:
            out += f" ({attrs})"
        return out


class FlightRecorder:
    """Bounded, process-global transition-event ring (the incident
    flight recorder).  Thread-safe; eviction is oldest-first and
    accounted so a cursor-based reader can tell a quiet agent from an
    overrun ring."""

    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self._mu = threading.Lock()
        self._ring: List[FlightEvent] = []
        self._next_seq = 1
        self.evicted = 0
        self.evicted_by_type: Dict[str, int] = {}

    def record(self, event_type: str, detail: str = "",
               shard: Optional[int] = None,
               **attrs) -> FlightEvent:
        """Ring one transition event.  ``event_type`` must be declared
        in EVENT_TYPES — an undeclared type is a programming error, not
        an event.  The current tracer span's trace id (if any) rides
        along so an incident timeline joins the span-trace surface."""
        if event_type not in EVENT_TYPES:
            raise ValueError(f"undeclared flight-recorder event type "
                             f"{event_type!r} — add it to EVENT_TYPES")
        trace_id = ""
        try:
            from .tracer import tracer
            cur = tracer.current()
            if cur is not None:
                trace_id = cur.trace_id
        except Exception:  # noqa: BLE001 — recording must never fail
            pass           # because tracing is mid-teardown
        with self._mu:
            ev = FlightEvent(
                seq=self._next_seq, timestamp=time.time(),
                monotonic=time.monotonic(), type=event_type,
                detail=detail, shard=shard, trace_id=trace_id,
                attrs=dict(attrs))
            self._next_seq += 1
            self._ring.append(ev)
            if len(self._ring) > self.capacity:
                drop = len(self._ring) - self.capacity
                # account the evicted slice by type BEFORE truncating:
                # the dropped series answers "whose events did the
                # overrun cost us", not just "how many"
                for dropped in self._ring[:drop]:
                    self.evicted_by_type[dropped.type] = \
                        self.evicted_by_type.get(dropped.type, 0) + 1
                    FLIGHT_RECORDER_DROPPED.inc(
                        labels={"type": dropped.type})
                self._ring = self._ring[drop:]
                self.evicted += drop
        FLIGHT_RECORDER_EVENTS.inc(labels={"type": event_type})
        return ev

    @property
    def last_seq(self) -> int:
        with self._mu:
            return self._next_seq - 1

    def events(self, since: int = 0, limit: int = 200,
               event_type: Optional[str] = None,
               shard: Optional[int] = None) -> List[FlightEvent]:
        """Events after the ``since`` cursor, oldest first (forward
        paging, like the monitor/flow rings), optionally filtered by
        type and shard."""
        with self._mu:
            ring = list(self._ring)
        out = [e for e in ring if e.seq > since
               and (event_type is None or e.type == event_type)
               and (shard is None or e.shard == shard)]
        return out[:limit] if limit else out

    def timeline(self, since: int = 0) -> List[str]:
        """Rendered one-line-per-event view (oldest first)."""
        return [f"#{e.seq} "
                f"{time.strftime('%H:%M:%S', time.localtime(e.timestamp))}"
                f" {e.describe()}" for e in self.events(since, limit=0)]

    def stats(self) -> Dict:
        with self._mu:
            ringed = len(self._ring)
            by_type: Dict[str, int] = {}
            for e in self._ring:
                by_type[e.type] = by_type.get(e.type, 0) + 1
            return {"capacity": self.capacity, "ringed": ringed,
                    "seq": self._next_seq - 1, "evicted": self.evicted,
                    "by-type": by_type,
                    "evicted-by-type": dict(self.evicted_by_type)}

    def reset(self) -> None:
        """Drop all buffered events (test isolation; cursors keep
        advancing so ``since`` semantics survive a reset)."""
        with self._mu:
            self._ring = []


# the process-global recorder every emitter writes to (like ``tracer``)
recorder = FlightRecorder()
