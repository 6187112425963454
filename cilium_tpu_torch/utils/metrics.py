"""Prometheus-style metrics registry (no external deps).

Copy of ``cilium_tpu/utils/metrics.py``'s registry (counters, gauges,
histograms, text exposition) with only the series the port writes: the
endpoint build queue's, the daemon's policy and identity gauges, the
verdict outcomes and their provenance, the conntrack GC sweeps, the
drift audit, the dataplane supervision series with their per-shard
twins, the controllers',
Hubble's and its federation's, the kvstore's and the optional stages'
(threat, analytics, L7 fast).  The serving, SLO, stage
and flight-recorder series are registered by their own modules.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _lk(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


def _escape(value: str) -> str:
    """Escape a label value per the Prometheus exposition format."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()

    def expose(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _lk(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_lk(labels), 0.0)

    def total(self) -> float:
        """Sum across every label combination."""
        with self._lock:
            return sum(self._values.values())

    def expose(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{_fmt_labels(k)} {v}"
                    for k, v in sorted(self._values.items())] or \
                [f"{self.name} 0"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_lk(labels)] = float(value)

    def inc(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _lk(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        self.inc(-amount, labels)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_lk(labels), 0.0)

    def total(self) -> float:
        """Sum across every label combination."""
        with self._lock:
            return sum(self._values.values())

    def expose(self) -> List[str]:
        with self._lock:
            return [f"{self.name}{_fmt_labels(k)} {v}"
                    for k, v in sorted(self._values.items())] or \
                [f"{self.name} 0"]


DEFAULT_BUCKETS = (.0001, .0005, .001, .005, .01, .05, .1, .5, 1, 5, 10)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        self.observe_many(value, 1, labels)

    def observe_many(self, value: float, count: int,
                     labels: Optional[Dict[str, str]] = None) -> None:
        """Record ``count`` identical observations in one locked pass
        — the batched-ingest path (e.g. per-packet threat scores
        grouped by distinct value) without a Python loop per packet."""
        key = _lk(labels)
        count = int(count)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += count
            self._sums[key] = self._sums.get(key, 0.0) + value * count
            self._totals[key] = self._totals.get(key, 0) + count

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        with self._lock:
            return self._totals.get(_lk(labels), 0)

    def total_count(self) -> int:
        """Observations across every label combination."""
        with self._lock:
            return sum(self._totals.values())

    def sum_value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._sums.get(_lk(labels), 0.0)

    def expose(self) -> List[str]:
        out = []
        with self._lock:
            # a declared histogram with zero observations must still
            # expose its full series (buckets, +Inf, _sum 0, _count 0)
            # — Counter/Gauge emit `name 0`, and conformance scrapers
            # expect every declared series to exist (the reference's
            # promhttp does the same for registered collectors)
            items = sorted(self._counts.items()) or \
                [(_lk(None), [0] * len(self.buckets))]
            for key, counts in items:
                for ub, c in zip(self.buckets, counts):
                    lk = key + (("le", repr(ub)),)
                    out.append(f"{self.name}_bucket{_fmt_labels(lk)} {c}")
                total = self._totals.get(key, 0)
                inf = key + (("le", "+Inf"),)
                out.append(
                    f"{self.name}_bucket{_fmt_labels(inf)} "
                    f"{total}")
                out.append(f"{self.name}_sum{_fmt_labels(key)} "
                           f"{self._sums.get(key, 0.0)}")
                out.append(f"{self.name}_count{_fmt_labels(key)} "
                           f"{total}")
        return out


class Registry:
    """Metric registry with Prometheus text exposition."""

    def __init__(self, namespace: str = "cilium_tpu"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{type(existing).__name__}, not "
                        f"{type(metric).__name__}")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(
            Counter(f"{self.namespace}_{name}", help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge(f"{self.namespace}_{name}", help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(
            Histogram(f"{self.namespace}_{name}", help_text, buckets))

    def expose_text(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


# Process-global registry and the series the port writes.
registry = Registry()

# The endpoint build queue (endpoint/manager.py).
ENDPOINT_COUNT = registry.gauge(
    "endpoint_count", "Number of endpoints managed by this agent")
ENDPOINT_REGENERATION_COUNT = registry.counter(
    "endpoint_regenerations",
    "Count of all endpoint regenerations that have completed")
ENDPOINT_REGENERATION_TIME = registry.histogram(
    "endpoint_regeneration_seconds",
    "Endpoint regeneration time")

ENDPOINT_STATE_COUNT = registry.gauge(
    "endpoint_state", "Count of all endpoints by state")
POLICY_COUNT = registry.gauge(
    "policy_count", "Number of policy rules loaded")
POLICY_REVISION = registry.gauge(
    "policy_max_revision", "Highest policy revision number in the agent")
POLICY_REGENERATION_COUNT = registry.counter(
    "policy_regeneration_total", "Count of policy regenerations")
POLICY_IMPORT_ERRORS = registry.counter(
    "policy_import_errors", "Count of failed policy imports")
POLICY_VERDICTS = registry.counter(
    "policy_verdicts_total", "Datapath verdicts by outcome")
# Conntrack GC series (Cilium's datapath_conntrack_gc_*).
CT_GC_RUNS = registry.counter(
    "datapath_conntrack_gc_runs_total",
    "Conntrack garbage-collection sweeps")
CT_GC_ENTRIES = registry.counter(
    "datapath_conntrack_gc_entries",
    "Conntrack entries by garbage-collection outcome")
# Verdict provenance series (datapath/events.py TIER_*): which stage
# of the compiled pipeline decided, which compiled entries are doing
# the denying, and the drift audit's correctness oracle.
POLICY_VERDICT_TIERS = registry.counter(
    "policy_verdicts_by_tier_total",
    "Datapath verdicts by provenance decision tier")
POLICY_RULE_DROPS = registry.counter(
    "policy_rule_drops_total",
    "Dropped packets by denied policy key (verdict provenance)")
POLICY_DRIFT = registry.counter(
    "policy_drift_total",
    "Drift-audit divergences between the compiled device tables and "
    "the host policy oracle")
POLICY_DRIFT_AUDIT_RUNS = registry.counter(
    "policy_drift_audit_runs_total",
    "Completed drift-audit sweeps by result")
# Dataplane supervision (datapath/supervisor.py): the serving lane's
# overload / device-fault / fail-static / recovery accounting.
DATAPLANE_OVERLOADED = registry.gauge(
    "dataplane_overloaded",
    "1 while a serving lane is above its admission high-watermark "
    "(hysteresis: clears at the low-watermark)")
DATAPLANE_MODE = registry.gauge(
    "dataplane_mode",
    "Dataplane serving mode (0 ok / 1 degraded / 2 recovering)")
DATAPLANE_RECOVERIES = registry.counter(
    "dataplane_recoveries_total",
    "Device-lane recoveries: breaker closed after a half-open probe "
    "passed the table rebuild + drift-audit gate")
DATAPLANE_DEVICE_FAULTS = registry.counter(
    "dataplane_device_faults_total",
    "Device-lane faults absorbed by the supervisor, by stage and kind")
DATAPLANE_FAIL_STATIC = registry.counter(
    "dataplane_fail_static_verdicts_total",
    "Verdicts served from the host fail-static oracle while the "
    "device lane is degraded")
# Per-shard fault-domain series (parallel/sharded.py): when the verdict
# dataplane is sharded across the device mesh, each ep-shard is its own
# fault domain with its own breaker — these series carry the shard
# index so a single-shard failure is visible as exactly that.
DATAPLANE_SHARD_MODE = registry.gauge(
    "dataplane_shard_mode",
    "Per-shard dataplane serving mode (0 ok / 1 degraded / "
    "2 recovering), by shard index")
DATAPLANE_SHARD_FAULTS = registry.counter(
    "dataplane_shard_faults_total",
    "Device-lane faults absorbed by a shard-scoped supervisor, by "
    "shard index and kind")
PROXY_REDIRECTS = registry.gauge(
    "proxy_redirects", "Number of active proxy redirects")
# On-device L7 fast verdicts (datapath/pipeline.py fast-verdict stage
# + l7/fast.py): connections decided inline by the fused DFA instead
# of a proxy round-trip, by protocol and outcome (allow / deny).
L7_FAST_VERDICTS = registry.counter(
    "l7_fast_verdicts_total",
    "L7 requests decided inline by the on-device fast-verdict stage "
    "(proxy bypassed), by protocol and outcome")
# Inline threat scoring (threat/ + the fused scoring stage in
# datapath/pipeline.py): per-packet anomaly verdict accounting, the
# score distribution, and the live model generation.
THREAT_VERDICTS = registry.counter(
    "threat_verdicts_total",
    "Packets scored by the inline threat stage, by outcome (scored = "
    "no override incl. every shadow-mode packet; rate-limited / "
    "redirected / dropped = enforce-mode overrides)")
THREAT_SCORES = registry.histogram(
    "threat_score",
    "Distribution of inline per-packet threat scores (0..255)",
    buckets=(8, 16, 32, 64, 96, 128, 160, 192, 224, 256))
THREAT_MODEL_GENERATION = registry.gauge(
    "threat_model_generation",
    "Generation of the threat-scoring model currently serving "
    "(bumped on every weight hot-swap)")
PROXY_UPSTREAM_TIME = registry.histogram(
    "proxy_upstream_reply_seconds", "Proxy upstream reply time")
DROP_COUNT = registry.counter(
    "drop_count_total", "Dropped packets by reason")
FORWARD_COUNT = registry.counter(
    "forward_count_total", "Forwarded packets")
IDENTITY_COUNT = registry.gauge(
    "identity_count", "Number of security identities allocated")
KVSTORE_OPERATIONS = registry.counter(
    "kvstore_operations_total", "kvstore operations by kind")

# Control-plane survivability series (kvstore/outage.py): the outage
# detector's mode/staleness view, the degraded-mode write journal, and
# the reconnect reconcile accounting — the control-plane twin of the
# dataplane_mode / fail-static series above.
KVSTORE_MODE = registry.gauge(
    "kvstore_mode",
    "kvstore client mode (0 ok / 1 degraded / 2 reconciling)")
KVSTORE_STALENESS = registry.gauge(
    "kvstore_staleness_seconds",
    "Seconds since the last successful kvstore operation (0 while the "
    "last operation succeeded)")
KVSTORE_JOURNAL_DEPTH = registry.gauge(
    "kvstore_journal_depth",
    "Mutations queued in the degraded-mode write journal awaiting "
    "reconnect replay")
KVSTORE_RECONCILE = registry.counter(
    "kvstore_reconcile_total",
    "Reconnect reconciles (journal replay + local-key repair) by "
    "result")
# Controller health (utils/controller.py): per-run outcome accounting
# behind the top-level controller-health degraded signal in status().
CONTROLLER_RUNS = registry.counter(
    "controller_runs_total",
    "Controller reconcile runs by controller name and outcome")

# Hubble flow-observability series (pkg/hubble/metrics analog): flow
# throughput, drops by reason x identity pair, L7 response-code
# distributions, and relay federation health.
HUBBLE_FLOWS_PROCESSED = registry.counter(
    "hubble_flows_processed_total",
    "Flow records processed by the observer")
HUBBLE_FLOWS_LOST = registry.counter(
    "hubble_lost_events_total",
    "Flow events lost (ring eviction or device table exhaustion)")
HUBBLE_DROPS = registry.counter(
    "hubble_drop_total",
    "Dropped-flow records by reason and identity pair")
HUBBLE_HTTP_RESPONSES = registry.counter(
    "hubble_http_responses_total",
    "HTTP responses observed at the proxy, by status code and method")
HUBBLE_DNS_RESPONSES = registry.counter(
    "hubble_dns_responses_total",
    "DNS responses observed, by rcode")
HUBBLE_RELAY_PEERS = registry.gauge(
    "hubble_relay_peers", "Registered relay peers by state")
HUBBLE_RELAY_FAILURES = registry.counter(
    "hubble_relay_peer_failures_total",
    "Relay peer fetch failures by peer and kind")
HUBBLE_RELAY_SECONDS = registry.histogram(
    "hubble_relay_peer_seconds",
    "Relay per-peer get_flows fan-out latency")

# Federated cross-shard Hubble series (hubble/federation.py): the
# sharded daemon's merged flow plane — per-shard device-table drains
# and the partial/ok accounting of merged shard-attributed answers.
HUBBLE_FEDERATION_QUERIES = registry.counter(
    "hubble_federation_queries_total",
    "Merged cross-shard flow queries served by the federated "
    "observer, by result (ok = every shard healthy, partial = at "
    "least one shard degraded or unreadable)")
HUBBLE_FEDERATION_DRAINED = registry.counter(
    "hubble_federation_drained_flows_total",
    "Flow records drained from per-shard device flow tables into the "
    "federated stores, by shard")
HUBBLE_FEDERATION_SHARDS = registry.gauge(
    "hubble_federation_shards",
    "Federated observer shard planes by state (available = store "
    "serving and drain breaker closed)")

# Device-resident traffic-analytics series (analytics/ + the fused
# sketch stage in datapath/pipeline.py): heavy-hitter byte shares
# decoded from the quiesced sketch epoch, the drain/query accounting
# of the merged mesh-wide answer, and the scan view's suspect count.
ANALYTICS_TOP_BYTES = registry.gauge(
    "analytics_top_bytes",
    "Bytes attributed to a top-K heavy-hitter identity in the last "
    "decoded analytics epoch, by identity (cardinality capped at the "
    "drain controller's K — evicted identities drop from the series)")
ANALYTICS_DRAINS = registry.counter(
    "analytics_drains_total",
    "Analytics epoch drains (swap + decode of the quiesced sketch "
    "sections), by result (ok = every shard readable, partial = at "
    "least one shard breaker-open or unreadable)")
ANALYTICS_QUERIES = registry.counter(
    "analytics_queries_total",
    "Merged mesh-wide analytics top-K queries served, by view "
    "(talkers / scanners / spreaders) and result (ok / partial)")
ANALYTICS_SCAN_SUSPECTS = registry.gauge(
    "analytics_scan_suspects",
    "Identities the analytics scan view flagged above the "
    "distinct-destination-port threshold in the last decoded epoch")
