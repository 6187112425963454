"""Prometheus-style metrics registry (no external deps).

Copy of ``cilium_tpu/utils/metrics.py``'s registry (counters, gauges,
histograms, text exposition) with only the series the port writes: the
endpoint build queue's, the verdict outcomes and the dataplane
supervision series.  The
serving, SLO, stage and flight-recorder series are registered by their
own modules.
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

POLICY_VERDICTS = registry.counter(
    "policy_verdicts_total", "Datapath verdicts by outcome")
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
