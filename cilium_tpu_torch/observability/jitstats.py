"""First-call telemetry around the engine's entry points.

Copy of ``cilium_tpu/observability/jitstats.py``, names kept.  The port
runs eagerly, so there is no trace and no XLA compile; what stands in
for a "compile" is the first call of an entry point per (table
generation, batch geometry): it pays the caching allocator's first
allocations of that geometry, and on a card the first use of each
kernel.  ``JitTelemetry.record(entry, instance, key, seconds)``
classifies each timed dispatch: an unseen (instance, key) is a MISS
(counted and histogrammed as a compile), a seen one a HIT.
"""

from __future__ import annotations

import threading
from typing import Dict, Set, Tuple

from ..utils.metrics import registry

COMPILE_COUNT = registry.counter(
    "jit_compile_total",
    "First calls per table generation x batch geometry (the eager "
    "port's compile analog) by entry point")
COMPILE_SECONDS = registry.histogram(
    "jit_compile_seconds",
    "Wall time of first-call dispatches by entry point",
    buckets=(.01, .05, .1, .25, .5, 1, 2.5, 5, 10, 30, 60, 120))
JIT_CACHE_EVENTS = registry.counter(
    "jit_cache_events_total",
    "First-call misses and repeat-call hits across the entry points")


class JitTelemetry:
    """Process-wide compile/cache accounting (cheap: one set lookup
    and two counter bumps per dispatch when enabled)."""

    def __init__(self):
        self.enabled = True
        self._lock = threading.Lock()
        self._seen: Set[Tuple[str, int, object]] = set()
        self._compiles: Dict[str, int] = {}
        self._compile_seconds: Dict[str, float] = {}
        self._hits = 0
        self._misses = 0

    def record(self, entry: str, instance: int, key,
               seconds: float) -> bool:
        """Account one timed dispatch of ``entry``.  ``instance``
        identifies the table generation (a rebuild makes a new one),
        ``key`` its input geometry (batch size).  Returns True when
        classified as a first call (miss)."""
        if not self.enabled:
            return False
        tag = (entry, instance, key)
        with self._lock:
            miss = tag not in self._seen
            if miss:
                self._seen.add(tag)
                self._misses += 1
                self._compiles[entry] = self._compiles.get(entry, 0) + 1
                self._compile_seconds[entry] = \
                    self._compile_seconds.get(entry, 0.0) + seconds
                # the seen-set grows one tag per first call; bound it
                # so a pathological shape churn cannot leak
                if len(self._seen) > 65536:
                    self._seen.clear()
                    self._seen.add(tag)
            else:
                self._hits += 1
        if miss:
            COMPILE_COUNT.inc(labels={"entry": entry})
            COMPILE_SECONDS.observe(seconds, labels={"entry": entry})
            JIT_CACHE_EVENTS.inc(labels={"event": "miss"})
        else:
            JIT_CACHE_EVENTS.inc(labels={"event": "hit"})
        return miss

    def report(self) -> Dict:
        with self._lock:
            return {
                "compiles": dict(self._compiles),
                "compile-seconds": {k: round(v, 6) for k, v in
                                    self._compile_seconds.items()},
                "cache-hits": self._hits,
                "cache-misses": self._misses,
            }

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()
            self._compiles.clear()
            self._compile_seconds.clear()
            self._hits = self._misses = 0


jit_telemetry = JitTelemetry()
