"""Policy-propagation latency: a revision's journey to the dataplane.

Reference: pkg/metrics/metrics.go PolicyImplementationDelay — "time
between a policy import and the dataplane enforcing it".  Here every
repository revision is stamped at import and tracked through the
stages the TPU datapath actually has:

  import (policy_add)            -> rules in the repository
  compile (regenerate_policy)    -> per-endpoint map states resolved
  device apply (sync_endpoint +  -> rows realized in the device tables
                refresh_policy)
  first verdict                  -> the engine classified a batch at
                                    (or above) that revision

The import->first-verdict wall time lands in the
``policy_implementation_delay_seconds`` histogram, and every stage is
also a span in a per-revision trace (parented on the import span via
explicit SpanContext — regeneration runs on build-worker threads, so
implicit thread-local context cannot carry it).

A whole copy of ``cilium_tpu/observability/propagation.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..utils.metrics import registry
from .tracer import SpanContext, tracer as global_tracer

POLICY_IMPLEMENTATION_DELAY = registry.histogram(
    "policy_implementation_delay_seconds",
    "Time from policy-revision import to the first verdict served at "
    "that revision",
    buckets=(.001, .005, .01, .05, .1, .25, .5, 1, 2.5, 5, 10, 30))


class _RevisionRecord:
    __slots__ = ("revision", "t_import", "t_compiled", "t_applied",
                 "t_served", "rules", "endpoints_compiled",
                 "endpoints_applied", "context")

    def __init__(self, revision: int, t_import: float,
                 context: Optional[SpanContext]):
        self.revision = revision
        self.t_import = t_import
        self.t_compiled: Optional[float] = None
        self.t_applied: Optional[float] = None
        self.t_served: Optional[float] = None
        self.rules = 0
        self.endpoints_compiled = 0
        self.endpoints_applied = 0
        self.context = context

    def to_dict(self) -> Dict:
        out = {"revision": self.revision, "imported-at": self.t_import,
               "rules": self.rules,
               "endpoints-compiled": self.endpoints_compiled,
               "endpoints-applied": self.endpoints_applied,
               "trace-id": self.context.trace_id if self.context
               else None}
        for name, t in (("compile", self.t_compiled),
                        ("device-apply", self.t_applied),
                        ("first-verdict", self.t_served)):
            out[f"{name}-delay-s"] = (
                round(t - self.t_import, 9) if t is not None else None)
        return out


class PolicyPropagationTracker:
    """Stamps revision stages; thread-safe; bounded history."""

    def __init__(self, tracer=None, clock=time.time,
                 capacity: int = 128):
        self.tracer = tracer if tracer is not None else global_tracer
        self.clock = clock
        self.capacity = capacity
        self._lock = threading.Lock()
        self._recs: Dict[int, _RevisionRecord] = {}
        self._order: List[int] = []
        self.served_revision = 0

    # ------------------------------------------------------------ stages

    def revision_imported(self, revision: int, rules: int = 0,
                          import_seconds: float = 0.0
                          ) -> Optional[SpanContext]:
        """Record the import.  ``import_seconds`` is the measured
        policy_add body time; the import span is backdated by it so the
        trace shows the real import work, not a zero-width marker.
        Returns the revision trace's root context."""
        now = self.clock()
        span = self.tracer.span(
            f"policy.import rev={revision}",
            attrs={"revision": revision, "rules": rules}, root=True)
        # backdate to the true import start (span timing is our own
        # clock, safe to adjust before finish)
        if import_seconds and hasattr(span, "start"):
            span.start = now - import_seconds
        span.finish()
        ctx = span.context if span.context.trace_id else None
        with self._lock:
            rec = _RevisionRecord(revision, now - import_seconds, ctx)
            rec.rules = rules
            self._recs[revision] = rec
            self._order.append(revision)
            while len(self._order) > self.capacity:
                self._recs.pop(self._order.pop(0), None)
        return ctx

    def stage_span(self, revision: int, name: str,
                   attrs: Optional[Dict] = None):
        """A child span of the revision's trace (explicit parenting —
        works from any thread).  Falls back to a free-standing span
        when the revision was never imported through this tracker."""
        with self._lock:
            rec = self._recs.get(revision)
        parent = rec.context if rec is not None else None
        merged = {"revision": revision, **(attrs or {})}
        return self.tracer.span(name, attrs=merged, parent=parent)

    def revision_compiled(self, revision: int) -> None:
        now = self.clock()
        with self._lock:
            rec = self._recs.get(revision)
            if rec is None:
                return
            rec.endpoints_compiled += 1
            if rec.t_compiled is None:
                rec.t_compiled = now

    def revision_applied(self, revision: int) -> None:
        now = self.clock()
        with self._lock:
            rec = self._recs.get(revision)
            if rec is None:
                return
            rec.endpoints_applied += 1
            if rec.t_applied is None:
                rec.t_applied = now

    def revision_served(self, revision: int) -> None:
        """First verdict dispatched at ``revision``.  Revisions below
        it that never saw their own first verdict are implicitly live
        too (the datapath enforces the superseding revision), so they
        complete here as well — matching the reference's semantics of
        one delay sample per imported revision."""
        now = self.clock()
        with self._lock:
            if revision <= self.served_revision:
                return
            self.served_revision = revision
            pending = [self._recs[r] for r in self._order
                       if r <= revision and
                       self._recs[r].t_served is None]
            for rec in pending:
                rec.t_served = now
        for rec in pending:
            delay = max(0.0, now - rec.t_import)
            POLICY_IMPLEMENTATION_DELAY.observe(delay)
            self.tracer.span(
                f"policy.first-verdict rev={rec.revision}",
                attrs={"revision": rec.revision,
                       "delay-s": round(delay, 9)},
                parent=rec.context).finish()

    # ----------------------------------------------------------- queries

    def report(self, limit: int = 20) -> List[Dict]:
        with self._lock:
            revs = self._order[-limit:]
            return [self._recs[r].to_dict() for r in revs]

    def trace_id_of(self, revision: int) -> Optional[str]:
        with self._lock:
            rec = self._recs.get(revision)
        return rec.context.trace_id if rec is not None and rec.context \
            else None
