"""Lightweight span tracing for the control plane.

The shape of OpenTelemetry without the dependency: spans carry ids,
parents, attributes and wall-clock bounds; finished spans land in a
bounded in-memory ring (old traces evict, the hot path never blocks or
allocates unboundedly).  Context propagates two ways:

- implicitly, through a per-thread span stack (``tracer.span(...)``
  nests under the calling thread's active span), and
- explicitly, through ``SpanContext`` handles — the daemon's
  regeneration pipeline crosses threads (Trigger -> build workers), so
  the policy-propagation tracker carries the revision's root context
  and parents stage spans on it no matter which thread runs the stage.

When disabled every ``span()`` call returns the shared no-op span:
one attribute check, no allocation — the ~0%-overhead-off contract the
tracing-overhead bench enforces.

A whole copy of ``cilium_tpu/observability/tracer.py``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional


class SpanContext(NamedTuple):
    """An addressable point in a trace — what crosses call boundaries."""

    trace_id: str
    span_id: str


_ids = itertools.count(1)


def _new_id(prefix: str) -> str:
    return f"{prefix}{next(_ids):08x}"


class Span:
    """One unit of work.  Context-manager: ends (and rings) on exit."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "end", "attrs", "status", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id("s")
        self.parent_id = parent_id
        self.start = tracer.clock()
        self.end: Optional[float] = None
        self.attrs: Dict = dict(attrs or {})
        self.status = "ok"
        self._token = False  # True while on the thread-local stack

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None
                else self.tracer.clock()) - self.start

    def set_attr(self, key: str, value) -> "Span":
        self.attrs[key] = value
        return self

    def finish(self, status: Optional[str] = None) -> "Span":
        if self.end is None:
            self.end = self.tracer.clock()
            if status is not None:
                self.status = status
            self.tracer._ring(self)
        return self

    def to_dict(self) -> Dict:
        return {"trace-id": self.trace_id, "span-id": self.span_id,
                "parent-id": self.parent_id, "name": self.name,
                "start": self.start, "end": self.end,
                "duration-s": round(self.duration, 9),
                "status": self.status, "attrs": dict(self.attrs)}

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        self._token = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token:
            self.tracer._pop(self)
            self._token = False
        self.finish("error" if exc_type is not None else None)


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()
    trace_id = span_id = parent_id = ""
    attrs: Dict = {}
    context = SpanContext("", "")
    duration = 0.0

    def set_attr(self, key, value):
        return self

    def finish(self, status=None):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Bounded-buffer tracer with per-thread implicit context."""

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 clock=time.time):
        self.enabled = enabled
        self.clock = clock
        self.capacity = capacity
        self._lock = threading.Lock()
        self._finished: "deque[Span]" = deque(maxlen=capacity)
        self._local = threading.local()
        self.dropped = 0  # spans evicted from the ring

    # ------------------------------------------------------- span entry

    def span(self, name: str, attrs: Optional[Dict] = None,
             parent: Optional[SpanContext] = None,
             root: bool = False):
        """Open a span.  ``parent`` pins an explicit context (crossing
        threads or processes); ``root=True`` forces a new trace even
        under an active span; otherwise the calling thread's active
        span is the parent."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is not None and parent.trace_id:
            return Span(self, name, parent.trace_id, parent.span_id,
                        attrs)
        cur = None if root else self.current()
        if cur is not None:
            return Span(self, name, cur.trace_id, cur.span_id, attrs)
        return Span(self, name, _new_id("t"), None, attrs)

    def child_span(self, name: str, attrs: Optional[Dict] = None):
        """A span only when the calling thread already has an active
        trace — how transport layers (kvstore, relay) join the
        caller's trace without minting a free-standing root per op."""
        if not self.enabled or self.current() is None:
            return NOOP_SPAN
        return self.span(name, attrs)

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def current_context(self) -> Optional[SpanContext]:
        cur = self.current()
        return cur.context if cur is not None else None

    # -------------------------------------------------------- internals

    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:   # exited out of order
            stack.remove(span)

    def _ring(self, span: Span) -> None:
        with self._lock:
            if len(self._finished) == self._finished.maxlen:
                self.dropped += 1
            self._finished.append(span)

    # ---------------------------------------------------------- queries

    def snapshot(self, limit: int = 0) -> List[Dict]:
        """Finished spans, oldest first."""
        with self._lock:
            spans = list(self._finished)
        if limit:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def traces(self, limit: int = 50) -> List[Dict]:
        """Trace summaries, newest last: id, root name, span count,
        wall extent, and the union of root attrs."""
        with self._lock:
            spans = list(self._finished)
        by_trace: Dict[str, List[Span]] = {}
        order: List[str] = []
        for s in spans:
            if s.trace_id not in by_trace:
                order.append(s.trace_id)
            by_trace.setdefault(s.trace_id, []).append(s)
        out = []
        for tid in order[-limit:]:
            members = by_trace[tid]
            roots = [s for s in members if s.parent_id is None]
            root = roots[0] if roots else members[0]
            out.append({
                "trace-id": tid, "root": root.name,
                "spans": len(members),
                "start": min(s.start for s in members),
                "duration-s": round(
                    max((s.end or s.start) for s in members) -
                    min(s.start for s in members), 9),
                "attrs": dict(root.attrs)})
        return out

    def tree(self, trace_id: str) -> Optional[Dict]:
        """One trace as a nested span tree (children ordered by
        start time).  Spans whose parent fell off the ring re-root."""
        with self._lock:
            spans = [s for s in self._finished
                     if s.trace_id == trace_id]
        if not spans:
            return None
        nodes = {s.span_id: {**s.to_dict(), "children": []}
                 for s in spans}
        roots = []
        for s in sorted(spans, key=lambda s: s.start):
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent is not None
             else roots).append(node)
        return {"trace-id": trace_id, "spans": roots}

    def find_trace(self, **attrs) -> Optional[str]:
        """Newest trace whose root span carries every given attr."""
        for summary in reversed(self.traces(limit=1 << 30)):
            if all(summary["attrs"].get(k) == v
                   for k, v in attrs.items()):
                return summary["trace-id"]
        return None

    def stats(self) -> Dict:
        with self._lock:
            n = len(self._finished)
        return {"enabled": self.enabled, "capacity": self.capacity,
                "buffered": n, "dropped": self.dropped}

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self.dropped = 0

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None) -> None:
        if enabled is not None:
            self.enabled = enabled
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                self.capacity = capacity
                self._finished = deque(self._finished,
                                       maxlen=capacity)


# Process-global tracer (the daemon configures capacity/enabled from
# DaemonConfig; library code just imports this).
tracer = Tracer()
