"""Shared transport resilience: deadlines, idempotency-aware retries,
and circuit breaking for every control-plane transport.

A whole copy of ``cilium_tpu/utils/resilience.py``: the serving
supervisor's breaker, the Hubble relay's deadlines and the status
summary the agent reports.

Reference: the reliability budget of pkg/kvstore/etcd.go and client-go's
Reflector — every request bounded by a deadline, reconnect-retry only
where re-sending cannot double-apply, and flapping peers degraded to a
bounded probe cadence instead of a hot loop.  The three in-repo
control-plane transports (kvstore/etcd.py + kvstore/remote.py,
k8s/client.py, verdict_service.py) all build on this module:

- ``Deadline``: a monotonic budget threaded through retry loops so a
  transport op can never outlive its caller's patience.
- ``retry_call``: bounded blind retry with backoff — for idempotent
  requests ONLY.  Mutations must verify-on-retry instead: a transport
  error after the request was delivered leaves the outcome unknown
  (``AmbiguousResult``), and a blind re-send of a CAS would mis-report
  failure against the caller's own first write.
- ``idempotency_token``: unique per-request tokens; a mutation whose
  written value IS its token can resolve ambiguity by reading it back
  (the lock-acquisition verify path in kvstore/etcd.py).
- ``CircuitBreaker``: closed -> open after ``failure_threshold``
  consecutive failures; open admits nothing until ``reset_timeout``
  elapses, then half-open admits exactly one probe; probe success
  closes, probe failure re-opens with the timeout doubled up to
  ``max_reset`` — a flapping peer costs one connection per bounded
  interval, never a reconnect storm.

All counters live in the process metrics registry (utils/metrics.py) so
they ride the existing /metrics exposition; ``status_summary()`` is the
agent-status-path view (daemon/daemon.py status()).
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from typing import Callable, Dict, Optional, Tuple

from .metrics import registry

# ------------------------------------------------------------- metrics

TRANSPORT_RETRIES = registry.counter(
    "transport_retries_total",
    "Blind retries of idempotent control-plane requests")
TRANSPORT_DEADLINES = registry.counter(
    "transport_deadline_expired_total",
    "Control-plane requests abandoned at their deadline")
TRANSPORT_VERIFIES = registry.counter(
    "transport_verify_on_retry_total",
    "Ambiguous mutations resolved by reading the result back")
BREAKER_TRANSITIONS = registry.counter(
    "transport_breaker_transitions_total",
    "Circuit breaker state transitions")
BREAKER_OPEN = registry.gauge(
    "transport_breaker_open",
    "1 while the named circuit breaker is open or probing")
WATCH_RELISTS = registry.counter(
    "transport_watch_relists_total",
    "Full relists forced by watch compaction or 410 Gone")
SYNTHETIC_EVENTS = registry.counter(
    "transport_watch_synthetic_events_total",
    "Events synthesized by relist-and-diff recovery")


class DeadlineExceeded(OSError):
    """A transport operation outlived its budget."""


class AmbiguousResult(RuntimeError):
    """The request may or may not have been applied: the transport
    failed after the request was delivered.  Callers must verify the
    outcome (read the result back) instead of blindly re-sending."""


class Deadline:
    """Monotonic time budget; ``None`` timeout means unbounded."""

    __slots__ = ("_at",)

    def __init__(self, timeout: Optional[float]):
        self._at = None if timeout is None else \
            time.monotonic() + timeout

    def remaining(self) -> float:
        if self._at is None:
            return float("inf")
        return max(0.0, self._at - time.monotonic())

    @property
    def expired(self) -> bool:
        return self._at is not None and time.monotonic() >= self._at

    def check(self, what: str = "operation") -> None:
        if self.expired:
            TRANSPORT_DEADLINES.inc()
            raise DeadlineExceeded(f"{what}: deadline exceeded")


def idempotency_token() -> str:
    """Unique per-request token.  A mutation that writes its token as
    (part of) the value can resolve an ambiguous retry by reading the
    key back: value == own token means the first send landed."""
    return uuid.uuid4().hex


def retry_call(fn: Callable, *, attempts: int = 3,
               deadline: Optional[Deadline] = None,
               backoff_base: float = 0.02, backoff_max: float = 0.5,
               retryable: Tuple[type, ...] = (OSError,),
               stop: Optional[threading.Event] = None,
               labels: Optional[Dict[str, str]] = None):
    """Call ``fn`` with bounded blind retries — idempotent ops ONLY
    (a re-sent read returns the same answer; a re-sent mutation may
    double-apply: use verify-on-retry for those)."""
    n = 0
    while True:
        try:
            return fn()
        except retryable:
            n += 1
            exhausted = n >= attempts or \
                (deadline is not None and deadline.expired) or \
                (stop is not None and stop.is_set())
            if exhausted:
                if deadline is not None and deadline.expired:
                    TRANSPORT_DEADLINES.inc()
                raise
            TRANSPORT_RETRIES.inc(labels=labels)
            delay = min(backoff_base * (2 ** (n - 1)), backoff_max)
            if deadline is not None:
                delay = min(delay, deadline.remaining())
            if stop is not None:
                stop.wait(delay)
            else:
                time.sleep(delay)


# live breakers, for the agent status path (weak: test daemons come and
# go; a dead breaker must not pin its transport)
_BREAKERS: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    ``allow()`` is non-blocking: True while closed; while open it
    returns False until ``reset_timeout`` has elapsed, then flips to
    half-open and admits exactly ONE probe.  ``record_success`` closes
    (and resets the timeout); ``record_failure`` re-opens with the
    timeout doubled, bounded by ``max_reset`` — so a dead peer costs
    one connection attempt per interval, not a hot loop."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 0.5, max_reset: float = 30.0):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.max_reset = max_reset
        self._mu = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._current_reset = reset_timeout
        self._probe_at = 0.0
        _BREAKERS.add(self)

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def allow(self) -> bool:
        with self._mu:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN and \
                    time.monotonic() >= self._probe_at:
                self._transition(STATE_HALF_OPEN)
                return True  # this caller carries the single probe
            return False

    def retry_in(self) -> float:
        """Seconds until the next probe may be admitted (0 when
        closed; a short poll while a half-open probe is in flight)."""
        with self._mu:
            if self._state == STATE_CLOSED:
                return 0.0
            if self._state == STATE_HALF_OPEN:
                return 0.05
            return max(0.0, self._probe_at - time.monotonic())

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            if self._state != STATE_CLOSED:
                self._current_reset = self.reset_timeout
                self._transition(STATE_CLOSED)

    def record_failure(self) -> None:
        with self._mu:
            self._failures += 1
            tripped = self._state == STATE_HALF_OPEN or (
                self._state == STATE_CLOSED and
                self._failures >= self.failure_threshold)
            if tripped:
                self._open_locked()

    def trip(self) -> None:
        """Force the breaker open NOW, bypassing the consecutive-
        failure grace — for faults classified fatal (a lost device
        path will not heal within the failure-counting window).  Keeps
        the same doubling reset cadence as counted failures."""
        with self._mu:
            self._failures = max(self._failures, self.failure_threshold)
            self._open_locked()

    def _open_locked(self) -> None:
        self._probe_at = time.monotonic() + self._current_reset
        self._current_reset = min(self._current_reset * 2,
                                  self.max_reset)
        self._transition(STATE_OPEN)

    def _transition(self, to: str) -> None:
        # callers hold self._mu
        if to == self._state:
            return
        self._state = to
        BREAKER_TRANSITIONS.inc(labels={"name": self.name, "to": to})
        BREAKER_OPEN.set(0.0 if to == STATE_CLOSED else 1.0,
                         labels={"name": self.name})


def status_summary() -> Dict:
    """Aggregate resilience counters for the agent status path."""
    return {
        "retries": int(TRANSPORT_RETRIES.total()),
        "deadline-expired": int(TRANSPORT_DEADLINES.total()),
        "verify-on-retry": int(TRANSPORT_VERIFIES.total()),
        "watch-relists": int(WATCH_RELISTS.total()),
        "synthetic-events": int(SYNTHETIC_EVENTS.total()),
        "breaker-transitions": int(BREAKER_TRANSITIONS.total()),
        "breakers": {b.name: b.state for b in list(_BREAKERS)},
    }
