"""The circuit breaker of the serving supervisor.

Copy of ``cilium_tpu/utils/resilience.py``'s ``CircuitBreaker`` and its
states (the deadline and retry helpers there serve the control-plane
transports, which the port does not have yet).  Closed -> open after
``failure_threshold`` consecutive failures; open admits nothing until
``reset_timeout`` elapses, then half-open admits exactly one probe; probe
success closes, probe failure re-opens with the timeout doubled up to
``max_reset``.
"""

from __future__ import annotations

import threading
import time

from .metrics import registry

BREAKER_TRANSITIONS = registry.counter(
    "transport_breaker_transitions_total",
    "Circuit breaker state transitions")
BREAKER_OPEN = registry.gauge(
    "transport_breaker_open",
    "1 while the named circuit breaker is open or probing")

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    ``allow()`` is non-blocking: True while closed; while open it
    returns False until ``reset_timeout`` has elapsed, then flips to
    half-open and admits exactly ONE probe.  ``record_success`` closes
    (and resets the timeout); ``record_failure`` re-opens with the
    timeout doubled, bounded by ``max_reset``."""

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
        """Force the breaker open now, bypassing the consecutive-failure
        grace (faults classified fatal); same doubling reset cadence."""
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
