"""Rate-limited trigger/debounce.

A copy of ``cilium_tpu/utils/trigger.py``, with ``wait_idle`` added (a
barrier for callers that must see a folded run finish).

Reference: pkg/trigger/trigger.go — serializes calls to TriggerFunc,
folding bursts of ``Trigger()`` calls into one invocation and enforcing
MinInterval between invocations; reports folded reason lists and latency.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class Trigger:
    """Debounced background invoker of ``trigger_func(reasons)``."""

    def __init__(self, trigger_func: Callable[[List[str]], None],
                 min_interval: float = 0.0, name: str = "",
                 metrics_observer: Optional[Callable[[float, float],
                                                     None]] = None):
        self.name = name
        self.trigger_func = trigger_func
        self.min_interval = min_interval
        self.metrics_observer = metrics_observer  # (latency, duration)
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._running = False
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pending_reasons: List[str] = []
        self._first_pending: float = 0.0
        self._last_run: float = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"trigger-{name}")
        self._thread.start()

    def trigger(self, reason: str = "") -> None:
        """Request a run; burst calls fold into one (trigger.go Trigger)."""
        with self._lock:
            if not self._pending_reasons:
                self._first_pending = time.time()
            if reason and reason not in self._pending_reasons:
                self._pending_reasons.append(reason)
            elif not reason and not self._pending_reasons:
                self._pending_reasons.append("")
            # inside the lock: a drain between append and set() would
            # otherwise leave a stale wake that runs trigger_func([])
            self._wake.set()

    def wait_idle(self, timeout: float) -> bool:
        """Block until no run is pending or running; False on timeout."""
        with self._idle:
            return self._idle.wait_for(
                lambda: not self._pending_reasons and not self._running,
                timeout=timeout)

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            # Enforce MinInterval since the previous run.
            with self._lock:
                due = self._last_run + self.min_interval
            delay = due - time.time()
            if delay > 0:
                if self._stop.wait(timeout=delay):
                    return
            with self._lock:
                reasons = [r for r in self._pending_reasons if r]
                self._pending_reasons = []
                first = self._first_pending
                self._wake.clear()
                self._last_run = time.time()
                self._running = True
            latency = time.time() - first if first else 0.0
            t0 = time.perf_counter()
            try:
                self.trigger_func(reasons)
            except Exception:
                pass  # trigger funcs own their error handling
            finally:
                with self._idle:
                    self._running = False
                    self._idle.notify_all()
            if self.metrics_observer:
                self.metrics_observer(latency, time.perf_counter() - t0)
