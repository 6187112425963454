"""Named, retrying reconcile loops.

Reference: pkg/controller/controller.go — a Controller runs ``DoFunc``
periodically (RunInterval) and on demand (``Update``), retrying with
exponential backoff on failure; a Manager tracks controllers by name and
exposes their status (used by ``cilium status``).

A whole copy of ``cilium_tpu/utils/controller.py``.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .backoff import Exponential
from .metrics import CONTROLLER_RUNS

# a controller at or past this many consecutive failures is surfaced
# as a top-level degraded signal in status() / `cilium-tpu status`
# (reference: pkg/controller's failing-controller status rollup)
FAILING_THRESHOLD = 3


@dataclass
class ControllerParams:
    """Reference: controller.go ControllerParams."""

    do_func: Callable[[], None]
    run_interval: float = 0.0        # 0 => run only on update/trigger
    error_retry_base: float = 0.05   # reference retries at 1s; scaled down
    stop_func: Optional[Callable[[], None]] = None


@dataclass
class ControllerStatus:
    success_count: int = 0
    failure_count: int = 0
    consecutive_failures: int = 0
    last_error: str = ""
    last_success: float = 0.0
    last_failure: float = 0.0


class Controller:
    """One background reconcile loop with retry."""

    def __init__(self, name: str, params: ControllerParams):
        self.name = name
        self.params = params
        self.status = ControllerStatus()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ctrl-{name}")
        self._thread.start()

    def trigger(self) -> None:
        """Run DoFunc as soon as possible (controller.go Update path)."""
        self._wake.set()

    def update(self, params: ControllerParams) -> None:
        with self._lock:
            self.params = params
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
        if self.params.stop_func:
            self.params.stop_func()

    def _run(self) -> None:
        backoff = Exponential(min_s=self.params.error_retry_base,
                              max_s=2.0, jitter=True)
        while not self._stop.is_set():
            with self._lock:
                params = self.params
            try:
                params.do_func()
                with self._lock:
                    self.status.success_count += 1
                    self.status.consecutive_failures = 0
                    self.status.last_error = ""
                    self.status.last_success = time.time()
                CONTROLLER_RUNS.inc(labels={"name": self.name,
                                            "status": "success"})
                backoff.reset()
                wait = params.run_interval if params.run_interval > 0 else None
            except Exception as exc:  # reconcile errors must not kill loop
                with self._lock:
                    self.status.failure_count += 1
                    self.status.consecutive_failures += 1
                    self.status.last_error = \
                        "".join(traceback.format_exception_only(
                            type(exc), exc)).strip()
                    self.status.last_failure = time.time()
                CONTROLLER_RUNS.inc(labels={"name": self.name,
                                            "status": "failure"})
                if self.status.consecutive_failures == \
                        FAILING_THRESHOLD:
                    # crossing the wedged threshold is an incident
                    # transition (the controller-health degraded
                    # signal); one event per wedge, not per retry
                    from ..observability.events import (
                        EVENT_CONTROLLER_FAILING, recorder)
                    recorder.record(
                        EVENT_CONTROLLER_FAILING,
                        detail=f"{self.name}: "
                               f"{self.status.last_error}",
                        consecutive=self.status.consecutive_failures)
                wait = backoff.next_duration()
            if wait is None:
                self._wake.wait()
            else:
                self._wake.wait(timeout=wait)
            self._wake.clear()


class ControllerManager:
    """Registry of named controllers (controller.go Manager).

    ``update_controller`` upserts: same-name registration replaces the
    params of the running loop rather than spawning a second one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._controllers: Dict[str, Controller] = {}

    def update_controller(self, name: str,
                          params: ControllerParams) -> Controller:
        with self._lock:
            ctrl = self._controllers.get(name)
            if ctrl is not None:
                ctrl.update(params)
                return ctrl
            ctrl = Controller(name, params)
            self._controllers[name] = ctrl
            return ctrl

    def remove_controller(self, name: str) -> bool:
        with self._lock:
            ctrl = self._controllers.pop(name, None)
        if ctrl is None:
            return False
        ctrl.stop()
        return True

    def remove_all(self) -> None:
        with self._lock:
            ctrls = list(self._controllers.values())
            self._controllers.clear()
        for c in ctrls:
            c.stop()

    def lookup(self, name: str) -> Optional[Controller]:
        with self._lock:
            return self._controllers.get(name)

    def status_model(self) -> List[Dict]:
        """Status dump for the REST/CLI status surface."""
        with self._lock:
            ctrls = dict(self._controllers)
        return [{
            "name": name,
            "success-count": c.status.success_count,
            "failure-count": c.status.failure_count,
            "consecutive-failure-count": c.status.consecutive_failures,
            "last-failure-msg": c.status.last_error,
        } for name, c in sorted(ctrls.items())]

    def failing(self, threshold: int = FAILING_THRESHOLD) -> List[Dict]:
        """Controllers at/past ``threshold`` consecutive failures —
        the top-level degraded signal for status() (a wedged reconcile
        loop must not stay buried in the controller list)."""
        with self._lock:
            ctrls = dict(self._controllers)
        out = []
        for name, c in sorted(ctrls.items()):
            with c._lock:
                n = c.status.consecutive_failures
                err = c.status.last_error
            if n >= threshold:
                out.append({"name": name, "consecutive-failures": n,
                            "last-error": err})
        return out
