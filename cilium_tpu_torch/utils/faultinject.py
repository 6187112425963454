"""Device-lane fault injection: the chaos hand of the serving supervisor.

Copy of ``DeviceLaneFault`` and ``DeviceFaultInjector`` from
``cilium_tpu/utils/faultinject.py``.  The supervisor
(``datapath/supervisor.py``) consults the injector around every launch
and finalize, so a test can raise on the Nth dispatch, hang a finalize
past the watchdog deadline, or run transient-then-heal scripts against
the real dispatcher loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class DeviceLaneFault(RuntimeError):
    """An injected (or classified) device-lane failure.  ``fatal``
    steers the supervisor's breaker: fatal trips it immediately,
    transient counts toward the consecutive-failure threshold."""

    def __init__(self, msg: str = "injected device fault",
                 fatal: bool = False):
        super().__init__(msg)
        self.fatal = fatal


class DeviceFaultInjector:
    """Scriptable device-lane fault hook.

    Install via ``DeviceSupervisor.install_fault_hook(injector)``; the
    supervisor then calls :meth:`on_launch` before every device launch
    and :meth:`on_finalize` inside the watchdogged finalize worker.
    Each armed step fires once per matching call, in order:

    - ``fail_launch(times, fatal)`` — raise DeviceLaneFault on the
      next ``times`` launches;
    - ``fail_finalize(times, fatal)`` — same, at finalize;
    - ``hang_finalize(seconds, times)`` — sleep inside finalize so the
      supervisor's watchdog deadline fires (the hung ``complete`` sync
      of a wedged device path);
    - ``script([...])`` — explicit (stage, action, arg) sequences for
      transient-then-heal choreography;
    - ``heal()`` — disarm everything.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._launch: deque = deque()    # ("raise", fatal)
        self._finalize: deque = deque()  # ("raise", fatal)|("hang", s)
        self.launches = 0
        self.finalizes = 0
        self.injected = 0

    # ------------------------------------------------------- arming

    def fail_launch(self, times: int = 1, fatal: bool = False,
                    msg: str = "injected launch fault") -> None:
        with self._mu:
            for _ in range(times):
                self._launch.append(("raise", fatal, msg))

    def fail_finalize(self, times: int = 1, fatal: bool = False,
                      msg: str = "injected finalize fault") -> None:
        with self._mu:
            for _ in range(times):
                self._finalize.append(("raise", fatal, msg))

    def hang_finalize(self, seconds: float, times: int = 1) -> None:
        with self._mu:
            for _ in range(times):
                self._finalize.append(("hang", seconds, "hang"))

    def script(self, steps) -> None:
        """Explicit choreography: steps are ("launch"|"finalize",
        "raise"|"hang"|"ok", arg) — "ok" consumes one call without
        injecting (spacing for transient-then-heal sequences)."""
        with self._mu:
            for stage, action, arg in steps:
                q = self._launch if stage == "launch" else self._finalize
                q.append((action, arg, f"scripted {action}"))

    def heal(self) -> None:
        with self._mu:
            self._launch.clear()
            self._finalize.clear()

    @property
    def armed(self) -> bool:
        with self._mu:
            return bool(self._launch or self._finalize)

    # ------------------------------------------- supervisor hook API

    def on_launch(self) -> None:
        with self._mu:
            self.launches += 1
            step = self._launch.popleft() if self._launch else None
        self._apply(step)

    def on_finalize(self) -> None:
        with self._mu:
            self.finalizes += 1
            step = self._finalize.popleft() if self._finalize else None
        self._apply(step)

    def _apply(self, step) -> None:
        if step is None:
            return
        action, arg, msg = step
        if action == "ok":
            return
        self.injected += 1
        if action == "hang":
            time.sleep(float(arg))
            return
        raise DeviceLaneFault(msg, fatal=bool(arg))
