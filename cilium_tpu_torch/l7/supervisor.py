"""Proxy process supervision (pkg/envoy/envoy.go:145).

The reference starts Envoy as a child process and restarts it when it
dies, in a monitor goroutine with backoff.  ProxySupervisor does the
same for the out-of-process socket proxy (l7/proxy_child.py): spawn,
wait, restart with exponential backoff; a restarted child re-subscribes
over the xDS wire and re-applies the current policy version, so the
plane self-heals after a crash or kill -9.

Port of ``cilium_tpu/l7/supervisor.py``: the child is the port's, started
with an explicit ``--device`` (default ``cuda``); the reference forces
its child onto the CPU.  ``shutdown`` kills the child and waits for the
monitor thread, so no child outlives it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Optional

from ..device import DeviceLike


class ProxySupervisor:
    """Spawn + monitor + restart one proxy child process."""

    def __init__(self, xds_port: int, backoff_base: float = 0.2,
                 backoff_max: float = 5.0,
                 env: Optional[dict] = None, device: DeviceLike = None):
        self.xds_port = xds_port
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.env = env
        self.device = "cuda" if device is None else str(device)
        self._proc: Optional[subprocess.Popen] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.restarts = 0
        self._monitor: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control

    def start(self) -> "ProxySupervisor":
        self._spawn()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="proxy-supervisor")
        self._monitor.start()
        return self

    def _spawn(self) -> None:
        env = dict(os.environ if self.env is None else self.env)
        proc = subprocess.Popen(
            [sys.executable, "-m", "cilium_tpu_torch.l7.proxy_child",
             str(self.xds_port), "--device", self.device],
            stdout=subprocess.PIPE, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        # block until the child says it subscribed (envoy.go waits for
        # the admin socket the same way)
        line = proc.stdout.readline()
        if not line.startswith("READY"):
            proc.kill()
            proc.wait()
            proc.stdout.close()
            raise RuntimeError(f"proxy child failed to start: {line!r}")
        with self._lock:
            self._proc = proc

    def _monitor_loop(self) -> None:
        backoff = self.backoff_base
        while not self._stop.is_set():
            with self._lock:
                proc = self._proc
            if proc is None:
                return
            proc.wait()
            if self._stop.is_set():
                return
            # child died (crash / kill -9): restart with backoff
            time.sleep(backoff)
            backoff = min(backoff * 2, self.backoff_max)
            if self._stop.is_set():
                return  # shutdown raced the backoff sleep: no respawn
            try:
                self._spawn()
                self.restarts += 1
                backoff = self.backoff_base
            except (RuntimeError, OSError):
                continue  # retry after a longer backoff
            if self._stop.is_set():
                # shutdown landed between its proc-kill and our spawn:
                # don't leave an orphan child running forever
                self._kill()
                return

    # ------------------------------------------------------------- status

    @property
    def pid(self) -> Optional[int]:
        with self._lock:
            return self._proc.pid if self._proc else None

    def alive(self) -> bool:
        with self._lock:
            return self._proc is not None and self._proc.poll() is None

    def _kill(self) -> None:
        with self._lock:
            proc = self._proc
            self._proc = None
        if proc is not None:
            try:
                proc.kill()
                proc.wait(timeout=5)
            except OSError:
                pass
            proc.stdout.close()

    def shutdown(self) -> None:
        self._stop.set()
        self._kill()
        monitor = self._monitor
        if monitor is not None and monitor is not threading.current_thread():
            # a spawn in flight finishes (its READY line or EOF), sees
            # the stop and kills what it started
            monitor.join(timeout=60)
            self._kill()
