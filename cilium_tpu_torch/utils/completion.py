"""Async acknowledgement barriers.

Reference: pkg/completion/completion.go — a WaitGroup hands out
Completions; ``Wait`` blocks until every Completion is ``Complete()``d or
the deadline passes. Used to block endpoint regeneration until the proxy
ACKs a policy update (pkg/envoy/server.go usage).

A whole copy of ``cilium_tpu/utils/completion.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional


class Completion:
    """One pending acknowledgement."""

    def __init__(self, on_complete: Optional[Callable[[], None]] = None):
        self._event = threading.Event()
        self._on_complete = on_complete
        self._lock = threading.Lock()

    def complete(self) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._event.set()
        if self._on_complete:
            self._on_complete()

    @property
    def completed(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class WaitGroup:
    """Collects Completions; Wait() = barrier (completion.go WaitGroup)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: List[Completion] = []

    def add_completion(self,
                       on_complete: Optional[Callable[[], None]] = None
                       ) -> Completion:
        c = Completion(on_complete)
        with self._lock:
            self._pending.append(c)
        return c

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True iff all completions finished within the deadline."""
        import time
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            pending = list(self._pending)
        for c in pending:
            remain = None if deadline is None else deadline - time.time()
            if remain is not None and remain <= 0:
                return False
            if not c.wait(remain):
                return False
        return True
