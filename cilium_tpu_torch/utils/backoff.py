"""Exponential backoff with jitter.

Reference: pkg/backoff/backoff.go — Exponential{Min,Max,Factor,Jitter};
``Wait`` sleeps for the current duration and doubles (bounded).

A whole copy of ``cilium_tpu/utils/backoff.py``.
"""

from __future__ import annotations

import random
import threading


class Exponential:
    """Exponential backoff calculator; ``wait`` blocks (interruptible)."""

    def __init__(self, min_s: float = 1.0, max_s: float = 0.0,
                 factor: float = 2.0, jitter: bool = False):
        self.min_s = min_s
        self.max_s = max_s  # 0 => unbounded
        self.factor = factor
        self.jitter = jitter
        self.attempt = 0

    def reset(self) -> None:
        self.attempt = 0

    def duration(self, attempt: int) -> float:
        d = self.min_s * (self.factor ** attempt)
        if self.max_s > 0:
            d = min(d, self.max_s)
        if self.jitter:
            d *= random.uniform(0.5, 1.5)
            if self.max_s > 0:
                d = min(d, self.max_s)
        return d

    def next_duration(self) -> float:
        d = self.duration(self.attempt)
        self.attempt += 1
        return d

    def wait(self, stop_event: threading.Event = None) -> bool:
        """Sleep the next backoff duration. Returns False if interrupted
        by ``stop_event`` (the analog of context cancellation)."""
        d = self.next_duration()
        if stop_event is None:
            ev = threading.Event()
            ev.wait(d)
            return True
        return not stop_event.wait(d)
