"""Duration accounting for success/failure outcomes.

A whole copy of ``cilium_tpu/utils/spanstat.py``.

Reference: pkg/spanstat/spanstat.go — measure spans of work, keeping
separate totals for spans that ended in success vs failure. Used to time
endpoint-regeneration stages (pkg/endpoint/policy.go:667-678).
"""

from __future__ import annotations

import time
from typing import Optional


class SpanStat:
    """Measure consecutive spans; accumulate success/failure totals."""

    def __init__(self):
        self.success_total = 0.0
        self.failure_total = 0.0
        self.num_success = 0
        self.num_failure = 0
        self._span_start: Optional[float] = None

    def start(self) -> "SpanStat":
        self._span_start = time.perf_counter()
        return self

    def end(self, success: bool = True) -> "SpanStat":
        if self._span_start is not None:
            d = time.perf_counter() - self._span_start
            if success:
                self.success_total += d
                self.num_success += 1
            else:
                self.failure_total += d
                self.num_failure += 1
        self._span_start = None
        return self

    def seconds(self) -> float:
        return self.success_total + self.failure_total

    def reset(self) -> None:
        self.success_total = self.failure_total = 0.0
        self.num_success = self.num_failure = 0
        self._span_start = None

    # context-manager sugar: success unless an exception escapes
    def __enter__(self) -> "SpanStat":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(success=exc_type is None)

    def __repr__(self):
        return (f"SpanStat(ok={self.success_total:.6f}s/{self.num_success}, "
                f"fail={self.failure_total:.6f}s/{self.num_failure})")
