"""Undo stacks for multi-step mutations.

Reference: pkg/revert/revert.go — RevertStack collects revert functions
pushed as each step of a compound operation succeeds; ``revert()`` runs
them in reverse order when a later step fails.

A whole copy of ``cilium_tpu/utils/revert.py``.
"""

from __future__ import annotations

from typing import Callable, List


class RevertStack:
    """LIFO stack of undo closures."""

    def __init__(self):
        self._funcs: List[Callable[[], None]] = []

    def push(self, fn: Callable[[], None]) -> None:
        self._funcs.append(fn)

    def revert(self) -> None:
        """Run all pushed functions, most recent first; first error wins
        but every function still runs (revert.go Revert)."""
        first_exc = None
        for fn in reversed(self._funcs):
            try:
                fn()
            except Exception as exc:
                if first_exc is None:
                    first_exc = exc
        self._funcs = []
        if first_exc is not None:
            raise first_exc

    def extend(self, other: "RevertStack") -> None:
        self._funcs.extend(other._funcs)

    def __len__(self):
        return len(self._funcs)
