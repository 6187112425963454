"""Shared power-of-two batch-bucket selection.

Copy of ``cilium_tpu/utils/bucketing.py``.  The DFA engines round their
row and column counts up to a power-of-two bucket with a minimum floor
(``ops.dfa_ops.bucket_rows`` / ``bucket_cols``), so both packages walk
the same padded ``[B', L']`` block.
"""

from __future__ import annotations

MIN_ROWS = 16


def bucket_size(n: int, min_rows: int = MIN_ROWS) -> int:
    """max(min_rows, next_pow2(n)).  ``min_rows`` must be a power of
    two (a non-pow2 floor would mint a second bucket ladder)."""
    if min_rows <= 0 or min_rows & (min_rows - 1):
        raise ValueError(f"min_rows must be a power of two, got {min_rows}")
    rows = min_rows
    while rows < n:
        rows *= 2
    return rows
