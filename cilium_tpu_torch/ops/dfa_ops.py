"""Batched DFA evaluation: byte-stream walk over stacked transition tables.

Port of ``cilium_tpu/ops/dfa_ops.py``.  ``dfa_scan`` advances [B, R] DFA
states over [B, L] payload bytes with one gather per byte position (the
reference's ``lax.scan`` over the length axis becomes a loop of L
dependent gathers, with no host read inside).  ``dfa_match`` is the
parity anchor of every other walker: int32 tables, one byte a step.
The L7 engines run on ``ops/dfa_engine.DFAEngine``; this module keeps the
host-encode helpers both tiers share (``encode_strings``,
``bucket_cols``, ``bucket_rows``).

Padding convention: byte -1 marks end-of-input and a row's states freeze
on any negative byte; a row holding -2 (overlong, poisoned by
``encode_strings``) never matches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.bucketing import bucket_size


def dfa_scan(table: torch.Tensor, states: torch.Tensor,
             data: torch.Tensor) -> torch.Tensor:
    """Advance DFA states over byte columns.

    table: [S, 256]; states: [B, R] int32 (current states); data: [B, L]
    int32 bytes in [0, 255], or negative for padding.  Returns the final
    states [B, R] in the table's dtype."""
    flat = table.reshape(-1)
    st = states
    for col in data.unbind(1):
        valid = col >= 0
        idx = st.to(torch.int64) * 256 + \
            torch.where(valid, col, 0).to(torch.int64)[:, None]
        st = torch.where(valid[:, None], flat[idx], st)
    return st


def start_states(starts: torch.Tensor, b: int) -> torch.Tensor:
    """[B, R] int32: every row starts each regex at its start state."""
    return starts[None, :].expand(b, starts.shape[0]).to(torch.int32)


def overlong_rows(data: torch.Tensor) -> torch.Tensor:
    """[B] bool: rows poisoned with -2 by ``encode_strings``."""
    return (data == -2).any(dim=1)


def dfa_match(table: torch.Tensor, accept: torch.Tensor,
              starts: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """One-shot anchored match of every regex against every row.

    data: [B, L] padded bytes.  Returns the accept mask [B, R] bool."""
    final = dfa_scan(table, start_states(starts, data.shape[0]), data)
    ok = accept[final.to(torch.int64)]
    return ok & ~overlong_rows(data)[:, None]


def encode_strings(strings, length: int) -> np.ndarray:
    """Host helper: pad byte strings to a [B, L] int32 block (-1 =
    padding; overlong rows poisoned with -2 so nothing matches)."""
    n = len(strings)
    raw = [s.encode() if isinstance(s, str) else bytes(s)
           for s in strings]
    clipped = [b[:length] for b in raw]
    lens = np.fromiter((len(b) for b in clipped), np.int64, count=n)
    out = np.full((n, length), -1, np.int32)
    if n:
        concat = np.frombuffer(b"".join(clipped), np.uint8)
        mask = np.arange(length)[None, :] < lens[:, None]
        out[mask] = concat
        overlong = np.fromiter((len(b) > length for b in raw),
                               bool, count=n)
        out[overlong] = -2
    return out


def device_dfa_tables(compiled, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(table int32, accept bool, starts int32) of a compiled regex set,
    uploaded once to ``device``."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.ascontiguousarray(compiled.table, np.int32),
                            device=dev),
            torch.as_tensor(np.asarray(compiled.accept, bool), device=dev),
            torch.as_tensor(np.asarray(compiled.starts, np.int32),
                            device=dev))


def bucket_cols(data: np.ndarray, min_cols: int = 16) -> np.ndarray:
    """Trim a [B, L] block to the power-of-two column count covering the
    longest real row.  The walk is sequential in L, so trimming a
    512-column block of 40-byte requests to 64 columns saves 448 steps;
    rows poisoned with -2 keep their poison in any column slice."""
    b, full = data.shape
    if b == 0 or full <= min_cols:
        return data
    used = np.nonzero((data >= 0).any(axis=0))[0]
    eff = int(used[-1]) + 1 if used.size else 1
    cols = bucket_size(eff, min_cols)
    if cols >= full:
        return data
    return np.ascontiguousarray(data[:, :cols])


def bucket_rows(data: np.ndarray, min_rows: int = 16) -> np.ndarray:
    """Pad a [B, L] block to the next power-of-two row count with -1
    rows (pure padding: their states freeze at the start, and callers
    slice the result back)."""
    b = data.shape[0]
    rows = bucket_size(b, min_rows)
    if rows == b:
        return data
    out = np.full((rows, data.shape[1]), -1, data.dtype)
    out[:b] = data
    return out
