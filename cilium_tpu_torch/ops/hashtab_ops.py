"""Batched open-addressing hash lookup (device side), torch int32.

Port of ``cilium_tpu/ops/hashtab_ops.py``.  All arithmetic is int32:
uint32 multiply/add/xor are bit-identical under two's complement, and
the logical right shifts of the reference (``lax.shift_right_logical``)
become an arithmetic shift followed by a mask of the kept bits, since
torch's ``>>`` on int32 copies the sign bit.  The host builder
(``compiler.hashtab.hash_mix``, uint32 numpy) matches bit for bit.

Every gather index is in range by construction: probe slots are masked
to ``slots - 1`` and the row index must lie in ``[0, E)`` (torch raises
on an index out of range, where JAX would clamp it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# int32 bit-patterns of the uint32 mixing constants.
_C1 = int(np.array(0x9E3779B1, np.uint32).view(np.int32))
_C2 = int(np.array(0x85EBCA6B, np.uint32).view(np.int32))
_C3 = int(np.array(0xC2B2AE35, np.uint32).view(np.int32))


def _srl(h: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 by ``n``."""
    return (h >> n) & ((1 << (32 - n)) - 1)


def hash_mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 mix — bit-identical to compiler.hashtab.hash_mix (uint32)."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    h = a * _C1
    h = h ^ _srl(h, 15)
    h = h + b * _C2
    h = h ^ _srl(h, 13)
    h = h * _C3
    h = h ^ _srl(h, 16)
    return h


def fold6(words: torch.Tensor) -> torch.Tensor:
    """[B, 4] IPv6 address words -> [B] 32-bit mix: the v6 conntrack key
    and the v6 backend-selection hash take addresses folded this way."""
    return hash_mix(hash_mix(words[:, 0], words[:, 1]),
                    hash_mix(words[:, 2], words[:, 3]))


def batched_lookup(key_a: torch.Tensor, key_b: torch.Tensor,
                   value: torch.Tensor, q_a: torch.Tensor,
                   q_b: torch.Tensor, max_probe: int,
                   row: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe stacked tables for a batch of queries.

    key_a/key_b/value: [S] or [E, S] int32 table words (key_b==0: empty).
    q_a/q_b: [B] int32 query words. row: [B] table row index when tables
    are stacked (required iff tables are 2-D).

    Returns (found [B] bool, value [B] int32, flat_slot [B] int32) where
    flat_slot indexes the flattened [E*S] table (for counter scatter).
    """
    slots = key_a.shape[-1]
    mask = slots - 1
    flat_a = key_a.reshape(-1)
    flat_b = key_b.reshape(-1)
    flat_v = value.reshape(-1)

    base = hash_mix(q_a, q_b) & mask
    steps = torch.arange(max_probe, dtype=torch.int32, device=q_a.device)
    probes = (base[:, None] + steps[None, :]) & mask           # [B, K]
    if key_a.ndim == 2:
        flat_idx = row.to(torch.int32)[:, None] * slots + probes
    else:
        flat_idx = probes

    got_a = flat_a[flat_idx]
    got_b = flat_b[flat_idx]
    got_v = flat_v[flat_idx]
    hit = (got_a == q_a[:, None]) & (got_b == q_b[:, None]) & (got_b != 0)

    # Keys are unique per table => at most one probe hits; masked sums
    # select it.
    zero = torch.zeros((), dtype=torch.int32, device=q_a.device)
    val = torch.where(hit, got_v, zero).sum(dim=1, dtype=torch.int32)
    slot = torch.where(hit, flat_idx, zero).sum(dim=1, dtype=torch.int32)
    return hit.any(dim=1), val, slot
