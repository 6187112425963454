"""Batched longest-prefix-match lookup (device side), torch int32.

Port of the IPv4 ``lpm_lookup`` of ``cilium_tpu/ops/lpm_ops.py``: for
each of P distinct prefix lengths (descending), a masked exact-match
probe; the first (= longest) hit wins, selected by the same cumsum mask
(``hit & cumsum(hit) == 1``) as the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .hashtab_ops import hash_mix

LPM_MISS = -1


def lpm_lookup(masks: torch.Tensor, key_a: torch.Tensor,
               key_b: torch.Tensor, value: torch.Tensor,
               prefix_lens: torch.Tensor, addrs: torch.Tensor,
               max_probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """LPM over stacked per-length tables.

    masks: [P] int32; key_a/key_b/value: [P, S] int32; prefix_lens: [P]
    (descending); addrs: [B] int32 (uint32 addresses bit-cast).
    Returns (found [B] bool, value [B] int32 — LPM_MISS on miss).
    """
    p, slots = key_a.shape
    b = addrs.shape[0]
    dev = addrs.device
    if p == 0:
        return (torch.zeros(b, dtype=torch.bool, device=dev),
                torch.full((b,), LPM_MISS, dtype=torch.int32, device=dev))
    mask_slots = slots - 1

    masked = addrs.to(torch.int32)[:, None] & masks.to(torch.int32)[None, :]
    qb = ((prefix_lens.to(torch.int32) << 1) | 1)[None, :]        # [1, P]
    qb = qb.expand(b, p)                                           # [B, P]

    base = hash_mix(masked, qb) & mask_slots                       # [B, P]
    steps = torch.arange(max_probe, dtype=torch.int32, device=dev)
    probes = (base[:, :, None] + steps[None, None, :]) & mask_slots
    row_off = (torch.arange(p, dtype=torch.int32, device=dev)
               * slots)[None, :, None]
    flat_idx = row_off + probes                                    # [B,P,K]

    got_a = key_a.reshape(-1)[flat_idx]
    got_b = key_b.reshape(-1)[flat_idx]
    got_v = value.reshape(-1)[flat_idx]
    hit = (got_a == masked[:, :, None]) & (got_b == qb[:, :, None]) & \
        (got_b != 0)

    # Within one prefix-length table keys are unique: masked sum over K.
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    hit_per_len = hit.any(dim=2)                                   # [B, P]
    val_per_len = torch.where(hit, got_v, zero).sum(dim=2,
                                                    dtype=torch.int32)
    # Longest match = first hit in descending-length order.
    first = hit_per_len & (torch.cumsum(hit_per_len.to(torch.int32),
                                        dim=1) == 1)
    any_hit = hit_per_len.any(dim=1)
    val = torch.where(first, val_per_len, zero).sum(dim=1,
                                                    dtype=torch.int32)
    miss = torch.full((), LPM_MISS, dtype=torch.int32, device=dev)
    return any_hit, torch.where(any_hit, val, miss)
