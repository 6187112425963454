"""Batched longest-prefix-match lookup (device side), torch int32.

Port of ``cilium_tpu/ops/lpm_ops.py``: for each of P distinct prefix
lengths (descending), a masked exact-match probe; the first (= longest)
hit wins, selected by the same cumsum mask (``hit & cumsum(hit) == 1``)
as the reference.  ``lpm_lookup`` takes IPv4 addresses (one word),
``lpm6_lookup`` IPv6 addresses ([B, 4] big-endian words, all four
compared).  Each lookup is the span ``dp:lpm`` and its first-hit
select ``dp:lpm.select`` (``observability/stages.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..observability.stages import spanned
from .hashtab_ops import hash_mix

LPM_MISS = -1


@spanned("lpm")
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

    return _first_hit(hit, got_v)


@spanned("lpm.select")
def _first_hit(hit: torch.Tensor, got_v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found [B], value [B]) of the first prefix length that hits, from
    [B, P, K] hits and values (keys are unique within one length)."""
    zero = torch.zeros((), dtype=torch.int32, device=hit.device)
    hit_per_len = hit.any(dim=2)                                   # [B, P]
    val_per_len = torch.where(hit, got_v, zero).sum(dim=2,
                                                    dtype=torch.int32)
    first = hit_per_len & (torch.cumsum(hit_per_len.to(torch.int32),
                                        dim=1) == 1)
    any_hit = hit_per_len.any(dim=1)
    val = torch.where(first, val_per_len, zero).sum(dim=1,
                                                    dtype=torch.int32)
    miss = torch.full((), LPM_MISS, dtype=torch.int32, device=hit.device)
    return any_hit, torch.where(any_hit, val, miss)


def _hash6(w0, w1, w2, w3, occ):
    """Device twin of ``compiler.lpm._hash6``: keep in lockstep."""
    return hash_mix(hash_mix(w0, w1), hash_mix(w2 ^ occ, w3))


@spanned("lpm")
def lpm6_lookup(masks: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor,
                k2: torch.Tensor, k3: torch.Tensor, kb: torch.Tensor,
                value: torch.Tensor, prefix_lens: torch.Tensor,
                addrs: torch.Tensor, max_probe: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IPv6 LPM over stacked per-length tables (full 128-bit compare).

    masks: [P, 4]; k0..k3/kb/value: [P, S]; prefix_lens: [P]
    (descending); addrs: [B, 4] int32 big-endian words.
    Returns (found [B] bool, value [B] int32 — LPM_MISS on miss).
    """
    p, slots = kb.shape
    b = addrs.shape[0]
    dev = addrs.device
    if p == 0:
        return (torch.zeros(b, dtype=torch.bool, device=dev),
                torch.full((b,), LPM_MISS, dtype=torch.int32, device=dev))
    mask_slots = slots - 1
    a = addrs.to(torch.int32)
    m = masks.to(torch.int32)
    w = [a[:, None, i] & m[None, :, i] for i in range(4)]          # [B, P]
    occ = ((prefix_lens.to(torch.int32) << 1) | 1)[None, :].expand(b, p)

    base = _hash6(w[0], w[1], w[2], w[3], occ) & mask_slots        # [B, P]
    steps = torch.arange(max_probe, dtype=torch.int32, device=dev)
    probes = (base[:, :, None] + steps[None, None, :]) & mask_slots
    row_off = (torch.arange(p, dtype=torch.int32, device=dev)
               * slots)[None, :, None]
    flat_idx = row_off + probes                                    # [B,P,K]

    def gather(t):
        return t.reshape(-1)[flat_idx]

    got_b = gather(kb)
    hit = (gather(k0) == w[0][:, :, None]) & \
        (gather(k1) == w[1][:, :, None]) & \
        (gather(k2) == w[2][:, :, None]) & \
        (gather(k3) == w[3][:, :, None]) & \
        (got_b == occ[:, :, None]) & (got_b != 0)
    return _first_hit(hit, gather(value))
