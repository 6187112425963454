"""Incremental internet checksum updates for NAT rewrites.

Reference: bpf/lib/csum.h — after the datapath rewrites addresses or
ports (LB DNAT, rev-NAT, NAT46), the L3/L4 checksums are fixed
incrementally (csum_l4_replace over csum_diff) rather than recomputed
over the payload.  Same here, batched: given the old and new values of
the rewritten fields, produce the updated checksum per packet
(RFC 1624 eqn. 3: HC' = ~(~HC + ~m + m')).

Port of ``cilium_tpu/datapath/csum.py`` in plain torch.  Values are
uint16/uint32 carried in int32 lanes, like the rest of the datapath;
every right shift is logical (``hashtab_ops._srl``), so an address with
its sign bit set splits into the same halves as in uint32.
"""

from __future__ import annotations

import torch

from ..ops.hashtab_ops import _srl


def _ones_fold(x: torch.Tensor) -> torch.Tensor:
    """Fold a 32-bit sum to 16 bits (ones-complement carry wrap)."""
    x = (x & 0xFFFF) + (_srl(x, 16) & 0xFFFF)
    x = (x & 0xFFFF) + (_srl(x, 16) & 0xFFFF)
    return x & 0xFFFF


def csum_update_u16(csum: torch.Tensor, old: torch.Tensor,
                    new: torch.Tensor) -> torch.Tensor:
    """RFC 1624 incremental update for one 16-bit field.

    csum/old/new: [B] int32 holding u16 values; returns [B] u16."""
    c = (~csum.to(torch.int32)) & 0xFFFF
    c = c + ((~old.to(torch.int32)) & 0xFFFF) + (new.to(torch.int32)
                                                   & 0xFFFF)
    return (~_ones_fold(c)) & 0xFFFF


def csum_update_u32(csum: torch.Tensor, old: torch.Tensor,
                    new: torch.Tensor) -> torch.Tensor:
    """Incremental update for a 32-bit field (an address): applied as
    its two 16-bit halves (csum_diff over 4 bytes)."""
    old = old.to(torch.int32)
    new = new.to(torch.int32)
    c = csum_update_u16(csum, _srl(old, 16), _srl(new, 16))
    return csum_update_u16(c, old & 0xFFFF, new & 0xFFFF)


def checksum16(words: torch.Tensor) -> torch.Tensor:
    """Full ones-complement checksum over [B, N] u16 words — the
    from-scratch reference the incremental path is tested against.
    int32-safe for N < 2^15 words (far beyond any header)."""
    s = (words.to(torch.int32) & 0xFFFF).sum(dim=1, dtype=torch.int32)
    s = (s & 0xFFFF) + _srl(s, 16)
    s = (s & 0xFFFF) + _srl(s, 16)
    return (~s) & 0xFFFF


def nat_csum_fix(l4_csum: torch.Tensor, old_addr: torch.Tensor,
                 new_addr: torch.Tensor, old_port: torch.Tensor,
                 new_port: torch.Tensor,
                 udp: bool = False) -> torch.Tensor:
    """The DNAT fix-up (lb4 path): TCP/UDP checksums cover the
    pseudo-header, so an address+port rewrite updates both.

    ``udp=True`` applies the full BPF_F_MARK_MANGLED_0 rule
    (bpf_l4_csum_replace): an INCOMING checksum of 0x0000 means "no
    checksum computed" for v4 UDP and is left untouched (updating it
    would fabricate a bogus checksum the receiver then validates), and
    a COMPUTED result of 0x0000 is transmitted as 0xFFFF (zero is the
    no-checksum marker / forbidden for v6)."""
    c = csum_update_u32(l4_csum, old_addr, new_addr)
    c = csum_update_u16(c, old_port, new_port)
    if udp:
        c = torch.where(c == 0, torch.full_like(c, 0xFFFF), c)
        c = torch.where(l4_csum == 0, torch.zeros_like(c), c)
    return c
