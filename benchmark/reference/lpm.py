"""Longest-prefix match: one sorted key array per prefix length, longest
first; an address takes the value of the longest prefix that holds it."""

from __future__ import annotations

import ipaddress
from typing import Dict, Tuple

import torch

from .hashing import u32

MISS = -1


def _mask(plen: int) -> int:
    return 0 if plen == 0 else (0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF


class PrefixTable:
    """{cidr: value} (IPv4) on a device."""

    def __init__(self, prefixes: Dict[str, int], device="cpu"):
        by_len: Dict[int, Dict[int, int]] = {}
        for cidr, val in prefixes.items():
            net = ipaddress.ip_network(cidr, strict=False)
            # values as int32 bits (a node IP above 2^31 is negative)
            by_len.setdefault(net.prefixlen, {})[
                int(net.network_address) & _mask(net.prefixlen)] = \
                ((int(val) + (1 << 31)) % (1 << 32)) - (1 << 31)
        self.levels = []
        for plen in sorted(by_len, reverse=True):
            nets = sorted(by_len[plen])
            self.levels.append((
                _mask(plen),
                torch.tensor(nets, dtype=torch.int64, device=device),
                torch.tensor([by_len[plen][n] for n in nets],
                             dtype=torch.int64, device=device)))

    def __len__(self) -> int:
        return sum(keys.shape[0] for _, keys, _ in self.levels)

    def lookup(self, addrs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(found [B] bool, value [B] int32, MISS where not found) of
        int32 addresses (uint32 bits)."""
        a = u32(addrs)
        found = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        value = torch.full(a.shape, MISS, dtype=torch.int64,
                           device=a.device)
        for mask, keys, vals in self.levels:
            m = a & mask
            i = torch.searchsorted(keys, m).clamp(max=keys.shape[0] - 1)
            hit = (keys[i] == m) & ~found
            value = torch.where(hit, vals[i], value)
            found = found | hit
        return found, value.to(torch.int32)
