"""LPM (longest-prefix-match) structures as per-prefix-length hash tables.

Copy of the IPv4 part of ``cilium_tpu/compiler/lpm.py``.  The
reference's ipcache LPM trie (bpf/lib/maps.h:135) becomes: for each
distinct prefix length, longest first, a masked exact-match lookup in a
hash table.  Arrays are stacked [P, S].
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hashtab import HashTable, build_hash_table

LPM_MISS = -1


def _mask32(plen: int) -> int:
    return 0 if plen == 0 else (0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF


@dataclass
class CompiledLPM:
    """Per-prefix-length masked lookup tables for IPv4.

    ``prefix_lens`` is sorted descending so the first hit during
    iteration is the longest match.
    """

    prefix_lens: np.ndarray  # [P] int32, descending
    masks: np.ndarray        # [P] int32 (uint32 view)
    key_a: np.ndarray        # [P, S] int32 — masked address word
    key_b: np.ndarray        # [P, S] int32 — plen<<1|1 (0 = empty)
    value: np.ndarray        # [P, S] int32 — payload (identity)
    max_probe: int
    slots: int

    def entry_count(self) -> int:
        return int((self.key_b != 0).sum())


def compile_lpm(prefixes: Dict[str, int],
                min_slots: int = 8) -> CompiledLPM:
    """{cidr_string: value} -> CompiledLPM (IPv4 only)."""
    by_len: Dict[int, Dict[Tuple[int, int], int]] = {}
    for cidr, val in prefixes.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            raise ValueError(f"compile_lpm is IPv4-only, got {cidr}")
        addr = int(net.network_address) & _mask32(net.prefixlen)
        by_len.setdefault(net.prefixlen, {})[
            (addr, (net.prefixlen << 1) | 1)] = val
    plens = sorted(by_len, reverse=True)
    tables: List[HashTable] = [
        build_hash_table(by_len[p], min_slots=min_slots) for p in plens]
    slots = max((t.slots for t in tables), default=8)
    max_probe = 1
    stacked_a, stacked_b, stacked_v = [], [], []
    for p, t in zip(plens, tables):
        if t.slots != slots:
            t = build_hash_table(by_len[p], min_slots=slots, max_load=1.0)
        stacked_a.append(t.key_a)
        stacked_b.append(t.key_b)
        stacked_v.append(t.value)
        max_probe = max(max_probe, t.max_probe)
    if not plens:
        return CompiledLPM(prefix_lens=np.zeros(0, np.int32),
                           masks=np.zeros(0, np.int32),
                           key_a=np.zeros((0, 8), np.int32),
                           key_b=np.zeros((0, 8), np.int32),
                           value=np.zeros((0, 8), np.int32),
                           max_probe=1, slots=8)
    return CompiledLPM(
        prefix_lens=np.asarray(plens, dtype=np.int32),
        masks=np.asarray([_mask32(p) for p in plens],
                         dtype=np.uint32).view(np.int32),
        key_a=np.stack(stacked_a), key_b=np.stack(stacked_b),
        value=np.stack(stacked_v), max_probe=max_probe, slots=slots)


def parse_prefixes(prefixes: Dict[str, int]
                   ) -> List[Tuple[int, int, int, int]]:
    """{cidr: value} -> [(network, netmask, prefix length, value)] for
    ``oracle_lpm_u32``: parse once, query many times."""
    out = []
    for cidr, val in prefixes.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 4:
            raise ValueError(f"the LPM oracle is IPv4-only, got {cidr}")
        out.append((int(net.network_address), _mask32(net.prefixlen),
                    net.prefixlen, val))
    return out


def oracle_lpm_u32(parsed: Sequence[Tuple[int, int, int, int]],
                   addr: int) -> int:
    """Scalar longest-prefix-match oracle over ``parse_prefixes``
    output: a linear scan, longest containing prefix wins."""
    best_len, best_val = -1, LPM_MISS
    for network, mask, plen, val in parsed:
        if (addr & mask) == network and plen > best_len:
            best_len, best_val = plen, val
    return best_val


def oracle_lpm(prefixes: Dict[str, int], ip: str) -> int:
    """Scalar longest-prefix-match oracle."""
    return oracle_lpm_u32(parse_prefixes(prefixes), ipv4_to_u32(ip))


def ipv4_to_u32(ip: str) -> int:
    return int(ipaddress.IPv4Address(ip))
