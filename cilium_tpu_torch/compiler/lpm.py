"""LPM (longest-prefix-match) structures as per-prefix-length hash tables.

Copy of ``cilium_tpu/compiler/lpm.py``.  The reference's ipcache LPM
trie (bpf/lib/maps.h:135) becomes: for each distinct prefix length,
longest first, a masked exact-match lookup in a hash table.  Arrays are
stacked [P, S].  IPv4 addresses are one uint32 word (``CompiledLPM``);
IPv6 addresses are four big-endian uint32 words compared in full
(``CompiledLPM6``), no folding.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .hashtab import HashTable, build_hash_table, hash_mix

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


# ---------------------------------------------------------------------------
# IPv6: 128-bit addresses as four uint32 words
# ---------------------------------------------------------------------------

def ipv6_to_words(ip: str) -> Tuple[int, int, int, int]:
    """Big-endian uint32 words (w0 = most significant)."""
    v = int(ipaddress.IPv6Address(ip))
    return ((v >> 96) & 0xFFFFFFFF, (v >> 64) & 0xFFFFFFFF,
            (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF)


def _mask128_words(plen: int) -> Tuple[int, int, int, int]:
    m = 0 if plen == 0 else \
        (((1 << plen) - 1) << (128 - plen)) & ((1 << 128) - 1)
    return ((m >> 96) & 0xFFFFFFFF, (m >> 64) & 0xFFFFFFFF,
            (m >> 32) & 0xFFFFFFFF, m & 0xFFFFFFFF)


def _u32s_to_i32(arr) -> np.ndarray:
    return np.asarray(arr, np.uint32).view(np.int32)


@dataclass
class CompiledLPM6:
    """Stacked per-prefix-length tables for IPv6 (descending lengths).

    k0..k3: [P, S] masked address words; kb: [P, S] occupancy word
    (plen<<1|1, 0 = empty); value: [P, S] payload; masks: [P, 4]."""

    prefix_lens: np.ndarray  # [P] int32, descending
    masks: np.ndarray        # [P, 4] int32
    k0: np.ndarray
    k1: np.ndarray
    k2: np.ndarray
    k3: np.ndarray
    kb: np.ndarray
    value: np.ndarray
    max_probe: int
    slots: int

    def entry_count(self) -> int:
        return int((self.kb != 0).sum())


def _hash6(w0, w1, w2, w3, occ):
    """Host twin of ``ops.lpm_ops._hash6``: keep in lockstep."""
    return hash_mix(hash_mix(np.uint32(w0), np.uint32(w1)),
                    hash_mix(np.uint32(w2) ^ np.uint32(occ),
                             np.uint32(w3)))


def compile_lpm6(prefixes: Dict[str, int],
                 min_slots: int = 8) -> CompiledLPM6:
    """{v6_cidr: value} -> CompiledLPM6."""
    by_len: Dict[int, Dict[Tuple[int, int, int, int], int]] = {}
    for cidr, val in prefixes.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 6:
            raise ValueError(f"compile_lpm6 is IPv6-only, got {cidr}")
        mw = _mask128_words(net.prefixlen)
        aw = ipv6_to_words(str(net.network_address))
        key = tuple(a & m for a, m in zip(aw, mw))
        by_len.setdefault(net.prefixlen, {})[key] = val
    plens = sorted(by_len, reverse=True)
    if not plens:
        z = lambda: np.zeros((0, 8), np.int32)  # noqa: E731
        return CompiledLPM6(prefix_lens=np.zeros(0, np.int32),
                            masks=np.zeros((0, 4), np.int32),
                            k0=z(), k1=z(), k2=z(), k3=z(), kb=z(),
                            value=z(), max_probe=1, slots=8)
    # every per-length table gets the same power-of-two slot count
    n_max = max(len(by_len[p]) for p in plens)
    slots = min_slots
    while slots < 2 * n_max:
        slots *= 2
    max_probe = 1
    n_len = len(plens)
    k0, k1, k2, k3, kb, value = (np.zeros((n_len, slots), np.int32)
                                 for _ in range(6))
    for i, p in enumerate(plens):
        occ = (p << 1) | 1
        for (w0, w1, w2, w3), val in by_len[p].items():
            h = int(_hash6(w0, w1, w2, w3, occ)) & (slots - 1)
            probe = 0
            while kb[i, (h + probe) % slots] != 0:
                probe += 1
                if probe >= slots:
                    raise RuntimeError("lpm6 table overflow")
            s = (h + probe) % slots
            k0[i, s] = np.uint32(w0).view(np.int32)
            k1[i, s] = np.uint32(w1).view(np.int32)
            k2[i, s] = np.uint32(w2).view(np.int32)
            k3[i, s] = np.uint32(w3).view(np.int32)
            kb[i, s] = occ
            value[i, s] = np.int32(val)
            max_probe = max(max_probe, probe + 1)
    masks = np.stack([_u32s_to_i32(_mask128_words(p)) for p in plens])
    return CompiledLPM6(
        prefix_lens=np.asarray(plens, np.int32), masks=masks,
        k0=k0, k1=k1, k2=k2, k3=k3, kb=kb, value=value,
        max_probe=max_probe, slots=slots)


def ipv6_batch_words(ips: Sequence[str]) -> np.ndarray:
    """[B, 4] int32 word array from v6 address strings."""
    return _u32s_to_i32([ipv6_to_words(ip) for ip in ips])


def oracle_lpm6(prefixes: Dict[str, int], words: Sequence[int]) -> int:
    """Scalar IPv6 longest-prefix-match oracle for one address given as
    four uint32 words (or their int32 bits): a linear scan."""
    addr = 0
    for w in words:
        addr = (addr << 32) | (int(w) & 0xFFFFFFFF)
    best_len, best_val = -1, LPM_MISS
    for cidr, val in prefixes.items():
        net = ipaddress.ip_network(cidr, strict=False)
        if net.version != 6:
            raise ValueError(f"oracle_lpm6 is IPv6-only, got {cidr}")
        shift = 128 - net.prefixlen
        if (addr >> shift) == (int(net.network_address) >> shift) and \
                net.prefixlen > best_len:
            best_len, best_val = net.prefixlen, val
    return best_val
