"""Open-addressing hash tables as dense tensors.

Copy of ``cilium_tpu/compiler/hashtab.py``. The datapath replaces the
reference's in-kernel BPF hash maps (bpf/lib/maps.h) with linear-probed
open-addressing tables laid out as flat arrays, so a batched lookup is K
gathers. The host builds tables in numpy; the device lookup
(``cilium_tpu_torch.ops.hashtab_ops``) reimplements the identical hash in
torch int32. Keys are pairs of uint32 words; a key is "present" iff its
meta word is non-zero (builders must guarantee meta != 0 for real keys).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# Multiplicative-mix constants (splitmix/murmur finalizer family).
_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA6B)
_C3 = np.uint32(0xC2B2AE35)


def hash_mix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mix two uint32 words into a uint32 hash. Must stay in lockstep with
    cilium_tpu_torch.ops.hashtab_ops.hash_mix (device version)."""
    with np.errstate(over="ignore"):  # uint32 wrap-around is the point
        a = a.astype(np.uint32)
        b = b.astype(np.uint32)
        h = a * _C1
        h ^= h >> np.uint32(15)
        h = h + b * _C2
        h ^= h >> np.uint32(13)
        h = h * _C3
        h ^= h >> np.uint32(16)
    return h


@dataclass
class HashTable:
    """A built table: parallel arrays + probe bound.

    ``key_a``/``key_b`` are the two key words (int32 views of uint32),
    ``value`` an int32 payload, ``max_probe`` the worst-case probe chain
    length observed at build time (the device kernel probes exactly this
    many slots, statically unrolled/scanned).
    """

    key_a: np.ndarray  # [S] int32
    key_b: np.ndarray  # [S] int32 (0 == empty slot)
    value: np.ndarray  # [S] int32
    max_probe: int
    slots: int

    @property
    def load(self) -> float:
        return float((self.key_b != 0).sum()) / self.slots


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def build_hash_table(entries: Dict[Tuple[int, int], int],
                     min_slots: int = 8,
                     max_load: float = 0.5) -> HashTable:
    """Build a linear-probed table from {(key_a, key_b): value}.

    key_b must be non-zero for every entry (0 marks empty slots).
    Deterministic: same entries -> same table.
    """
    for (_, kb) in entries:
        if kb == 0:
            raise ValueError("key_b == 0 is reserved for empty slots")
    n = len(entries)
    slots = _next_pow2(max(min_slots, int(n / max_load) + 1))
    key_a = np.zeros(slots, dtype=np.uint32)
    key_b = np.zeros(slots, dtype=np.uint32)
    value = np.zeros(slots, dtype=np.int32)
    mask = np.uint32(slots - 1)
    max_probe = 1
    # Sorted insertion order => deterministic layout.
    for (ka, kb), v in sorted(entries.items()):
        ka_u, kb_u = np.uint32(ka & 0xFFFFFFFF), np.uint32(kb & 0xFFFFFFFF)
        h = hash_mix(np.asarray(ka_u), np.asarray(kb_u)) & mask
        probe = 0
        while True:
            slot = int((h + np.uint32(probe)) & mask)
            if key_b[slot] == 0:
                key_a[slot] = ka_u
                key_b[slot] = kb_u
                value[slot] = np.int32(v)
                max_probe = max(max_probe, probe + 1)
                break
            probe += 1
            if probe >= slots:
                raise RuntimeError("hash table full")
    return HashTable(key_a=key_a.view(np.int32), key_b=key_b.view(np.int32),
                     value=value, max_probe=max_probe, slots=slots)


def stack_tables(tables: List[HashTable],
                 slots: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray,
                                                       np.ndarray, int]:
    """Stack per-endpoint tables into [E, S] arrays with a common S and a
    common probe bound. Tables smaller than S are re-built at S so probe
    positions stay valid."""
    if not tables:
        return (np.zeros((0, 8), np.int32), np.zeros((0, 8), np.int32),
                np.zeros((0, 8), np.int32), 1)
    s = slots or max(t.slots for t in tables)
    out_a, out_b, out_v, max_probe = [], [], [], 1
    for t in tables:
        if t.slots != s:
            entries = {
                (int(np.uint32(t.key_a.view(np.uint32)[i])),
                 int(np.uint32(t.key_b.view(np.uint32)[i]))): int(t.value[i])
                for i in range(t.slots) if t.key_b.view(np.uint32)[i] != 0}
            t = build_hash_table(entries, min_slots=s, max_load=1.0)
            assert t.slots == s, (t.slots, s)
        out_a.append(t.key_a)
        out_b.append(t.key_b)
        out_v.append(t.value)
        max_probe = max(max_probe, t.max_probe)
    return (np.stack(out_a), np.stack(out_b), np.stack(out_v), max_probe)
