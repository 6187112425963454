"""Compile per-endpoint PolicyMapStates into stacked tables.

Copy of the part of ``cilium_tpu/compiler/policy_tables.py`` the
config-1 path and the L7 fast-verdict stage need.  Key layout (two uint32 words, matching
bpf/lib/common.h:180 policy_key):
    word A = identity (full 32 bits)
    word B = dport<<16 | proto<<8 | direction<<1 | 1
The trailing 1 bit guarantees word B != 0 for every real key, so 0 can
mark empty slots — including the legitimate wildcard key identity=0,
port=0, proto=0, dir=0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..datapath.codes import VERDICT_ALLOW, VERDICT_DROP
from ..policy.mapstate import PolicyKey, PolicyMapState
from .hashtab import HashTable, build_hash_table, stack_tables


def pack_key(key: PolicyKey) -> Tuple[int, int]:
    """PolicyKey -> (word_a, word_b)."""
    word_a = key.identity & 0xFFFFFFFF
    word_b = ((key.dest_port & 0xFFFF) << 16) | \
        ((key.nexthdr & 0xFF) << 8) | ((key.direction & 1) << 1) | 1
    return word_a, word_b


def pack_meta(dest_port, nexthdr, direction):
    """The meta word (word B).  Pure bit ops, so it works elementwise on
    Python ints and on int32 tensors (where ``<< 16`` wraps into the
    sign bit for ports >= 32768, as the reference's int32 does)."""
    return ((dest_port & 0xFFFF) << 16) | ((nexthdr & 0xFF) << 8) | \
        ((direction & 1) << 1) | 1


@dataclass
class CompiledPolicy:
    """Stacked per-endpoint exact-match verdict tables.

    The policymap analog: one logical table per endpoint slot, stacked
    into [E, S] arrays indexed by (endpoint_slot, hash_slot).
    """

    revision: int
    key_id: np.ndarray    # [E, S] int32 — identity word
    key_meta: np.ndarray  # [E, S] int32 — packed meta word (0 = empty)
    value: np.ndarray     # [E, S] int32 — proxy port
    max_probe: int
    num_endpoints: int
    slots: int

    def nbytes(self) -> int:
        return self.key_id.nbytes + self.key_meta.nbytes + self.value.nbytes

    def entry_count(self) -> int:
        return int((self.key_meta != 0).sum())


def compile_endpoints(map_states: Sequence[PolicyMapState],
                      revision: int,
                      slots: Optional[int] = None,
                      max_load: float = 0.5) -> CompiledPolicy:
    """Build the stacked tables for a list of endpoint map states.

    Deterministic for a given input; ``revision`` stamps the artifact so
    double-buffered device swaps can tell generations apart.
    """
    tables: List[HashTable] = []
    for state in map_states:
        entries = {pack_key(k): v.proxy_port for k, v in state.items()}
        tables.append(build_hash_table(entries, max_load=max_load))
    key_id, key_meta, value, max_probe = stack_tables(tables, slots=slots)
    e, s = key_id.shape if key_id.size else (0, 8)
    return CompiledPolicy(revision=revision, key_id=key_id,
                          key_meta=key_meta, value=value,
                          max_probe=max_probe, num_endpoints=e, slots=s)


def compile_l7_classification(value: np.ndarray,
                              port_to_prog: Dict[int, int]
                              ) -> np.ndarray:
    """The per-slot L7 fast-verdict classification table: the compiled
    value tensor (slot proxy ports; 0 = plain allow) mapped to fused DFA
    program ids.  ``-1`` keeps redirect-to-proxy; ``>= 0`` marks the
    slot first-bytes-decidable by that program.  ``port_to_prog`` comes
    from ``l7/fast.build_fast_programs``; int32, the value's shape."""
    out = np.full(value.shape, -1, np.int32)
    for port, prog in port_to_prog.items():
        if port > 0:
            out[value == port] = prog
    return out


def oracle_verdict(state: PolicyMapState, identity: int, dport: int,
                   proto: int, direction: int) -> int:
    """Scalar reference of the 3-stage datapath lookup
    (bpf/lib/policy.h:46-110 __policy_can_access): exact -> L3-only ->
    L4-wildcard -> drop. Returns VERDICT_DROP, VERDICT_ALLOW, or a
    proxy port."""
    exact = state.get(PolicyKey(identity=identity, dest_port=dport,
                                nexthdr=proto, direction=direction))
    if exact is not None:
        return exact.proxy_port  # 0 => allow, >0 => proxy redirect
    l3 = state.get(PolicyKey(identity=identity, direction=direction))
    if l3 is not None:
        return VERDICT_ALLOW  # L3-only hit never redirects (policy.h:83)
    l4 = state.get(PolicyKey(identity=0, dest_port=dport, nexthdr=proto,
                             direction=direction))
    if l4 is not None:
        return l4.proxy_port
    return VERDICT_DROP


def oracle_provenance(state: PolicyMapState, identity: int, dport: int,
                      proto: int, direction: int):
    """Provenance-extended scalar oracle: (verdict, decision tier,
    matched PolicyKey or None) with the same fallback chain as
    oracle_verdict and the tier semantics of the device path
    (datapath/verdict._policy_provenance) — an exact-stage hit whose
    query has dport==0 and proto==0 IS the L3-only key and reports as
    l3-allow.  The drift audit diffs the device replay against this."""
    # imported lazily: the compiler layer does not pull the datapath
    # package at import time (events itself is dependency-free)
    from ..datapath.events import (TIER_DENY, TIER_L3_ALLOW,
                                   TIER_L4_RULE, TIER_L7_REDIRECT)
    exact_key = PolicyKey(identity=identity, dest_port=dport,
                          nexthdr=proto, direction=direction)
    exact = state.get(exact_key)
    if exact is not None:
        if exact.proxy_port > 0:
            return exact.proxy_port, TIER_L7_REDIRECT, exact_key
        tier = TIER_L3_ALLOW if (dport == 0 and proto == 0) \
            else TIER_L4_RULE
        return exact.proxy_port, tier, exact_key
    l3_key = PolicyKey(identity=identity, direction=direction)
    if state.get(l3_key) is not None:
        return VERDICT_ALLOW, TIER_L3_ALLOW, l3_key
    l4_key = PolicyKey(identity=0, dest_port=dport, nexthdr=proto,
                       direction=direction)
    l4 = state.get(l4_key)
    if l4 is not None:
        tier = TIER_L7_REDIRECT if l4.proxy_port > 0 else TIER_L4_RULE
        return l4.proxy_port, tier, l4_key
    return VERDICT_DROP, TIER_DENY, None
