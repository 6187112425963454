"""The policy verdict engine: batched 3-stage lookup + counters (torch).

Port of ``cilium_tpu/datapath/verdict.py``.  Implements the fallback
chain of the reference's per-packet hot loop (bpf/lib/policy.h:46-110
__policy_can_access):

  1. exact      (identity, dport, proto, dir)  -> allow / proxy_port
  2. L3-only    (identity, 0,     0,     dir)  -> allow (never redirects)
  3. L4-wildcard(0,        dport, proto, dir)  -> allow / proxy_port
  else drop (fragments that can't be L4-matched drop with FRAG code).

Counters are uint32 in the reference.  Torch has no ``index_add_`` for
uint32, so the port holds them as int32 that wraps at 2**32: the same
bits, read back through ``.numpy().view(np.uint32)``.  The port runs
eagerly and adds into the counters in place, where JAX rebinds them.
``verdict_step`` is the span ``dp:policy`` (``observability/stages.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compiler.policy_tables import CompiledPolicy, pack_meta
from ..device import DeviceLike, resolve_device
from ..observability.stages import spanned
from ..ops.hashtab_ops import batched_lookup
from .codes import VERDICT_ALLOW, VERDICT_DROP, VERDICT_DROP_FRAG
from .events import (TIER_DENY, TIER_L3_ALLOW, TIER_L4_RULE,
                     TIER_L7_REDIRECT)


class PacketBatch(NamedTuple):
    """Packet-header metadata tensor batch, all [B] int32."""

    endpoint: torch.Tensor   # endpoint slot index, in [0, E)
    identity: torch.Tensor   # remote security identity
    dport: torch.Tensor      # destination port (host order)
    proto: torch.Tensor      # u8 next-header protocol
    direction: torch.Tensor  # 0 ingress / 1 egress
    length: torch.Tensor     # packet bytes (for counters)
    is_fragment: torch.Tensor  # int32 0/1


class Counters(NamedTuple):
    packets: torch.Tensor  # [E*S] int32, wrapping (uint32 bits)
    bytes: torch.Tensor    # [E*S] int32, wrapping (uint32 bits)


class Provenance(NamedTuple):
    """Per-packet verdict provenance (both [B] int32): the flat slot of
    the matched policymap entry in the stacked [E*S] tables (-1 = no
    entry decided), and the decision-tier code (``events.TIER_*``)."""

    match_slot: torch.Tensor
    tier: torch.Tensor


def _stage_lookups(key_id, key_meta, value, pkt: PacketBatch,
                   max_probe: int):
    """The 3-stage fallback chain's lookups (policy.h:46-110), with
    fragment gating applied: fragments can't be matched at L4
    (policy.h:60,99), so only the L3 stage applies to them."""
    frag = pkt.is_fragment != 0
    meta_exact = pack_meta(pkt.dport, pkt.proto, pkt.direction)
    meta_l3 = pack_meta(torch.zeros_like(pkt.dport),
                        torch.zeros_like(pkt.proto), pkt.direction)
    zero_id = torch.zeros_like(pkt.identity)

    f1, v1, s1 = batched_lookup(key_id, key_meta, value, pkt.identity,
                                meta_exact, max_probe, row=pkt.endpoint)
    f2, v2, s2 = batched_lookup(key_id, key_meta, value, pkt.identity,
                                meta_l3, max_probe, row=pkt.endpoint)
    f3, v3, s3 = batched_lookup(key_id, key_meta, value, zero_id,
                                meta_exact, max_probe, row=pkt.endpoint)
    f1 = f1 & ~frag
    f3 = f3 & ~frag
    return frag, (f1, v1, s1), (f2, v2, s2), (f3, v3, s3)


def _policy_provenance(pkt: PacketBatch, f1, v1, s1, f2, s2, f3, v3,
                       s3) -> Provenance:
    """Matched slot + decision tier from the stage outcomes.  An
    exact-stage hit whose query has dport == 0 and proto == 0 is the
    L3-only key (identical packed words), so it reports as l3-allow."""
    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=v1.device)
    exact_is_l3 = (pkt.dport == 0) & (pkt.proto == 0)
    tier1 = torch.where(v1 > 0, i32(TIER_L7_REDIRECT),
                        torch.where(exact_is_l3, i32(TIER_L3_ALLOW),
                                    i32(TIER_L4_RULE)))
    tier3 = torch.where(v3 > 0, i32(TIER_L7_REDIRECT), i32(TIER_L4_RULE))
    tier = torch.where(f1, tier1,
                       torch.where(f2, i32(TIER_L3_ALLOW),
                                   torch.where(f3, tier3, i32(TIER_DENY))))
    slot = torch.where(f1 | f2 | f3,
                       torch.where(f1, s1, torch.where(f2, s2, s3)),
                       i32(-1))
    return Provenance(match_slot=slot, tier=tier)


@spanned("policy")
def verdict_step(key_id: torch.Tensor, key_meta: torch.Tensor,
                 value: torch.Tensor, counters: Counters,
                 pkt: PacketBatch, max_probe: int,
                 count_mask: Optional[torch.Tensor] = None,
                 with_provenance: bool = False):
    """Batched verdict; adds into ``counters`` in place and returns
    (verdict, counters), or (verdict, counters, match_slot, tier) with
    ``with_provenance``.

    ``count_mask`` (bool [B]) excludes rows from the per-entry
    packet/byte counters without changing their verdicts."""
    frag, (f1, v1, s1), (f2, v2, s2), (f3, v3, s3) = _stage_lookups(
        key_id, key_meta, value, pkt, max_probe)

    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=v1.device)
    verdict = torch.where(
        f1, v1,
        torch.where(f2, i32(VERDICT_ALLOW),
                    torch.where(f3, v3,
                                torch.where(frag, i32(VERDICT_DROP_FRAG),
                                            i32(VERDICT_DROP)))))

    hit = f1 | f2 | f3
    hit_slot = torch.where(f1, s1, torch.where(f2, s2, s3))
    # Per-entry counters (policy.h:67-101 packets/bytes adds). Misses
    # add weight 0 at the stage-3 slot (0 on a miss): a no-op.
    counted = hit if count_mask is None else (hit & count_mask)
    inc_p = counted.to(torch.int32)
    inc_b = torch.where(counted, pkt.length.to(torch.int32), i32(0))
    counters.packets.index_add_(0, hit_slot, inc_p)
    counters.bytes.index_add_(0, hit_slot, inc_b)
    if with_provenance:
        prov = _policy_provenance(pkt, f1, v1, s1, f2, s2, f3, v3, s3)
        return verdict, counters, prov.match_slot, prov.tier
    return verdict, counters


def verdict_explain(key_id: torch.Tensor, key_meta: torch.Tensor,
                    value: torch.Tensor, pkt: PacketBatch,
                    max_probe: int) -> Dict:
    """Replay-grade breakdown: every stage's outcome plus the final
    verdict/tier/slot, over the same ``_stage_lookups`` the hot path
    runs (bit-exact by construction).  No counter writes; the entry of
    ``engine.Datapath.policy_replay``."""
    frag, (f1, v1, s1), (f2, v2, s2), (f3, v3, s3) = _stage_lookups(
        key_id, key_meta, value, pkt, max_probe)
    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=v1.device)
    verdict = torch.where(
        f1, v1,
        torch.where(f2, i32(VERDICT_ALLOW),
                    torch.where(f3, v3,
                                torch.where(frag, i32(VERDICT_DROP_FRAG),
                                            i32(VERDICT_DROP)))))
    prov = _policy_provenance(pkt, f1, v1, s1, f2, s2, f3, v3, s3)
    return {
        "verdict": verdict, "tier": prov.tier, "slot": prov.match_slot,
        "exact": {"found": f1, "value": v1, "slot": s1},
        "l3": {"found": f2, "value": v2, "slot": s2},
        "l4_wildcard": {"found": f3, "value": v3, "slot": s3},
    }


class VerdictEngine:
    """Holds one compiled-policy generation on the device + its counters.

    A policy swap builds a new engine from the next CompiledPolicy
    revision and replaces the reference.
    """

    def __init__(self, compiled: CompiledPolicy, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.revision = compiled.revision
        self.max_probe = compiled.max_probe
        self.slots = compiled.slots
        self.num_endpoints = compiled.num_endpoints
        put = lambda x: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(x, np.int32), device=self.device)
        self.key_id = put(compiled.key_id)
        self.key_meta = put(compiled.key_meta)
        self.value = put(compiled.value)
        n = max(1, compiled.num_endpoints * compiled.slots)
        self.counters = Counters(
            packets=torch.zeros(n, dtype=torch.int32, device=self.device),
            bytes=torch.zeros(n, dtype=torch.int32, device=self.device))

    def __call__(self, pkt: PacketBatch) -> torch.Tensor:
        verdict, self.counters = verdict_step(
            self.key_id, self.key_meta, self.value, self.counters, pkt,
            self.max_probe)
        return verdict

    def counter_for(self, endpoint: int, slot: int) -> Tuple[int, int]:
        """(packets, bytes) of one table slot, as uint32."""
        flat = endpoint * self.slots + slot
        u32 = lambda x: int(x) & 0xFFFFFFFF  # noqa: E731
        return (u32(self.counters.packets[flat]),
                u32(self.counters.bytes[flat]))


def make_packet_batch(endpoint, identity, dport, proto, direction,
                      length=None, is_fragment=None,
                      device: DeviceLike = None) -> PacketBatch:
    """Convenience constructor from numpy/int lists."""
    dev = resolve_device(device)

    def arr(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=dev)
    b = len(np.asarray(endpoint))
    return PacketBatch(
        endpoint=arr(endpoint), identity=arr(identity), dport=arr(dport),
        proto=arr(proto), direction=arr(direction),
        length=arr(length if length is not None else np.full(b, 100)),
        is_fragment=arr(is_fragment if is_fragment is not None
                        else np.zeros(b)))
