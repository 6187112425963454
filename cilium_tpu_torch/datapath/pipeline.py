"""The fused steps: config-1 (ipcache LPM + 3-stage policy verdict) and
the v4 stateful serving step.

Port of the v4 part of ``cilium_tpu/datapath/pipeline.py``: the batched
equivalent of the reference's per-packet path (bpf_lxc.c
handle_ipv4_from_lxc).  ``datapath_step`` is ipcache lookup →
policy_can_egress → counters; ``full_datapath_step`` adds the XDP
prefilter, service DNAT, conntrack, CT create, reply rev-NAT and the
overlay encap.  Eager torch: the counters and the CT table are updated
in place, and no step reads a device value on the host.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compiler.lpm import CompiledLPM
from ..compiler.policy_tables import CompiledPolicy
from ..device import DeviceLike, resolve_device
from ..ops.lpm_ops import lpm_lookup
from .codes import VERDICT_DROP, VERDICT_DROP_FRAG, WORLD_IDENTITY
from .conntrack import CT_NEW, CT_RELATED, CT_REPLY, CTBatch, ct_step
from .events import (DROP_FRAG_NOSUPPORT, DROP_POLICY, DROP_PREFILTER,
                     TIER_CT_ESTABLISHED, TIER_PREFILTER, TRACE_TO_LXC,
                     TRACE_TO_OVERLAY, TRACE_TO_PROXY)
from .lb import LBTables, lb_rev_nat, lb_step
from .verdict import Counters, PacketBatch, verdict_step


class DatapathTables(NamedTuple):
    """All device-resident state for the fused step (one generation)."""

    key_id: torch.Tensor     # [E, S] policy tables
    key_meta: torch.Tensor
    value: torch.Tensor
    lpm_masks: torch.Tensor  # [P] ipcache LPM
    lpm_key_a: torch.Tensor  # [P, S2]
    lpm_key_b: torch.Tensor
    lpm_value: torch.Tensor
    lpm_plens: torch.Tensor


class RawPacketBatch(NamedTuple):
    """Pre-identity packet metadata: addresses instead of identities."""

    endpoint: torch.Tensor    # [B] int32 endpoint slot
    src_addr: torch.Tensor    # [B] int32 (uint32 IPv4)
    dport: torch.Tensor       # [B] int32
    proto: torch.Tensor       # [B] int32
    direction: torch.Tensor   # [B] int32
    length: torch.Tensor      # [B] int32
    is_fragment: torch.Tensor  # [B] int32


def datapath_step(tables: DatapathTables, counters: Counters,
                  pkt: RawPacketBatch, *, policy_probe: int,
                  lpm_probe: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, Counters]:
    """addr -> identity (LPM) -> verdict (3-stage) -> counters.

    Returns (verdict [B], identity [B], counters), the counters added
    into in place."""
    found, ident = lpm_lookup(tables.lpm_masks, tables.lpm_key_a,
                              tables.lpm_key_b, tables.lpm_value,
                              tables.lpm_plens, pkt.src_addr, lpm_probe)
    world = torch.full((), WORLD_IDENTITY, dtype=torch.int32,
                       device=ident.device)
    identity = torch.where(found, ident, world)
    vb = PacketBatch(endpoint=pkt.endpoint, identity=identity,
                     dport=pkt.dport, proto=pkt.proto,
                     direction=pkt.direction, length=pkt.length,
                     is_fragment=pkt.is_fragment)
    verdict, counters = verdict_step(tables.key_id, tables.key_meta,
                                     tables.value, counters, vb,
                                     policy_probe)
    return verdict, identity, counters


def build_tables(compiled_policy: CompiledPolicy,
                 compiled_lpm: CompiledLPM,
                 device: DeviceLike = None) -> DatapathTables:
    dev = resolve_device(device)
    put = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.int32), device=dev)
    return DatapathTables(
        key_id=put(compiled_policy.key_id),
        key_meta=put(compiled_policy.key_meta),
        value=put(compiled_policy.value),
        lpm_masks=put(compiled_lpm.masks),
        lpm_key_a=put(compiled_lpm.key_a),
        lpm_key_b=put(compiled_lpm.key_b),
        lpm_value=put(compiled_lpm.value),
        lpm_plens=put(compiled_lpm.prefix_lens))


def make_step(compiled_policy: CompiledPolicy, compiled_lpm: CompiledLPM,
              device: DeviceLike = None
              ) -> Tuple[Callable, DatapathTables, Counters]:
    """(step fn, tables, fresh counters)."""
    dev = resolve_device(device)
    tables = build_tables(compiled_policy, compiled_lpm, device=dev)
    n = max(1, compiled_policy.num_endpoints * compiled_policy.slots)
    counters = Counters(packets=torch.zeros(n, dtype=torch.int32,
                                            device=dev),
                        bytes=torch.zeros(n, dtype=torch.int32,
                                          device=dev))
    step = functools.partial(
        datapath_step, policy_probe=compiled_policy.max_probe,
        lpm_probe=compiled_lpm.max_probe)
    return step, tables, counters


# ---------------------------------------------------------------------------
# Full v4 step: prefilter -> LB -> conntrack -> ipcache -> policy -> create
# ---------------------------------------------------------------------------

class FullPacketBatch(NamedTuple):
    """Wire-level metadata for the full path, all [B] int32.

    ``from_overlay``/``tunnel_id`` model the tunnel header of packets
    that arrived encapsulated from a peer node (bpf_overlay.c:151): where
    ``from_overlay`` is nonzero on ingress, the source identity is the
    one the sender stamped into the tunnel key.  ``mark_identity`` is
    the proxy-mark analog (bpf_netdev.c:128-146): nonzero values carry a
    proxied flow's original source identity and win over the ipcache.
    All three default to None."""

    endpoint: torch.Tensor
    saddr: torch.Tensor
    daddr: torch.Tensor
    sport: torch.Tensor
    dport: torch.Tensor
    proto: torch.Tensor
    direction: torch.Tensor
    tcp_flags: torch.Tensor
    length: torch.Tensor
    is_fragment: torch.Tensor
    from_overlay: Optional[torch.Tensor] = None
    tunnel_id: Optional[torch.Tensor] = None
    mark_identity: Optional[torch.Tensor] = None


class NATResult(NamedTuple):
    """Post-NAT forwarding result, all [B] int32: forward packets carry
    the DNAT'd destination, reply packets the rev-NAT'd (VIP-restored)
    source; nonzero ``tunnel_ep`` means the packet leaves encapsulated
    to that node with ``tunnel_id`` in the tunnel key (encap.h)."""

    daddr: torch.Tensor
    dport: torch.Tensor
    saddr: torch.Tensor
    sport: torch.Tensor
    rev_nat: torch.Tensor
    tunnel_ep: torch.Tensor
    tunnel_id: torch.Tensor


class FullTables(NamedTuple):
    """All device state of the full v4 step.  ``tun_*`` is the tunnel
    map LPM (pod CIDR -> tunnel endpoint node IP, pkg/maps/tunnel);
    ``ep_identity`` [E] is each local endpoint slot's own identity, the
    SECLABEL stamped into the tunnel key on encap.  ``tun_*`` None
    disables the overlay stage."""

    datapath: DatapathTables          # policy + ipcache LPM
    lb: LBTables                      # service tables
    pf_masks: torch.Tensor            # prefilter deny LPM
    pf_key_a: torch.Tensor
    pf_key_b: torch.Tensor
    pf_value: torch.Tensor
    pf_plens: torch.Tensor
    tun_masks: Optional[torch.Tensor] = None
    tun_key_a: Optional[torch.Tensor] = None
    tun_key_b: Optional[torch.Tensor] = None
    tun_value: Optional[torch.Tensor] = None
    tun_plens: Optional[torch.Tensor] = None
    ep_identity: Optional[torch.Tensor] = None


# field order of the serving path's packed [10, B] batch matrix
PACKED_FIELDS = ("endpoint", "saddr", "daddr", "sport", "dport",
                 "proto", "direction", "tcp_flags", "length",
                 "is_fragment")
PACKED_INDEX = {f: i for i, f in enumerate(PACKED_FIELDS)}


def full_datapath_step_packed(tables: FullTables, ct: torch.Tensor,
                              counters: Counters, packed: torch.Tensor,
                              now: torch.Tensor, **statics):
    """``full_datapath_step`` over ONE [10, B] int32 field matrix in
    ``PACKED_FIELDS`` order (one host-to-device copy per batch); the
    fields are row views of it."""
    pkt = FullPacketBatch(**{f: packed[i]
                             for i, f in enumerate(PACKED_FIELDS)})
    return full_datapath_step(tables, ct, counters, pkt, now, **statics)


def full_datapath_step(tables: FullTables, ct: torch.Tensor,
                       counters: Counters, pkt: FullPacketBatch,
                       now: torch.Tensor, *, policy_probe: int,
                       lpm_probe: int, pf_probe: int, lb_probe: int,
                       ct_slots: int, ct_probe: int, tun_probe: int = 0,
                       with_provenance: bool = False):
    """The batched egress/ingress path (bpf_lxc.c:432
    handle_ipv4_from_lxc): XDP prefilter drop, service DNAT (lb4_local),
    conntrack lookup, ipcache identity, policy verdict for CT_NEW flows,
    CT creation gated on the verdict, reply rev-NAT, and overlay encap
    of allowed egress packets whose destination hits the tunnel map.

    ``ct`` ([8, ct_slots+2]) and ``counters`` are updated in place.
    ``now`` is a 0-d int32 tensor on the batch's device.  Returns
    (verdict, event, identity, nat, ct, counters), each [B] int32 but
    nat (a NATResult); ``with_provenance`` appends the matched policy
    slot (-1 = none) and the decision tier.  Verdict: -N drop code,
    0 allow, > 0 proxy port."""
    dev = pkt.saddr.device
    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=dev)

    # 1. Prefilter (bpf_xdp.c:158 check_filters).
    if tables.pf_key_a.shape[0] > 0:
        pf_hit, _ = lpm_lookup(tables.pf_masks, tables.pf_key_a,
                               tables.pf_key_b, tables.pf_value,
                               tables.pf_plens, pkt.saddr, pf_probe)
    else:
        pf_hit = torch.zeros(pkt.saddr.shape[0], dtype=torch.bool,
                             device=dev)

    # 2. Service LB DNAT (lb.h lb4_local).
    daddr, dport, rev_nat, _is_svc = lb_step(
        tables.lb, pkt.daddr, pkt.dport, pkt.proto, pkt.saddr, pkt.sport,
        max_probe=lb_probe)

    # 3. Conntrack on the DNAT'd tuple (bpf_lxc.c:501 ct_lookup4); the
    # create decision comes after the policy verdict.
    ctb = CTBatch(saddr=pkt.saddr, daddr=daddr, sport=pkt.sport,
                  dport=dport, proto=pkt.proto, direction=pkt.direction,
                  tcp_flags=pkt.tcp_flags,
                  related=torch.zeros_like(pkt.proto))

    # 4. ipcache: remote identity from the peer address (src on
    # ingress, dst on egress).
    peer = torch.where(pkt.direction == 0, pkt.saddr, daddr)
    dp = tables.datapath
    found, ident = lpm_lookup(dp.lpm_masks, dp.lpm_key_a, dp.lpm_key_b,
                              dp.lpm_value, dp.lpm_plens, peer, lpm_probe)
    identity = torch.where(found, ident, i32(WORLD_IDENTITY))
    # Overlay decap: the tunnel key's identity wins (bpf_overlay.c:151).
    if pkt.from_overlay is not None:
        decap = (pkt.from_overlay != 0) & (pkt.direction == 0)
        identity = torch.where(decap, pkt.tunnel_id, identity)
    # Proxy re-entry: the mark carries the original source identity.
    if pkt.mark_identity is not None:
        identity = torch.where(pkt.mark_identity > 0, pkt.mark_identity,
                               identity)

    # 5. Policy verdict (bpf/lib/policy.h __policy_can_access).
    vb = PacketBatch(endpoint=pkt.endpoint, identity=identity,
                     dport=dport, proto=pkt.proto,
                     direction=pkt.direction, length=pkt.length,
                     is_fragment=pkt.is_fragment)
    pol = verdict_step(dp.key_id, dp.key_meta, dp.value, counters, vb,
                       policy_probe, with_provenance=with_provenance)
    pol_verdict, counters = pol[0], pol[1]

    # 6. CT step: creation gated on the policy allowing the flow
    # (bpf_lxc.c:545); prefilter-dropped packets neither create nor
    # touch live entries; new entries record rev-NAT and proxy port.
    create_ok = (pol_verdict >= 0) & ~pf_hit
    proxy_in = torch.clamp(pol_verdict, min=0)
    ct_verdict, ct_rev_nat, ct_proxy, ct = ct_step(
        ct, ctb, now, create_ok, update_mask=~pf_hit,
        rev_nat_in=rev_nat, proxy_port_in=proxy_in,
        slots=ct_slots, max_probe=ct_probe)

    # 7. Final verdict: prefilter drop beats everything; established
    # flows follow their CT entry (its recorded proxy port); CT_NEW
    # flows take the policy verdict.
    established = ct_verdict != CT_NEW
    verdict = torch.where(pf_hit, i32(VERDICT_DROP),
                          torch.where(established, ct_proxy, pol_verdict))

    # 8. Reply-path reverse NAT (lb.h lb4_rev_nat).  ``lb_rev_nat``
    # clips its index, as the reference's lb_rev_nat_arrays does.
    is_reply = (ct_verdict == CT_REPLY) | (ct_verdict == CT_RELATED)
    rn = torch.where(is_reply, ct_rev_nat, i32(0))
    nat_saddr, nat_sport = lb_rev_nat(tables.lb, pkt.saddr, pkt.sport, rn)
    event = torch.where(
        pf_hit, i32(DROP_PREFILTER),
        torch.where(verdict == VERDICT_DROP_FRAG, i32(DROP_FRAG_NOSUPPORT),
                    torch.where(verdict < 0, i32(DROP_POLICY),
                                torch.where(verdict > 0,
                                            i32(TRACE_TO_PROXY),
                                            i32(TRACE_TO_LXC)))))

    # 9. Overlay encap (encap.h encap_and_redirect): allowed egress
    # packets whose DNAT'd destination lies in a peer node's pod CIDR
    # leave encapsulated, carrying the endpoint's own identity.
    zero = torch.zeros_like(verdict)
    if tun_probe > 0 and tables.tun_key_a is not None:
        t_hit, t_ep = lpm_lookup(tables.tun_masks, tables.tun_key_a,
                                 tables.tun_key_b, tables.tun_value,
                                 tables.tun_plens, daddr, tun_probe)
        encap = t_hit & (pkt.direction == 1) & (verdict == 0) & ~pf_hit
        if tables.ep_identity is None:
            src_sec = zero
        else:  # the slot clipped into the table, as JAX's gather clamps
            n_ep = tables.ep_identity.shape[0]
            src_sec = tables.ep_identity[torch.clamp(pkt.endpoint, 0,
                                                     n_ep - 1)]
        tun_ep_out = torch.where(encap, t_ep, zero)
        tun_id_out = torch.where(encap, src_sec, zero)
        event = torch.where(encap, i32(TRACE_TO_OVERLAY), event)
    else:
        tun_ep_out = zero
        tun_id_out = zero

    nat = NATResult(daddr=daddr, dport=dport, saddr=nat_saddr,
                    sport=nat_sport, rev_nat=ct_rev_nat,
                    tunnel_ep=tun_ep_out, tunnel_id=tun_id_out)
    out = (verdict, event, identity, nat, ct, counters)
    if with_provenance:
        # 11. Provenance: the final-verdict precedence of step 7.
        pol_slot, pol_tier = pol[2], pol[3]
        tier = torch.where(pf_hit, i32(TIER_PREFILTER),
                           torch.where(established,
                                       i32(TIER_CT_ESTABLISHED), pol_tier))
        slot = torch.where(pf_hit | established, i32(-1), pol_slot)
        out = out + (slot, tier)
    return out
