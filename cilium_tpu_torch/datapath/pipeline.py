"""The fused steps: config-1 (ipcache LPM + 3-stage policy verdict) and
the v4 and v6 stateful serving steps.

Port of ``cilium_tpu/datapath/pipeline.py``: the batched equivalent of
the reference's per-packet path (bpf_lxc.c handle_ipv4_from_lxc and
ipv6_policy).  ``datapath_step`` is ipcache lookup → policy_can_egress →
counters; ``full_datapath_step`` adds the XDP prefilter, service DNAT,
conntrack, CT create, reply rev-NAT and the overlay encap;
``full_datapath_step6`` is its v6 twin with the ICMPv6/NDP responder.
Both family steps take an optional Hubble flow table (``flows``) that
they update at their end, and three optional stages, each behind its own
flag: the L7 fast verdict over a [B, W] payload lane
(``with_l7_fast``), inline threat scoring (``with_threat``,
``threat/stage.py``) and traffic analytics (``with_analytics``,
``analytics/stage.py``).  With every flag off a step runs exactly the
operations it ran before the stages existed.  Eager torch: the counters,
the CT, flow, threat and analytics state are updated in place, and no
step reads a device value on the host.  The L7 fast stage is the span
``dp:l7fast`` (``observability/stages.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..analytics.stage import analytics_stage
from ..compiler.lpm import CompiledLPM
from ..compiler.policy_tables import CompiledPolicy
from ..device import DeviceLike, resolve_device
from ..compiler.lpm import CompiledLPM6
from ..hubble.aggregation import FlowState, flow_update_step
from ..observability.stages import spanned
from ..ops.hashtab_ops import fold6
from ..ops.dfa_engine import _stride_scan
from ..ops.lpm_ops import lpm6_lookup, lpm_lookup
from ..threat.stage import threat_stage
from .codes import (VERDICT_DROP, VERDICT_DROP_FRAG, VERDICT_DROP_L7,
                    VERDICT_DROP_THREAT, WORLD_IDENTITY)
from .conntrack import CT_NEW, CT_RELATED, CT_REPLY, CTBatch, ct_step
from .events import (DROP_FRAG_NOSUPPORT, DROP_POLICY, DROP_POLICY_L7,
                     DROP_PREFILTER, DROP_THREAT, DROP_UNKNOWN_TARGET,
                     ICMP6_ECHO_REPLY, ICMP6_NS_REPLY, TIER_CT_ESTABLISHED,
                     TIER_L7_FAST_ALLOW, TIER_L7_FAST_DENY, TIER_LB,
                     TIER_PREFILTER, TIER_THREAT_DROP,
                     TIER_THREAT_RATELIMIT, TIER_THREAT_REDIRECT,
                     TRACE_TO_LXC, TRACE_TO_OVERLAY, TRACE_TO_PROXY)
from .lb import LB6Tables, LBTables, lb6_rev_nat, lb6_step, lb_rev_nat, \
    lb_step
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
    disables the overlay stage.  ``l7_*`` are the L7 fast-verdict tables
    (``l7/fast.L7FastPrograms``) and ``tm_*`` the threat model's
    (``threat/model.ThreatModel.tables()``); None while their stage is
    off."""

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
    l7_prog: Optional[torch.Tensor] = None    # [E, S] slot -> program (-1)
    l7_flat: Optional[torch.Tensor] = None    # [S * c1**k] stride table
    l7_map: Optional[torch.Tensor] = None     # [258] byte+2 -> class
    l7_accept: Optional[torch.Tensor] = None  # [S] 0/1 per-state accept
    l7_starts: Optional[torch.Tensor] = None  # [R] per-regex start state
    l7_pmask: Optional[torch.Tensor] = None   # [P, R] program -> regexes
    tm_w1: Optional[torch.Tensor] = None      # [F, H] layer-1 weights
    tm_b1: Optional[torch.Tensor] = None      # [H] layer-1 bias
    tm_w2: Optional[torch.Tensor] = None      # [H] layer-2 weights
    tm_b2: Optional[torch.Tensor] = None      # [1] layer-2 bias
    tm_cfg: Optional[torch.Tensor] = None     # [8] thresholds/mode/gen


def _flow_identities(ep_identity, endpoint, peer_identity, direction):
    """(src, dst) security identities of the flow key: the endpoint's own
    identity on its side of the flow, the resolved peer identity on the
    other (egress flows read ep -> peer, ingress flows peer -> ep)."""
    if ep_identity is not None:
        n_ep = ep_identity.shape[0]
        own = ep_identity[torch.clamp(endpoint, 0, n_ep - 1)]
    else:
        own = torch.zeros_like(peer_identity)
    egress = direction == 1
    src = torch.where(egress, own, peer_identity)
    dst = torch.where(egress, peer_identity, own)
    return src, dst


def _flows_tail(flows: FlowState, ep_identity, pkt, identity, dport,
                event, now, *, flow_slots: int, flow_probe: int,
                flow_claim_budget: int) -> FlowState:
    """Hubble flow aggregation at the end of a family step: per-flow
    packet/byte counters and last-seen keyed by (src identity, dst
    identity, DNAT'd dport, proto, event)."""
    src_id, dst_id = _flow_identities(ep_identity, pkt.endpoint, identity,
                                      pkt.direction)
    return flow_update_step(flows, src_id, dst_id, dport, pkt.proto,
                            event, pkt.length, now, slots=flow_slots,
                            max_probe=flow_probe,
                            claim_budget=flow_claim_budget)


# field order of the serving path's packed [10, B] batch matrix
PACKED_FIELDS = ("endpoint", "saddr", "daddr", "sport", "dport",
                 "proto", "direction", "tcp_flags", "length",
                 "is_fragment")
PACKED_INDEX = {f: i for i, f in enumerate(PACKED_FIELDS)}


def host_fail_static_step(soa, n: int, *, established, identity_of,
                          policy_verdict):
    """Host twin of ``full_datapath_step``'s verdict precedence (numpy;
    a copy of ``cilium_tpu/datapath/pipeline.py``'s): what the dataplane
    supervisor (``datapath/supervisor.py``) answers with while the device
    lane is degraded (daemon/state.go: the kernel keeps forwarding on
    last-known-good state while the agent is down).

    Precedence mirrors step 7 of the compiled program: an established
    flow follows its CT entry (its recorded proxy port; 0 == allow),
    everything else takes the (degraded-mode) policy verdict for a new
    flow.  The LB/prefilter/overlay stages are deliberately NOT served
    degraded — fail-static answers policy, not NAT (documented
    limitation; the reference's agent-down window likewise freezes LB
    backend churn).

    ``soa`` is the PacketRing SoA dict of [>=n] int32 arrays
    (PACKED_FIELDS keys).  Callbacks:

    - ``established(saddr_u32, daddr_u32, sport, dport, proto,
      direction) -> Optional[int]``: the flow's recorded proxy port
      when its CT entry (forward or reply tuple) is live, else None;
    - ``identity_of(addr_u32) -> int``: host-ipcache identity of the
      peer address (WORLD when unknown);
    - ``policy_verdict(endpoint_slot, identity, dport, proto,
      direction) -> int``: the new-flow decision (the compiler oracle,
      a blanket deny, or a blanket allow — the configured degraded
      policy).

    Returns (verdict [n], identity [n]) int32 arrays.
    """
    verdicts = np.empty(n, np.int32)
    idents = np.empty(n, np.int32)
    ep = soa["endpoint"]
    sa = np.ascontiguousarray(soa["saddr"][:n]).view(np.uint32)
    da = np.ascontiguousarray(soa["daddr"][:n]).view(np.uint32)
    sp, dp = soa["sport"], soa["dport"]
    pr, di = soa["proto"], soa["direction"]
    for j in range(n):
        direction = int(di[j])
        # peer identity: src on ingress, dst on egress (bpf_lxc.c:205)
        peer = int(sa[j]) if direction == 0 else int(da[j])
        ident = int(identity_of(peer))
        idents[j] = ident
        ct = established(int(sa[j]), int(da[j]), int(sp[j]),
                         int(dp[j]), int(pr[j]), direction)
        if ct is not None:
            verdicts[j] = ct  # the flow keeps its verdict (0 = allow)
            continue
        verdicts[j] = int(policy_verdict(int(ep[j]), ident,
                                         int(dp[j]), int(pr[j]),
                                         direction))
    return verdicts, idents


def full_datapath_step_packed(tables: FullTables, ct: torch.Tensor,
                              counters: Counters, packed: torch.Tensor,
                              now: torch.Tensor,
                              flows: Optional[FlowState] = None,
                              payload: Optional[torch.Tensor] = None,
                              threat=None, analytics=None, **statics):
    """``full_datapath_step`` over ONE [10, B] int32 field matrix in
    ``PACKED_FIELDS`` order (one host-to-device copy per batch); the
    fields are row views of it.  ``payload`` is the [B, W] L7 payload
    lane, its own tensor beside the matrix."""
    pkt = FullPacketBatch(**{f: packed[i]
                             for i, f in enumerate(PACKED_FIELDS)})
    return full_datapath_step(tables, ct, counters, pkt, now, flows,
                              payload, threat, analytics, **statics)


@spanned("l7fast")
def _l7_fast_stage(tables, payload: torch.Tensor,
                   pol_verdict: torch.Tensor, pol_slot: torch.Tensor, *,
                   k: int, c1: int):
    """The L7 fast verdict (``l7/fast.py`` tables): where the policy
    verdict is a redirect whose matched slot carries a first-bytes-
    decidable program and the payload window is present and not
    truncated, walk the fused k-stride DFA and allow or deny inline.
    Everything else keeps its redirect (fail to redirect, never open).

    Returns (verdict', fast_allow [B], fast_deny [B])."""
    prog_flat = tables.l7_prog.reshape(-1)
    # the slot and program indices clipped into their tables, as the
    # reference clips them (a miss has slot -1)
    slot = torch.clamp(pol_slot, 0, prog_flat.shape[0] - 1).long()
    prog = torch.where(pol_slot >= 0, prog_flat[slot], -1)
    eligible = (pol_verdict > 0) & (prog >= 0)
    # an absent (all -1) payload or a truncated (-2 poisoned) one cannot
    # be judged from its first bytes: those flows go to the proxy
    has_payload = payload[:, 0] >= 0
    truncated = (payload == -2).any(dim=1)
    # class map, stride pack and ceil(W/k) dependent gathers: the
    # ops/dfa_engine stride walk.  The lane's bytes are -2..255, so
    # l7_map[byte + 2] is in range; the clamp keeps any other value in
    # the table's 258 rows, as the reference's gather clamps.
    b = payload.shape[0]
    states = tables.l7_starts[None, :].expand(b, -1)
    final = _stride_scan(k, c1, tables.l7_flat, tables.l7_map, states,
                         torch.clamp(payload, -2, 255))
    hit = tables.l7_accept[final.long()] != 0             # [B, R]
    n_prog = tables.l7_pmask.shape[0]
    own = tables.l7_pmask[torch.clamp(prog, 0, n_prog - 1).long()]
    l7_allow = (hit & (own != 0)).any(dim=1)
    fast = eligible & has_payload & ~truncated
    fast_allow = fast & l7_allow
    fast_deny = fast & ~l7_allow
    verdict = torch.where(fast_allow, 0,
                          torch.where(fast_deny, VERDICT_DROP_L7,
                                      pol_verdict))
    return verdict, fast_allow, fast_deny


def _threat(tables, threat, flows, verdict, pkt, identity, dport,
            established, saddr_w, daddr_w, now, *, flow_slots: int,
            flow_probe: int, threat_window_s: int, threat_stripe: int,
            exempt=None):
    """The inline threat-scoring stage of either family
    (``threat/stage.threat_stage``), keyed like the flow tail.  It runs
    before the flow tail, which updates the flow table in place, so its
    probe reads the table as it was before this step."""
    t_src, t_dst = _flow_identities(tables.ep_identity, pkt.endpoint,
                                    identity, pkt.direction)
    return threat_stage(
        tables, threat, flows, verdict, identity=identity, dport=dport,
        proto=pkt.proto, tcp_flags=pkt.tcp_flags, length=pkt.length,
        is_fragment=pkt.is_fragment, established=established,
        saddr_w=saddr_w, daddr_w=daddr_w, sport=pkt.sport,
        flow_src=t_src, flow_dst=t_dst, now=now,
        window_s=threat_window_s, flow_slots=flow_slots,
        flow_probe=flow_probe, stripe=threat_stripe, exempt=exempt)


def _analytics(analytics, pkt, identity, dport, verdict, saddr_key,
               daddr_key, now, *, analytics_depth: int,
               analytics_lanes: int, analytics_stripe: int):
    """The traffic-analytics stage of either family
    (``analytics/stage.analytics_stage``) over the final verdicts."""
    return analytics_stage(
        analytics, identity=identity, dport=dport, proto=pkt.proto,
        sport=pkt.sport, length=pkt.length, verdict=verdict,
        saddr_key=saddr_key, daddr_key=daddr_key, now=now,
        depth=analytics_depth, lanes=analytics_lanes,
        stripe=analytics_stripe)


def _l7_tiers(pol_tier, fast_allow, fast_deny, i32):
    """Where the fast stage decided, it owns the policy tier (the slot
    stays the matched redirect entry)."""
    return torch.where(fast_allow, i32(TIER_L7_FAST_ALLOW),
                       torch.where(fast_deny, i32(TIER_L7_FAST_DENY),
                                   pol_tier))


def _threat_tiers(tier, thr_drop, thr_redir, rl_drop, i32):
    """Where the threat stage overrode the verdict, it owns the tier
    (the slot keeps the policy entry that allowed the traffic)."""
    return torch.where(
        rl_drop, i32(TIER_THREAT_RATELIMIT),
        torch.where(thr_drop, i32(TIER_THREAT_DROP),
                    torch.where(thr_redir, i32(TIER_THREAT_REDIRECT),
                                tier)))


def full_datapath_step(tables: FullTables, ct: torch.Tensor,
                       counters: Counters, pkt: FullPacketBatch,
                       now: torch.Tensor,
                       flows: Optional[FlowState] = None,
                       payload: Optional[torch.Tensor] = None,
                       threat=None, analytics=None, *,
                       policy_probe: int, lpm_probe: int, pf_probe: int,
                       lb_probe: int, ct_slots: int, ct_probe: int,
                       tun_probe: int = 0, flow_slots: int = 0,
                       flow_probe: int = 0, flow_claim_budget: int = 1024,
                       with_provenance: bool = False,
                       with_l7_fast: bool = False, l7_k: int = 1,
                       l7_c1: int = 2, with_threat: bool = False,
                       threat_window_s: int = 8, threat_stripe: int = 4,
                       with_analytics: bool = False,
                       analytics_depth: int = 2, analytics_lanes: int = 4,
                       analytics_stripe: int = 16):
    """The batched egress/ingress path (bpf_lxc.c:432
    handle_ipv4_from_lxc): XDP prefilter drop, service DNAT (lb4_local),
    conntrack lookup, ipcache identity, policy verdict for CT_NEW flows,
    CT creation gated on the verdict, reply rev-NAT, and overlay encap
    of allowed egress packets whose destination hits the tunnel map.

    ``ct`` ([8, ct_slots+2]) and ``counters`` are updated in place.
    ``now`` is a 0-d int32 tensor on the batch's device.  Returns
    (verdict, event, identity, nat, ct, counters), each [B] int32 but
    nat (a NATResult); with ``flows`` and ``flow_slots`` > 0 the flow
    table is updated in place and appended; ``with_provenance`` appends
    the matched policy slot (-1 = none) and the decision tier.  Verdict:
    -N drop code, 0 allow, > 0 proxy port.

    The optional stages, each off unless its flag is set:
    ``with_l7_fast`` decides redirects to first-bytes-decidable programs
    inline from ``payload`` ([B, W] int32), allow or VERDICT_DROP_L7;
    ``with_threat`` scores every packet (``threat``, a ThreatState,
    updated in place) and in enforce mode may drop, redirect or
    rate-limit, appending (threat, threat_out [B]) after the flow
    table; ``with_analytics`` folds the final verdicts into
    ``analytics`` (an AnalyticsState, updated in place) and appends it
    after those."""
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
    # (the fast stage needs the matched slot even with provenance off)
    pol = verdict_step(dp.key_id, dp.key_meta, dp.value, counters, vb,
                       policy_probe,
                       with_provenance=with_provenance or with_l7_fast)
    pol_verdict, counters = pol[0], pol[1]

    # 5.5 L7 fast verdict: a fast-allowed flow creates its CT entry with
    # proxy port 0 (the connection bypasses the proxy), a fast-denied
    # flow creates none.
    if with_l7_fast:
        pol_verdict, fast_allow, fast_deny = _l7_fast_stage(
            tables, payload, pol_verdict, pol[2], k=l7_k, c1=l7_c1)

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

    # 7.5 Threat scoring: its arms override allow and redirect verdicts
    # before the event and overlay stages, so a threat-dropped packet
    # never encaps.
    if with_threat:
        verdict, threat, threat_out, thr_drop, thr_redir, rl_drop = \
            _threat(tables, threat, flows, verdict, pkt, identity, dport,
                    established, pkt.saddr, daddr, now,
                    flow_slots=flow_slots, flow_probe=flow_probe,
                    threat_window_s=threat_window_s,
                    threat_stripe=threat_stripe)

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
    # VERDICT_DROP_L7 and VERDICT_DROP_THREAT come only from their stages
    if with_l7_fast:
        event = torch.where(verdict == VERDICT_DROP_L7, i32(DROP_POLICY_L7),
                            event)
    if with_threat:
        event = torch.where(verdict == VERDICT_DROP_THREAT,
                            i32(DROP_THREAT), event)

    # 8.5 Traffic analytics over the final verdicts (after the threat
    # stage, so the drops metric counts its drops too).
    if with_analytics:
        analytics = _analytics(analytics, pkt, identity, dport, verdict,
                               pkt.saddr, daddr, now,
                               analytics_depth=analytics_depth,
                               analytics_lanes=analytics_lanes,
                               analytics_stripe=analytics_stripe)

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
    if flows is not None and flow_slots > 0:
        # 10. Hubble flow aggregation.
        out = out + (_flows_tail(
            flows, tables.ep_identity, pkt, identity, dport, event, now,
            flow_slots=flow_slots, flow_probe=flow_probe,
            flow_claim_budget=flow_claim_budget),)
    if with_threat:
        out = out + (threat, threat_out)
    if with_analytics:
        out = out + (analytics,)
    if with_provenance:
        # 11. Provenance: the final-verdict precedence of step 7.
        pol_slot, pol_tier = pol[2], pol[3]
        if with_l7_fast:
            pol_tier = _l7_tiers(pol_tier, fast_allow, fast_deny, i32)
        tier = torch.where(pf_hit, i32(TIER_PREFILTER),
                           torch.where(established,
                                       i32(TIER_CT_ESTABLISHED), pol_tier))
        slot = torch.where(pf_hit | established, i32(-1), pol_slot)
        if with_threat:
            tier = _threat_tiers(tier, thr_drop, thr_redir, rl_drop, i32)
        out = out + (slot, tier)
    return out


# ---------------------------------------------------------------------------
# IPv6 step (bpf_lxc.c:114 ipv6_l3_from_lxc, :745 ipv6_policy)
# ---------------------------------------------------------------------------
#
# Addresses are [B, 4] int32 words (big-endian u32).  The policy tables
# are family-agnostic and shared with v4; prefilter and ipcache run the
# four-word LPM.  The v6 conntrack is a separate table whose two address
# words hold 32-bit folds of the 128-bit addresses (``fold6``), as in
# the reference: two v6 flows share an entry only if both folds, the
# port pair and proto/direction all collide.

IPPROTO_ICMPV6 = 58
ICMP6_NS = 135            # neighbour solicitation
ICMP6_ECHO_REQUEST = 128


class FullPacketBatch6(NamedTuple):
    """v6 wire metadata; addresses [B, 4], everything else [B] int32.

    ``icmp_type`` carries the ICMPv6 type of proto-58 rows (0
    elsewhere), ``nd_target`` the ND target address of NS packets ([B,
    4], zeros elsewhere), as bpf/lib/icmp6.h reads them from the wire."""

    endpoint: torch.Tensor
    saddr: torch.Tensor       # [B, 4]
    daddr: torch.Tensor       # [B, 4]
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
    icmp_type: Optional[torch.Tensor] = None
    nd_target: Optional[torch.Tensor] = None


class LPM6Tables(NamedTuple):
    masks: torch.Tensor   # [P, 4]
    k0: torch.Tensor      # [P, S]
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    kb: torch.Tensor
    value: torch.Tensor
    plens: torch.Tensor   # [P]


class NAT6Result(NamedTuple):
    """v6 forwarding result: the DNAT'd destination (forward) and the
    rev-NAT'd, VIP-restored source (reply).  Addresses [B, 4]."""

    daddr: torch.Tensor
    dport: torch.Tensor
    saddr: torch.Tensor
    sport: torch.Tensor
    rev_nat: torch.Tensor


class FullTables6(NamedTuple):
    """All device state of the v6 step.  The policy tensors,
    ``ep_identity`` and the optional stages' ``l7_*`` and ``tm_*`` tables
    are the v4 tables' own."""

    key_id: torch.Tensor      # shared policy tables [E, S]
    key_meta: torch.Tensor
    value: torch.Tensor
    ipcache6: LPM6Tables
    pf6: LPM6Tables
    lb6: Optional[LB6Tables] = None   # None: no v6 services
    # the node's router address words [4] (icmp6.h ROUTER_IP); None
    # disables the ICMPv6 responder
    router_ip6: Optional[torch.Tensor] = None
    ep_identity: Optional[torch.Tensor] = None
    l7_prog: Optional[torch.Tensor] = None
    l7_flat: Optional[torch.Tensor] = None
    l7_map: Optional[torch.Tensor] = None
    l7_accept: Optional[torch.Tensor] = None
    l7_starts: Optional[torch.Tensor] = None
    l7_pmask: Optional[torch.Tensor] = None
    tm_w1: Optional[torch.Tensor] = None
    tm_b1: Optional[torch.Tensor] = None
    tm_w2: Optional[torch.Tensor] = None
    tm_b2: Optional[torch.Tensor] = None
    tm_cfg: Optional[torch.Tensor] = None


def lpm6_tables(c: CompiledLPM6, device: DeviceLike = None) -> LPM6Tables:
    """CompiledLPM6 -> device tables."""
    dev = resolve_device(device)
    put = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.int32), device=dev)
    return LPM6Tables(masks=put(c.masks), k0=put(c.k0), k1=put(c.k1),
                      k2=put(c.k2), k3=put(c.k3), kb=put(c.kb),
                      value=put(c.value), plens=put(c.prefix_lens))


def _lpm6(t: LPM6Tables, addrs: torch.Tensor, probe: int):
    return lpm6_lookup(t.masks, t.k0, t.k1, t.k2, t.k3, t.kb, t.value,
                       t.plens, addrs, probe)


def full_datapath_step6(tables: FullTables6, ct: torch.Tensor,
                        counters: Counters, pkt: FullPacketBatch6,
                        now: torch.Tensor,
                        flows: Optional[FlowState] = None,
                        payload: Optional[torch.Tensor] = None,
                        threat=None, analytics=None, *,
                        policy_probe: int, lpm6_probe: int,
                        pf6_probe: int, ct_slots: int, ct_probe: int,
                        lb6_probe: int = 0, flow_slots: int = 0,
                        flow_probe: int = 0, flow_claim_budget: int = 1024,
                        with_provenance: bool = False,
                        with_l7_fast: bool = False, l7_k: int = 1,
                        l7_c1: int = 2, with_threat: bool = False,
                        threat_window_s: int = 8, threat_stripe: int = 4,
                        with_analytics: bool = False,
                        analytics_depth: int = 2,
                        analytics_lanes: int = 4,
                        analytics_stripe: int = 16):
    """The v6 twin of ``full_datapath_step`` (bpf_lxc.c:745
    ipv6_policy): prefilter drop, the ICMPv6/NDP responder, service DNAT
    (lb6_local), conntrack on folded tuples, ipcache identity, policy
    verdict for CT_NEW flows, CT create gated on the verdict, reply
    rev-NAT (lb6_rev_nat).  Same outputs, in-place updates and optional
    stages as the v4 step, with a NAT6Result; the threat and analytics
    stages take the CT address folds as address words, and the threat
    stage never overrides a row the ICMPv6 responder answered."""
    dev = pkt.sport.device
    b = pkt.sport.shape[0]
    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=dev)
    no = torch.zeros(b, dtype=torch.bool, device=dev)

    # 1. Prefilter.
    if tables.pf6.kb.shape[0] > 0:
        pf_hit, _ = _lpm6(tables.pf6, pkt.saddr, pf6_probe)
    else:
        pf_hit = no

    # 1.5 ICMPv6/NDP responder (icmp6.h icmp6_handle, before LB/CT/
    # policy): an NS for the router is answered with an NA, an NS for
    # anything else drops, an echo request to the router is answered;
    # every other ICMPv6 packet goes on through CT and policy.
    if tables.router_ip6 is not None and pkt.icmp_type is not None:
        is_icmp6 = pkt.proto == IPPROTO_ICMPV6
        router = tables.router_ip6[None, :]
        is_ns = is_icmp6 & (pkt.icmp_type == ICMP6_NS)
        nd_target = pkt.nd_target if pkt.nd_target is not None \
            else torch.zeros_like(pkt.saddr)
        target_is_router = (nd_target == router).all(dim=1)
        ns_answer = is_ns & target_is_router
        ns_unknown = is_ns & ~target_is_router
        echo_answer = is_icmp6 & (pkt.icmp_type == ICMP6_ECHO_REQUEST) & \
            (pkt.daddr == router).all(dim=1)
        icmp6_handled = ns_answer | ns_unknown | echo_answer
    else:
        ns_answer = ns_unknown = echo_answer = icmp6_handled = no

    # 2. Service LB DNAT (lb.h lb6_local).
    if lb6_probe > 0 and tables.lb6 is not None:
        daddr, dport, rev_nat, _is_svc = lb6_step(
            tables.lb6, pkt.daddr, pkt.dport, pkt.proto, pkt.saddr,
            pkt.sport, max_probe=lb6_probe)
    else:
        daddr, dport = pkt.daddr, pkt.dport
        rev_nat = torch.zeros(b, dtype=torch.int32, device=dev)

    # 3. Conntrack on the DNAT'd folded tuple (its own table).
    ctb = CTBatch(saddr=fold6(pkt.saddr), daddr=fold6(daddr),
                  sport=pkt.sport, dport=dport, proto=pkt.proto,
                  direction=pkt.direction, tcp_flags=pkt.tcp_flags,
                  related=torch.zeros_like(pkt.proto))

    # 4. ipcache6: identity of the peer (src on ingress, dst on egress).
    peer = torch.where((pkt.direction == 0)[:, None], pkt.saddr, daddr)
    if tables.ipcache6.kb.shape[0] > 0:
        found, ident = _lpm6(tables.ipcache6, peer, lpm6_probe)
    else:
        found = no
        ident = torch.zeros(b, dtype=torch.int32, device=dev)
    identity = torch.where(found, ident, i32(WORLD_IDENTITY))
    if pkt.from_overlay is not None:
        decap = (pkt.from_overlay != 0) & (pkt.direction == 0)
        identity = torch.where(decap, pkt.tunnel_id, identity)
    if pkt.mark_identity is not None:
        identity = torch.where(pkt.mark_identity > 0, pkt.mark_identity,
                               identity)

    # 5. Policy verdict on the shared tables, against the DNAT'd port;
    # locally answered ICMPv6 is not counted.
    vb = PacketBatch(endpoint=pkt.endpoint, identity=identity,
                     dport=dport, proto=pkt.proto,
                     direction=pkt.direction, length=pkt.length,
                     is_fragment=pkt.is_fragment)
    pol = verdict_step(tables.key_id, tables.key_meta, tables.value,
                       counters, vb, policy_probe,
                       count_mask=~icmp6_handled,
                       with_provenance=with_provenance or with_l7_fast)
    pol_verdict, counters = pol[0], pol[1]

    # 5.5 L7 fast verdict (the v4 stage, on the shared tables).
    if with_l7_fast:
        pol_verdict, fast_allow, fast_deny = _l7_fast_stage(
            tables, payload, pol_verdict, pol[2], k=l7_k, c1=l7_c1)

    # 6. CT step, creation gated on the verdict; locally answered
    # ICMPv6 neither creates nor touches CT state.
    create_ok = (pol_verdict >= 0) & ~pf_hit & ~icmp6_handled
    proxy_in = torch.clamp(pol_verdict, min=0)
    ct_verdict, ct_rev_nat, ct_proxy, ct = ct_step(
        ct, ctb, now, create_ok, update_mask=~pf_hit & ~icmp6_handled,
        rev_nat_in=rev_nat, proxy_port_in=proxy_in,
        slots=ct_slots, max_probe=ct_probe)

    established = ct_verdict != CT_NEW
    verdict = torch.where(
        pf_hit, i32(VERDICT_DROP),
        torch.where(ns_unknown, i32(VERDICT_DROP),
                    torch.where(ns_answer | echo_answer, i32(0),
                                torch.where(established, ct_proxy,
                                            pol_verdict))))

    # 6.5 Threat scoring (the v4 stage; the addresses enter its hash as
    # their CT folds); rows the ICMPv6 responder answered are scored
    # but never overridden.
    if with_threat:
        verdict, threat, threat_out, thr_drop, thr_redir, rl_drop = \
            _threat(tables, threat, flows, verdict, pkt, identity, dport,
                    established, ctb.saddr, ctb.daddr, now,
                    flow_slots=flow_slots, flow_probe=flow_probe,
                    threat_window_s=threat_window_s,
                    threat_stripe=threat_stripe, exempt=icmp6_handled)

    # 7. Reply-path reverse NAT (lb6_rev_nat).
    is_reply = (ct_verdict == CT_REPLY) | (ct_verdict == CT_RELATED)
    rn = torch.where(is_reply, ct_rev_nat, i32(0))
    if tables.lb6 is not None:
        nat_saddr, nat_sport = lb6_rev_nat(tables.lb6, pkt.saddr,
                                           pkt.sport, rn)
    else:
        nat_saddr, nat_sport = pkt.saddr, pkt.sport

    event = torch.where(
        pf_hit, i32(DROP_PREFILTER),
        torch.where(ns_answer, i32(ICMP6_NS_REPLY),
        torch.where(echo_answer, i32(ICMP6_ECHO_REPLY),
        torch.where(ns_unknown, i32(DROP_UNKNOWN_TARGET),
        torch.where(verdict == VERDICT_DROP_FRAG, i32(DROP_FRAG_NOSUPPORT),
                    torch.where(verdict < 0, i32(DROP_POLICY),
                                torch.where(verdict > 0,
                                            i32(TRACE_TO_PROXY),
                                            i32(TRACE_TO_LXC))))))))
    if with_l7_fast:
        event = torch.where(verdict == VERDICT_DROP_L7, i32(DROP_POLICY_L7),
                            event)
    if with_threat:
        event = torch.where(verdict == VERDICT_DROP_THREAT,
                            i32(DROP_THREAT), event)

    # 7.5 Traffic analytics (the v4 stage; the address words are the CT
    # folds).
    if with_analytics:
        analytics = _analytics(analytics, pkt, identity, dport, verdict,
                               ctb.saddr, ctb.daddr, now,
                               analytics_depth=analytics_depth,
                               analytics_lanes=analytics_lanes,
                               analytics_stripe=analytics_stripe)

    nat = NAT6Result(daddr=daddr, dport=dport, saddr=nat_saddr,
                     sport=nat_sport, rev_nat=ct_rev_nat)
    out = (verdict, event, identity, nat, ct, counters)
    if flows is not None and flow_slots > 0:
        # Hubble flow aggregation, shared with v4 (identity keys);
        # answered ICMPv6 aggregates under its reply event.
        out = out + (_flows_tail(
            flows, tables.ep_identity, pkt, identity, dport, event, now,
            flow_slots=flow_slots, flow_probe=flow_probe,
            flow_claim_budget=flow_claim_budget),)
    if with_threat:
        out = out + (threat, threat_out)
    if with_analytics:
        out = out + (analytics,)
    if with_provenance:
        # Provenance: prefilter, then the ICMPv6 responder (the local
        # service tier), then CT, then policy.
        pol_slot, pol_tier = pol[2], pol[3]
        if with_l7_fast:
            pol_tier = _l7_tiers(pol_tier, fast_allow, fast_deny, i32)
        tier = torch.where(
            pf_hit, i32(TIER_PREFILTER),
            torch.where(icmp6_handled, i32(TIER_LB),
                        torch.where(established, i32(TIER_CT_ESTABLISHED),
                                    pol_tier)))
        slot = torch.where(pf_hit | icmp6_handled | established, i32(-1),
                           pol_slot)
        if with_threat:
            tier = _threat_tiers(tier, thr_drop, thr_redir, rl_drop, i32)
        out = out + (slot, tier)
    return out
