"""The v4 step of one node, composed from the reference's stages.

For a batch at time ``now`` (Cilium's ``handle_ipv4_from_lxc``):

1. prefilter: a source inside a deny CIDR drops;
2. service DNAT;
3. ipcache: the peer's identity (source on ingress, destination after
   DNAT on egress), world (2) where no prefix holds it;
4. policy verdict on the DNAT'd port, counted on the deciding entry;
5. the L7 fast verdict, where the node has programs: allow (0) or -3;
6. conntrack on the DNAT'd tuple, creating only where the policy allows
   and the prefilter passed, recording rev-NAT index and proxy port
   (0 for a fast-allowed flow);
7. the verdict: prefilter drop, else the CT entry's proxy port for an
   established flow, else the policy verdict;
8. reply reverse NAT, and the event code;
9. encap: an allowed egress packet whose destination lies in a peer
   node's pod CIDR leaves to that node with the endpoint's identity;
10. the Hubble flow table, whose births run on every ``claim_every``-th
    step only.

``gc(now)`` clears the expired conntrack entries.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import conntrack as ct_mod
from . import flows as flow_mod
from .l7 import FastVerdicts, dns_pattern, http_pattern
from .lb import ServiceTable
from .lpm import PrefixTable
from .policy import PolicyTable

WORLD = 2
DROP = -1
DROP_FRAG = -2
DROP_L7 = -3
TRACE_TO_LXC = 0
TRACE_TO_PROXY = 1
TRACE_TO_OVERLAY = 4
DROP_POLICY_EVENT = -130
DROP_FRAG_EVENT = -131
DROP_PREFILTER_EVENT = -133
DROP_POLICY_L7_EVENT = -134

# field rows of a [10, B] batch matrix
FIELDS = ("endpoint", "saddr", "daddr", "sport", "dport", "proto",
          "direction", "tcp_flags", "length", "is_fragment")
# the step's outputs, in the order the comparison reads them
OUTPUTS = ("verdict", "event", "identity", "nat_daddr", "nat_dport",
           "nat_saddr", "nat_sport", "rev_nat", "tunnel_ep", "tunnel_id")


def l7_programs(l7: Dict) -> Dict[int, list]:
    """{proxy port: patterns} of a configuration's ``l7`` block."""
    out = {}
    for red in l7["redirects"]:
        if red["protocol"] == "http":
            out[red["proxy_port"]] = [http_pattern(r) for r in red["rules"]]
        else:
            out[red["proxy_port"]] = [dns_pattern(s) for s in red["rules"]]
    return out


class Node:
    """``state``: the generated deployment (policy maps, prefixes,
    services, prefilter, tunnel, endpoint identities); ``engine``: the
    configuration's engine block.  ``forget_connections`` is the
    control: every step sees an empty conntrack table, which breaks the
    guarantee that replies and established flows follow their entry."""

    def __init__(self, state, engine: Dict, l7: Optional[Dict] = None,
                 device="cpu", forget_connections: bool = False):
        self.device = device
        self.prefilter = PrefixTable({c: 1 for c in state.prefilter},
                                     device)
        self.ipcache = PrefixTable(state.prefixes, device)
        self.tunnel = PrefixTable(state.tunnel, device) \
            if state.tunnel else None
        self.lb = ServiceTable(state.services, device)
        self.policy = PolicyTable(state.maps, device)
        self.ep_identity = torch.as_tensor(state.ep_identity,
                                           dtype=torch.int32,
                                           device=device)
        self.fast = FastVerdicts(l7_programs(l7)) if l7 else None
        self.ct_slots = engine["ct_slots"]
        self.ct_probe = engine["ct_probe"]
        self.flow_slots = engine["flow_slots"]
        self.flow_probe = engine["flow_probe"]
        self.claim_every = engine["flow_claim_every"]
        self.claim_budget = engine["flow_claim_budget"]
        self.forget = forget_connections
        self.ct = ct_mod.ConnTable(self.ct_slots, self.ct_probe, device)
        self.flows = flow_mod.FlowTable(self.flow_slots, self.flow_probe,
                                        device)
        self.counters = torch.zeros((self.policy.n, 2), dtype=torch.int64,
                                    device=device)
        self.calls = 0

    def step(self, packed: torch.Tensor, now: int,
             payload: Optional[torch.Tensor] = None) -> Dict:
        """One batch; returns {output name: [B] int32} plus ``fast``
        ([B] bool, the rows the L7 fast verdict decided)."""
        pkt = {f: packed[i] for i, f in enumerate(FIELDS)}
        pf_hit, _ = self.prefilter.lookup(pkt["saddr"])
        daddr, dport, rev_nat = self.lb.step(
            pkt["daddr"], pkt["dport"], pkt["proto"], pkt["saddr"],
            pkt["sport"])
        ingress = pkt["direction"] == 0
        found, ident = self.ipcache.lookup(
            torch.where(ingress, pkt["saddr"], daddr))
        identity = torch.where(found, ident, WORLD)
        pol, entry = self.policy.verdict(
            pkt["endpoint"], identity, dport, pkt["proto"],
            pkt["direction"], pkt["is_fragment"])
        self.counters += self.policy.count(entry, pkt["length"])
        fast = torch.zeros_like(pf_hit)
        if self.fast is not None:
            proxy_of = self.policy.proxy[entry.clamp(min=0)]
            allow, deny = self.fast.decide(
                payload, pol, torch.where(entry >= 0, proxy_of, 0))
            pol = torch.where(allow, 0, torch.where(deny, DROP_L7, pol))
            fast = allow | deny

        if self.forget:
            self.ct.clear()
        ct_verdict, ct_rev_nat, ct_proxy = self.ct.step(
            pkt["saddr"], daddr, pkt["sport"], dport, pkt["proto"],
            pkt["direction"], pkt["tcp_flags"], torch.zeros_like(
                pkt["proto"]), now, (pol >= 0) & ~pf_hit, ~pf_hit,
            rev_nat, pol.clamp(min=0))
        ct_rev_nat = ct_rev_nat.to(torch.int32)
        ct_proxy = ct_proxy.to(torch.int32)
        established = ct_verdict != ct_mod.CT_NEW
        verdict = torch.where(pf_hit, DROP,
                              torch.where(established, ct_proxy, pol))
        verdict = verdict.to(torch.int32)

        reply = (ct_verdict == ct_mod.CT_REPLY) | \
            (ct_verdict == ct_mod.CT_RELATED)
        nat_saddr, nat_sport = self.lb.rev_nat(
            pkt["saddr"], pkt["sport"], torch.where(reply, ct_rev_nat, 0))
        event = torch.where(
            pf_hit, DROP_PREFILTER_EVENT,
            torch.where(verdict == DROP_FRAG, DROP_FRAG_EVENT,
                        torch.where(verdict == DROP_L7,
                                    DROP_POLICY_L7_EVENT,
                                    torch.where(verdict < 0,
                                                DROP_POLICY_EVENT,
                                                torch.where(verdict > 0,
                                                            TRACE_TO_PROXY,
                                                            TRACE_TO_LXC)))))
        zero = torch.zeros_like(verdict)
        n_ep = self.ep_identity.shape[0]
        own = self.ep_identity[pkt["endpoint"].clamp(0, n_ep - 1).long()]
        if self.tunnel is not None and len(self.tunnel):
            t_hit, t_ep = self.tunnel.lookup(daddr)
            encap = t_hit & (pkt["direction"] == 1) & (verdict == 0) & \
                ~pf_hit
            tunnel_ep = torch.where(encap, t_ep, zero)
            tunnel_id = torch.where(encap, own, zero)
            event = torch.where(encap, TRACE_TO_OVERLAY, event)
        else:
            tunnel_ep = tunnel_id = zero
        event = event.to(torch.int32)

        claim = self.calls % self.claim_every == 0
        self.calls += 1
        egress = pkt["direction"] == 1
        self.flows.step(
            torch.where(egress, own, identity),
            torch.where(egress, identity, own), dport, pkt["proto"],
            event, pkt["length"], now,
            self.claim_budget if claim else 0)
        out = dict(zip(OUTPUTS, (
            verdict, event, identity, daddr, dport, nat_saddr, nat_sport,
            ct_rev_nat, tunnel_ep, tunnel_id)))
        out = {k: v.to(torch.int32) for k, v in out.items()}
        out["fast"] = fast
        return out

    def gc(self, now: int) -> None:
        self.ct.forget(now)

    def state(self) -> Dict:
        """The conntrack and flow maps and the policy counters, as the
        comparison reads them."""
        return {"ct": self.ct.entries(), "flows": self.flows.entries(),
                "counters": self.counters.T.clone()}

    def load(self, state: Dict) -> None:
        """Start from ``state`` (as ``state`` gives it) with the policy
        counters at zero."""
        self.ct.load(state["ct"])
        self.flows.load(state["flows"])
        self.counters.zero_()
