"""The system under test: the port's ``Datapath``, set up as the agent
sets it up (``DaemonConfig`` defaults): telemetry on, the Hubble device
flow table, the conntrack table at the configuration's size, and the L7
fast verdict where the configuration has redirects.

This is the one module of the harness that builds the program's
objects or reads its tables.  The driver talks to any system through the
same six calls (``step``, ``gc``, ``snapshot``, ``read_state``,
``counter_keys``, ``close``), so the comparison's control can stand in
the program's place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .reference.node import OUTPUTS


def _port():
    """The port's modules, imported when a system is built (never when
    the harness is imported)."""
    from cilium_tpu_torch.datapath import engine, lb
    from cilium_tpu_torch.l7 import fast
    from cilium_tpu_torch.policy import api, mapstate
    return engine, lb, fast, api, mapstate


def l7_programs(l7: Dict, window: int):
    """The configuration's redirects as the port's fused fast programs."""
    _, _, fast, api, _ = _port()
    specs = []
    for red in l7["redirects"]:
        if red["protocol"] == "http":
            pats = fast.classify_http([api.PortRuleHTTP(**r)
                                       for r in red["rules"]])
            proto = fast.FAST_HTTP
        else:
            pats = fast.classify_dns([api.FQDNSelector(**s)
                                      for s in red["rules"]])
            proto = fast.FAST_DNS
        specs.append(fast.FastProgramSpec(port=red["proxy_port"],
                                          protocol=proto,
                                          patterns=tuple(pats)))
    return fast.build_fast_programs(specs, window=window)


class PortSystem:
    """A ``cilium_tpu_torch`` Datapath loaded with a generated node."""

    def __init__(self, node, config: Dict, device: torch.device):
        engine, lb, _, _, mapstate = _port()
        eng = config["engine"]
        dp = engine.Datapath(ct_slots=eng["ct_slots"],
                             ct_probe=eng["ct_probe"], device=device)
        dp.telemetry_enabled = eng["telemetry"]
        dp.enable_flow_aggregation(slots=eng["flow_slots"],
                                   max_probe=eng["flow_probe"],
                                   claim_every=eng["flow_claim_every"])
        if config.get("l7"):
            dp.enable_l7_fast(l7_programs(config["l7"],
                                          config["l7"]["window"]))
        dp.lb.upsert_services([
            lb.Service(vip=vip, port=port, proto=proto,
                       backends=[lb.Backend(addr=a, port=p)
                                 for a, p in backends])
            for vip, port, proto, backends in node.services])
        dp.prefilter.insert(list(node.prefilter))
        dp.load_tunnel(dict(node.tunnel))
        for slot, ident in enumerate(node.ep_identity):
            dp.set_endpoint_identity(slot, ident)
        states = []
        for m in node.maps:
            st = mapstate.PolicyMapState()
            for (ident, port, proto, direction), proxy in m.items():
                st[mapstate.PolicyKey(identity=ident, dest_port=port,
                                      nexthdr=proto,
                                      direction=direction)] = \
                    mapstate.PolicyMapStateEntry(proxy_port=proxy)
            states.append(st)
        dp.load_policy(states, revision=1,
                       ipcache_prefixes=dict(node.prefixes))
        self.dp = dp

    def step(self, packed: torch.Tensor, now: int,
             payload: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, ...]:
        """``process_packed``; its outputs in ``OUTPUTS`` order."""
        verdict, event, identity, nat = self.dp.process_packed(
            packed, now=now, payload=payload)
        return (verdict, event, identity, nat.daddr, nat.dport, nat.saddr,
                nat.sport, nat.rev_nat, nat.tunnel_ep, nat.tunnel_id)

    def gc(self, now: int) -> int:
        return self.dp.gc(now)

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """Device copies of the state a step updates in place (queued on
        the step's stream, no host read)."""
        dp = self.dp
        return {"ct": dp.ct.state.clone(),
                "flow_keys": dp.flows.state.keys.clone(),
                "flow_counters": dp.flows.state.counters.clone(),
                "counters": dp._counters.clone()}

    @staticmethod
    def read_state(snap: Dict[str, torch.Tensor]) -> Dict:
        """A snapshot as the comparison reads it: the conntrack table and
        the flow table as columns of their occupied slots (each entry's
        key, values and slot), and the policy counters.

        The conntrack table is [8, N+2] int32 (k0 source, k1
        destination, k2 ports, k3 protocol and direction, expiry, state
        word, reverse-NAT index, proxy port; a slot is occupied where k3
        is not 0).  The flow table's keys are [N+2, 4] (source and
        destination identity, the port, protocol and event word, last
        seen; row N+1 the lost and update counts) and its counters
        [N+1, 2] (packets, bytes)."""
        i64 = torch.int64
        ct = snap["ct"]
        n = ct.shape[1] - 2
        place = torch.nonzero(ct[3, :n] != 0)[:, 0]
        k = ct[:, place].to(i64)
        k2, k3 = k[2] & 0xFFFFFFFF, k[3] & 0xFFFFFFFF
        ct_map = {"saddr": k[0] & 0xFFFFFFFF, "daddr": k[1] & 0xFFFFFFFF,
                  "sport": k2 >> 16, "dport": k2 & 0xFFFF,
                  "proto": (k3 >> 8) & 0xFF, "direction": (k3 >> 1) & 1,
                  "expires": k[4], "related": (k[5] >> 2) & 1,
                  "rev_nat": k[6], "proxy_port": k[7], "place": place}
        keys, counters = snap["flow_keys"], snap["flow_counters"]
        n = keys.shape[0] - 2
        place = torch.nonzero(keys[:n, 2] != 0)[:, 0]
        fk = keys[place].to(i64)
        fc = counters[place].to(i64) & 0xFFFFFFFF
        acct = keys[n + 1].to(i64) & 0xFFFFFFFF
        flows = {"src": fk[:, 0], "dst": fk[:, 1],
                 "meta": fk[:, 2] & 0xFFFFFFFF, "last_seen": fk[:, 3],
                 "packets": fc[:, 0], "bytes": fc[:, 1], "place": place,
                 "lost": acct[0], "updates": acct[1]}
        return {"ct": ct_map, "flows": flows, "counters": snap["counters"]}

    def counter_keys(self) -> Dict[str, np.ndarray]:
        """Which policy entry each counter slot counts: endpoint,
        identity, dport, proto, direction of every occupied slot, and
        the slot.  Read from the program's tables to judge its
        counters."""
        t = self.dp._tables.datapath
        key_id = t.key_id.cpu().numpy()
        meta = t.key_meta.cpu().numpy().view(np.uint32).astype(np.int64)
        e, s = np.nonzero(meta)
        m = meta[e, s]
        return {"slot": e * key_id.shape[1] + s, "endpoint": e,
                "identity": key_id[e, s].view(np.uint32).astype(np.int64),
                "dport": (m >> 16) & 0xFFFF, "proto": (m >> 8) & 0xFF,
                "direction": (m >> 1) & 1}

    def close(self) -> None:
        self.dp = None


class ReferenceSystem:
    """The reference in the program's place (the comparison's control):
    a ``reference.node.Node``, by default with its connection-tracking
    guarantee broken."""

    def __init__(self, node, config: Dict, device: torch.device,
                 forget_connections: bool = True):
        from .reference.node import Node
        self.node = Node(node, config["engine"], config.get("l7"),
                         device, forget_connections=forget_connections)

    def step(self, packed, now, payload=None):
        out = self.node.step(packed, now, payload)
        return tuple(out[k] for k in OUTPUTS)

    def gc(self, now: int) -> int:
        self.node.gc(now)
        return 0

    def snapshot(self):
        return self.node.state()

    @staticmethod
    def read_state(snap):
        return snap

    def counter_keys(self):
        arr = self.node.policy.keys
        return {"slot": np.arange(arr.shape[0]), "endpoint": arr[:, 0],
                "identity": arr[:, 1], "dport": arr[:, 2],
                "proto": arr[:, 3], "direction": arr[:, 4]}

    def close(self) -> None:
        self.node = None
