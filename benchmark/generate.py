"""The deployment and its traffic, made from a seed.

A copy of the port's serving workloads (``v4_serving_state``,
``v4_serving_packets``, ``l7_serving_state``, ``l7_serving_packets``),
kept here so that the yardstick does not change with the program, and
parametrised by a configuration file (``state``, ``l7``) and a traffic
file (batch, pool flows, shares, L7 aim).  Address resolution and the
backend a reply comes from use the reference's LPM and load balancer.
The same seeds give the same state and batches as the port's copy.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .reference.l7 import encode
from .reference.lb import ServiceTable
from .reference.lpm import PrefixTable
from .reference.node import FIELDS

EGRESS, INGRESS = 1, 0
TCP_FIN, TCP_SYN, TCP_RST, TCP_ACK = 0x01, 0x02, 0x04, 0x10


def _ip(a: int, b: int, c: int, d: int) -> int:
    return (a << 24) | (b << 16) | (c << 8) | d


SERVICE_BASE = _ip(10, 96, 0, 1)    # service VIPs (10.96.0.0/12)
POOL_CLIENTS = _ip(10, 128, 0, 0)   # pool flows' client pods, one each
NEW_CLIENTS = _ip(10, 129, 0, 0)    # sources of the uniform new flows
NODE_BASE = _ip(192, 168, 0, 1)     # tunnel endpoints of the peer nodes
SERVICE_PORTS = (80, 443, 8080)
ENDPOINT_IDENTITY_BASE = 60000

# The deployment's seeds (``policy``: the rules and prefixes, ``state``:
# services, prefilter, tunnel) come from the configuration file: a
# deployment's tables are part of its configuration, and their probe
# depths set the step's work.  The traffic's seeds come from ``--seed``.
# The port's defaults are DEFAULT_SEEDS.
TRAFFIC_SEEDS = ("traffic", "l7")
DEFAULT_SEEDS = {"policy": 7, "state": 11, "traffic": 5, "l7": 1005}


def seeds_of(seed: int, config: Optional[Dict] = None) -> Dict[str, int]:
    """A run's seeds: the traffic's drawn from ``--seed``, the
    deployment's from the configuration (the port's defaults without
    one)."""
    words = np.random.SeedSequence(int(seed)).generate_state(
        len(TRAFFIC_SEEDS))
    out = {k: v for k, v in DEFAULT_SEEDS.items()
           if k not in TRAFFIC_SEEDS}
    out.update((config or {}).get("seeds", {}))
    out.update(zip(TRAFFIC_SEEDS, (int(w) for w in words)))
    return out


@dataclass
class NodeState:
    """A node's deployment: per-endpoint policy maps {(identity, dport,
    proto, direction): proxy port}, the ipcache prefixes, services as
    (vip, port, proto, [(backend, port)]) in load order (the last one
    without backends), prefilter deny CIDRs, the tunnel map (pod CIDR ->
    node IP), each endpoint's own identity and each policy identity's
    rule port.  ``base_prefixes`` are the prefixes without the L7
    redirect peers (the pool traffic draws from them); ``l7`` holds the
    redirect peers' networks and the payload table, or None."""

    maps: List[Dict[Tuple[int, int, int, int], int]]
    prefixes: Dict[str, int]
    services: List[Tuple[int, int, int, List[Tuple[int, int]]]]
    prefilter: List[str]
    tunnel: Dict[str, int]
    ep_identity: List[int]
    ident_port: Dict[int, int]
    base_prefixes: Dict[str, int]
    l7: Optional[Dict] = None


def parse_prefixes(prefixes: Dict[str, int]):
    out = []
    for cidr, val in prefixes.items():
        net = ipaddress.ip_network(cidr, strict=False)
        out.append((int(net.network_address), net.prefixlen, val))
    return out


def _resolve(table: PrefixTable, addrs: np.ndarray) -> np.ndarray:
    """Identity of each uint32 address (int64), -1 where none."""
    _, val = table.lookup(torch.as_tensor(
        addrs.astype(np.uint32).view(np.int32)))
    return val.numpy()


def _inside(rng, nets, pick: np.ndarray) -> np.ndarray:
    """A uniform address inside each picked prefix (int64)."""
    start = np.array([net[0] for net in nets], np.int64)
    span = np.array([1 << (32 - net[1]) for net in nets], np.int64)
    return start[pick] + rng.integers(0, span[pick])


def _policy(n_rules: int, n_endpoints: int, seed: int):
    """``n_rules`` CIDR + port allow rules (egress, TCP); every fifth
    also allows its identity at L3."""
    rng = np.random.default_rng(seed)
    prefixes = {}
    maps: List[Dict] = [{} for _ in range(n_endpoints)]
    ident = 256
    for i in range(n_rules):
        plen = int(rng.choice([16, 24]))
        addr = f"{rng.integers(1, 224)}.{rng.integers(0, 256)}." + \
            (f"{rng.integers(0, 256)}.0" if plen == 24 else "0.0")
        prefixes[f"{addr}/{plen}"] = ident
        port = int(rng.integers(1, 65536))
        for m in maps:
            m[(ident, port, 6, EGRESS)] = 0
        if i % 5 == 0:
            for m in maps:
                m[(ident, 0, 0, EGRESS)] = 0
        ident += 1
    return maps, prefixes


def node_state(state: Dict, seeds: Dict[str, int],
               l7: Optional[Dict] = None) -> NodeState:
    """The deployment of a configuration's ``state`` block (and its
    ``l7`` block, when it has one)."""
    n_endpoints = state["n_endpoints"]
    maps, prefixes = _policy(state["n_rules"], n_endpoints,
                             seeds["policy"])
    rng = np.random.default_rng(seeds["state"])
    ident_port = {}
    for (ident, port, _, _) in maps[0]:
        if port:
            ident_port[ident] = port
    nets = parse_prefixes(prefixes)
    table = PrefixTable(prefixes)

    n_services, backends = state["n_services"], state["backends"]
    n_back = (n_services - 1) * backends
    addrs = _inside(rng, nets, rng.integers(0, len(nets), n_back))
    ports = [ident_port[int(i)] for i in _resolve(table, addrs)]
    services = []
    for i in range(n_services):
        rows = range(i * backends, (i + 1) * backends) \
            if i < n_services - 1 else ()
        services.append((SERVICE_BASE + i, SERVICE_PORTS[i % 3], 6,
                         [(int(addrs[r]), ports[r]) for r in rows]))

    # deny CIDRs: first octet 11..223, outside 10/8 (the pods and
    # services) and outside every ipcache prefix
    n_prefilter = state["n_prefilter"]
    cand = rng.integers(_ip(11, 0, 0, 0), _ip(224, 0, 0, 0),
                        4 * n_prefilter + 64)
    cand = cand[_resolve(table, cand) < 0][:n_prefilter]
    plen = np.where(rng.random(cand.shape[0]) < 0.7, 24, 32)
    prefilter = []
    for a, p in zip(cand.tolist(), plen.tolist()):
        a &= (0xFFFFFFFF << (32 - p)) & 0xFFFFFFFF
        prefilter.append(f"{a >> 24}.{(a >> 16) & 255}.{(a >> 8) & 255}."
                         f"{a & 255}/{p}")

    slash24 = [c for c in prefixes if c.endswith("/24")]
    pods = [slash24[i] for i in
            rng.permutation(len(slash24))[:state["n_nodes"]]]
    tunnel = {cidr: NODE_BASE + k for k, cidr in enumerate(pods)}
    node = NodeState(
        maps=maps, prefixes=prefixes, services=services,
        prefilter=prefilter, tunnel=tunnel,
        ep_identity=[ENDPOINT_IDENTITY_BASE + e
                     for e in range(n_endpoints)],
        ident_port=ident_port, base_prefixes=prefixes)
    return with_l7(node, l7) if l7 else node


def _free_slash16(node: NodeState, count: int) -> List[int]:
    """``count`` /16 networks in 100.64.0.0/10 that overlap no ipcache
    prefix, prefilter CIDR or pod CIDR."""
    taken = [ipaddress.ip_network(c, strict=False) for c in
             list(node.prefixes) + list(node.prefilter) +
             list(node.tunnel)]
    out = []
    for second in range(64, 128):
        net = ipaddress.ip_network(f"100.{second}.0.0/16")
        if not any(net.overlaps(t) for t in taken):
            out.append(int(net.network_address))
            if len(out) == count:
                return out
    raise ValueError("no free /16 in 100.64.0.0/10")


def with_l7(node: NodeState, l7: Dict) -> NodeState:
    """The node plus the configuration's L7 redirects on every endpoint
    (each from or to its own free /16 peer network in the ipcache)."""
    redirects = l7["redirects"]
    nets = _free_slash16(node, len(redirects))
    maps = []
    for m in node.maps:
        m = dict(m)
        for red in redirects:
            m[(red["identity"], red["port"], red["proto"],
               red["direction"])] = red["proxy_port"]
        maps.append(m)
    prefixes = dict(node.prefixes)
    for net, red in zip(nets, redirects):
        prefixes[f"{ipaddress.ip_address(net)}/16"] = red["identity"]
    return NodeState(
        maps=maps, prefixes=prefixes, services=node.services,
        prefilter=node.prefilter, tunnel=node.tunnel,
        ep_identity=node.ep_identity, ident_port=node.ident_port,
        base_prefixes=node.prefixes,
        l7={"nets": {red["protocol"]: net
                     for net, red in zip(nets, redirects)},
            "window": l7["window"]})


def payload_strings(traffic_l7: Dict, window: int) -> List[Optional[str]]:
    """The payload table's strings: every HTTP request (methods x
    paths, one host), every DNS name, one overlong request and None
    (absent), in that order."""
    host = traffic_l7["http_host"].lower()
    strings: List[Optional[str]] = [
        f"{m}\x00{p}\x00{host}"
        for p in traffic_l7["http_paths"] for m in traffic_l7["http_methods"]]
    strings += [n.lower().rstrip(".") for n in traffic_l7["dns_names"]]
    strings += [f"GET\x00/public/{'p' * window}\x00{host}", None]
    return strings


def _backend_picker(node: NodeState):
    """``pick(vip, vport, client, sport) -> (backend, port)``: the
    backend the load balancer picks for a service connection."""
    lb = ServiceTable(node.services)

    def pick(vip, vport, client, sport):
        t = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64).astype(np.uint32).view(np.int32))
        back, bport, _ = lb.step(t(vip), t(vport),
                                 torch.full((vip.shape[0],), 6,
                                            dtype=torch.int32),
                                 t(client), t(sport))
        return back.numpy().view(np.uint32).astype(np.int64), bport.numpy()
    return pick


def _serving_rows(node: NodeState, batch: int, n_flows: int,
                  shares: Dict[str, float], seed: int):
    """Endless (rng, columns) of the connection stream: int64 [batch]
    columns of every field but length, unshuffled."""
    pick_backend = _backend_picker(node)
    rng = np.random.default_rng(seed)
    n_ep = len(node.ep_identity)
    nets = parse_prefixes(node.base_prefixes)
    tun_nets = parse_prefixes(node.tunnel)
    table = PrefixTable(node.base_prefixes)
    pf_nets = parse_prefixes({c: 1 for c in node.prefilter})

    flow = np.arange(n_flows, dtype=np.int64)
    ep = (flow % n_ep).astype(np.int32)
    client = POOL_CLIENTS + flow
    remote = rng.random(n_flows) < 0.2
    dst = np.where(remote,
                   _inside(rng, tun_nets,
                           rng.integers(0, len(tun_nets), n_flows)),
                   _inside(rng, nets, rng.integers(0, len(nets), n_flows)))
    dst_port = np.array([node.ident_port[int(i)]
                         for i in _resolve(table, dst)], np.int64)
    svc = rng.integers(0, len(node.services), n_flows)
    svc[0] = len(node.services) - 1
    vip = np.array([node.services[i][0] for i in svc], np.int64)
    vport = np.array([node.services[i][1] for i in svc], np.int64)
    gen = np.zeros(n_flows, np.int64)
    opened = np.zeros(n_flows, np.int64)   # batch of the flow's SYN

    def sport(j):
        return 20000 + 2 * (gen[j] % 20000)

    n_closing = int(round(shares["close"] * batch / 2))
    counts = {k: int(round(v * batch)) for k, v in shares.items()
              if k != "close"}
    t = 0
    while True:
        older = np.flatnonzero(opened < t)
        closing = rng.choice(older, min(n_closing, older.shape[0]),
                             replace=False)
        keep = np.ones(n_flows, bool)
        keep[closing] = False
        active = np.flatnonzero(keep)
        answer = np.flatnonzero(keep & (opened < t))
        cols = {f: [] for f in FIELDS if f != "length"}

        def add(endpoint, saddr, daddr, sp, dp, direction, flags,
                proto=6):
            m = np.shape(saddr)[0]
            for f, v in (("endpoint", endpoint), ("saddr", saddr),
                         ("daddr", daddr), ("sport", sp), ("dport", dp),
                         ("proto", proto), ("direction", direction),
                         ("tcp_flags", flags), ("is_fragment", 0)):
                cols[f].append(np.broadcast_to(
                    np.asarray(v, np.int64), (m,)))

        def syn_or_ack(j):
            return np.where(opened[j] == t, TCP_SYN, TCP_ACK)

        n_rep = counts["reply"] if answer.shape[0] else 0
        j = rng.choice(active, batch - 2 * closing.shape[0] - n_rep -
                       counts["service"] - counts["new"] -
                       counts["prefilter"])
        add(ep[j], client[j], dst[j], sport(j), dst_port[j], 1,
            syn_or_ack(j))
        j = rng.choice(active, counts["service"])
        add(ep[j], client[j], vip[j], sport(j) + 1, vport[j], 1,
            syn_or_ack(j))
        if n_rep:
            j = rng.choice(answer, n_rep)
            via_svc = rng.random(n_rep) < 0.5
            back, bport = pick_backend(vip[j], vport[j], client[j],
                                       sport(j) + 1)
            add(ep[j], np.where(via_svc, back, dst[j]), client[j],
                np.where(via_svc, bport, dst_port[j]),
                np.where(via_svc, sport(j) + 1, sport(j)), 0, TCP_ACK)
        n_new = counts["new"]
        udp = rng.random(n_new) < 0.2
        add(rng.integers(0, n_ep, n_new),
            NEW_CLIENTS + rng.integers(0, 1 << 16, n_new),
            rng.integers(_ip(1, 0, 0, 0), _ip(224, 0, 0, 0), n_new),
            rng.integers(1024, 65536, n_new), rng.integers(1, 65536, n_new),
            1, np.where(udp, 0, TCP_SYN), np.where(udp, 17, 6))
        n_pf = counts["prefilter"]
        j = rng.choice(active, n_pf)
        add(ep[j], _inside(rng, pf_nets, rng.integers(0, len(pf_nets),
                                                      n_pf)),
            client[j], rng.integers(1024, 65536, n_pf), sport(j), 0,
            TCP_SYN)
        j = np.concatenate([closing, closing])
        twin = np.repeat([0, 1], closing.shape[0])
        add(ep[j], client[j], np.where(twin, vip[j], dst[j]),
            sport(j) + twin, np.where(twin, vport[j], dst_port[j]), 1,
            np.where(rng.random(j.shape[0]) < 0.8, TCP_FIN | TCP_ACK,
                     TCP_RST))
        yield rng, {f: np.concatenate(v) for f, v in cols.items()}
        # the closed flows reopen with new source ports next batch
        gen[closing] += 1
        opened[closing] = t + 1
        t += 1


def v4_batches(node: NodeState, batch: int, n_flows: int,
               shares: Dict[str, float], seed: int
               ) -> Iterator[np.ndarray]:
    """Endless [10, batch] int32 batches (``FIELDS`` order): a pool of
    ``n_flows`` long-lived flows (forward, service twin, replies, close
    and reopen), new flows to uniform addresses and denylisted sources,
    in the given shares; lengths 64-1,499."""
    for rng, cols in _serving_rows(node, batch, n_flows, shares, seed):
        order = rng.permutation(batch)
        length = rng.integers(64, 1500, batch)
        out = np.empty((len(FIELDS), batch), np.int32)
        for i, f in enumerate(FIELDS):
            col = length if f == "length" else cols[f]
            out[i] = col.astype(np.uint32).view(np.int32)[order]
        yield out


def _aim_l7(node: NodeState, traffic_l7: Dict, packed: np.ndarray,
            n_flows: int, n_strings: int, rng) -> np.ndarray:
    """Rewrite, in place, the forward TCP rows of every tenth pool flow
    into L7 traffic: flows j = 0 (mod 20) become HTTP ingress to the
    client on :80 from the HTTP peers' network, j = 10 (mod 20) DNS
    egress over UDP to the DNS peers' :53.  Returns each row's index
    into the payload table: the flow's request or name on the L7 rows
    (the bad shares of them overlong or absent), absent elsewhere."""
    rows = {f: i for i, f in enumerate(FIELDS)}
    u32 = lambda f: packed[rows[f]].view(np.uint32)  # noqa: E731
    j = u32("saddr").astype(np.int64) - POOL_CLIENTS
    every = int(round(1 / traffic_l7["flow_share"]))
    aimed = (packed[rows["direction"]] == 1) & \
        (packed[rows["proto"]] == 6) & (j >= 0) & (j < n_flows) & \
        (j % every == 0)
    http = aimed & (j % (2 * every) == 0)
    dns = aimed & ~http
    client = u32("saddr").copy()
    peer = (j & 0xFFFF).astype(np.uint32)
    http_net, dns_net = node.l7["nets"]["http"], node.l7["nets"]["dns"]
    for f, val in (("saddr", np.where(http, http_net + peer, client)),
                   ("daddr", np.where(http, client,
                                      np.where(dns, dns_net + peer,
                                               u32("daddr"))))):
        packed[rows[f]] = val.astype(np.uint32).view(np.int32)
    packed[rows["direction"]][http] = 0
    packed[rows["dport"]][http] = 80
    packed[rows["dport"]][dns] = 53
    packed[rows["proto"]][dns] = 17
    packed[rows["tcp_flags"]][dns] = 0
    b = packed.shape[1]
    n_http = len(traffic_l7["http_paths"]) * len(traffic_l7["http_methods"])
    overlong_row, absent_row = n_strings - 2, n_strings - 1
    # a flow's request or name is its own, so a flow denied inline stays
    # denied; overlong and absent payloads fall on rows at random
    idx = np.full(b, absent_row, np.int32)
    flow = j // (2 * every)
    idx[http] = flow[http] % n_http
    idx[dns] = n_http + flow[dns] % len(traffic_l7["dns_names"])
    u = rng.random(b)
    bad_o = traffic_l7["bad_shares"]["overlong"]
    idx[aimed & (u < bad_o)] = overlong_row
    idx[aimed & (u >= bad_o) &
        (u < bad_o + traffic_l7["bad_shares"]["absent"])] = absent_row
    return idx


def payload_table(node: NodeState, traffic: Dict) -> np.ndarray:
    """[strings, W] int32: one encoded row per payload string."""
    window = node.l7["window"]
    return encode(payload_strings(traffic["l7"], window), window)


def batches(node: NodeState, traffic: Dict, seeds: Dict[str, int]
            ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Endless (packed [10, B] int32, payload index [B] or None) of a
    traffic file's mix over ``node``: the v4 stream, with every tenth
    pool flow aimed at the L7 redirects where the mix has an ``l7``
    block.  A batch's payload lane is ``payload_table(...)[index]``."""
    stream = v4_batches(node, traffic["batch"], traffic["pool_flows"],
                        traffic["shares"], seeds["traffic"])
    aim = traffic.get("l7")
    if not aim:
        for packed in stream:
            yield packed, None
        return
    if node.l7 is None:
        raise ValueError("the mix aims at L7 redirects the configuration "
                         "does not have")
    rng = np.random.default_rng(seeds["l7"])
    n_strings = len(payload_strings(aim, node.l7["window"]))
    for packed in stream:
        yield packed, _aim_l7(node, aim, packed, traffic["pool_flows"],
                              n_strings, rng)
