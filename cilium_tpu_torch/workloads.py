"""The workloads: config 1 and the v4 serving state with its traffic.

The port's own copy of ``bench.py:build_config1`` and of the packet
generator of ``bench.py``'s config-1 run (BASELINE.json configs[0]): the
same seeds give the same map states, prefixes and packets.  A second
stream, ``config1_allow_heavy_packets``, sources its packets inside the
policy's prefixes so that a fifth of them or more are allowed.
``Config1Run`` puts one such state on a device behind both engines.

``v4_serving_state`` adds what the stateful v4 step serves beside the
config-1 policy (services, a prefilter deny list, a tunnel map, endpoint
identities), and ``v4_serving_packets`` streams batches of connections
over it: a pool of flows that open, exchange and close, service traffic,
replies, new flows and denylisted sources.  All of it comes from numpy
seeds, so the same seeds give the same state and batches on any device.
``V4Run`` serves that stream through a ``Datapath`` on a device.

``v6_serving_state`` / ``v6_serving_packets`` / ``V6Run`` are the v6
twin: every v4 address ``a`` becomes ``fd00::a`` (the v4 word in the low
32 bits of the ULA ``fd00::/96``), prefixes grow by 96 bits, and 1% of a
batch is ICMPv6 for the node's router (neighbour solicitations and echo
requests).

``build_config2`` / ``config2_packets`` / ``Config2Run`` are BASELINE
config 2 (identity-label L4 at 10,000 endpoints x 1,000 rules, the port's
copy of ``bench_suite.py``'s identity-l4 tables and traffic) on the
two-choice bucket engine; ``mixed_bucket_states`` / ``mixed_bucket_packets``
add the entry kinds and fragments that traffic never reaches.
``HTTP_RULES``, ``KAFKA_RULES``, ``FQDN_SELECTORS`` and the
``config{3,4,5}_*`` request makers are the L7 rule sets and requests of
BASELINE configs 3-5 (``bench_suite.py``'s http-regex, kafka-acl and
fqdn benches).

``l7_serving_state`` / ``l7_serving_packets`` (``l7_serving_packets6``)
serve the fused optional stages: the v4 state with the L7 fast-verdict
bench's two redirects (HTTP ingress :80, DNS egress :53) on every
endpoint, 10% of the pool flows aimed at them and a payload per row;
``threat_enforce_config`` and ``ANALYTICS`` are the threat and analytics
settings the serving runs use.

``policy_state`` writes a rule set as JSON, the text users import, with
the endpoints, peers and prefixes it is written for; ``PolicyRun`` takes
rules to verdicts through the ported control plane (identities, the
repository, endpoints and their build queue, the ipcache, the proxy's
redirects) into a ``Datapath``, wired as the daemon wires it, and
``policy_remotes`` / ``policy_packets`` make batches of new connections
over such a state.
"""

from __future__ import annotations

import ipaddress
import json
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .compiler.bucket_tables import BucketTables, build_bucket_tables
from .compiler.lpm import compile_lpm, ipv6_to_words, parse_prefixes
from .compiler.policy_tables import compile_endpoints, pack_meta
from .datapath import conntrack
from .datapath.codes import VERDICT_ALLOW, VERDICT_DROP, VERDICT_DROP_FRAG
from .datapath.engine import Datapath
from .datapath.lb import (Backend, Backend6, Service, Service6, compile_lb,
                          compile_lb6, lb6_step, lb_step)
from .datapath.pipeline import (PACKED_FIELDS, FullPacketBatch6,
                                RawPacketBatch, make_step)
from .device import DeviceLike, resolve_device
from .endpoint.endpoint import Endpoint
from .endpoint.manager import EndpointManager
from .endpoint.tables import DeviceTableManager
from .identity import Identity, IdentityCache, LocalIdentityAllocator
from .ipcache.cidr import (allocate_cidr_identities,
                           release_cidr_identities)
from .ipcache.ipcache import SOURCE_AGENT_LOCAL, SOURCE_KVSTORE, IPCache
from .l7.fast import (FAST_DNS, FAST_HTTP, FastProgramSpec,
                      L7FastPrograms, build_fast_programs, classify_dns,
                      classify_http, dns_match_string, encode_payloads,
                      http_match_string)
from .l7.http import HTTPRequest
from .l7.kafka import KafkaRequest
from .ops.bucket_ops import BucketVerdictEngine
from .ops.dense_verdict import (compile_dense, compile_dense_lpm,
                                dense_datapath_step, dense_segments)
from .labels import LabelArray, Labels
from .ops.lpm_ops import lpm_lookup
from .policy.api import FQDNSelector, PortRuleHTTP, PortRuleKafka, Rule
from .policy.jsonio import rules_from_json
from .policy.mapstate import (EGRESS, INGRESS, PolicyKey, PolicyMapState,
                              PolicyMapStateEntry)
from .policy.repository import Repository
from .proxy import ProxyManager
from .threat.model import ThreatConfig
from .utils.lock import RMutex
from .utils.trigger import Trigger


def build_config1(n_rules: int = 100, n_endpoints: int = 16, seed: int = 7
                  ) -> Tuple[List[PolicyMapState], Dict[str, int]]:
    """``n_rules`` CIDR+port allow rules -> map states + prefix table.
    Every fifth rule also allows its identity at L3."""
    rng = np.random.default_rng(seed)
    prefixes = {}
    states = [PolicyMapState() for _ in range(n_endpoints)]
    ident = 256
    for i in range(n_rules):
        plen = int(rng.choice([16, 24]))
        addr = f"{rng.integers(1, 224)}.{rng.integers(0, 256)}." + \
            (f"{rng.integers(0, 256)}.0" if plen == 24 else "0.0")
        prefixes[f"{addr}/{plen}"] = ident
        port = int(rng.integers(1, 65536))
        for st in states:
            st[PolicyKey(identity=ident, dest_port=port, nexthdr=6,
                         direction=EGRESS)] = PolicyMapStateEntry()
        if i % 5 == 0:
            for st in states:
                st[PolicyKey(identity=ident,
                             direction=EGRESS)] = PolicyMapStateEntry()
        ident += 1
    return states, prefixes


def config1_packets(batch: int, n_endpoints: int, seed: int = 1
                    ) -> Dict[str, np.ndarray]:
    """The config-1 packet stream: uniform endpoints, uniform source
    addresses over all of IPv4, uniform TCP destination ports, egress,
    512-byte packets.  All [batch] int32."""
    rng = np.random.default_rng(seed)
    return {
        "endpoint": rng.integers(0, n_endpoints, batch, dtype=np.int32),
        "src_addr": rng.integers(0, 2 ** 32, batch, dtype=np.uint32)
        .view(np.int32),
        "dport": rng.integers(1, 65536, batch, dtype=np.int32),
        "proto": np.full(batch, 6, np.int32),
        "direction": np.ones(batch, np.int32),
        "length": np.full(batch, 512, np.int32),
    }


def config1_allow_heavy_packets(batch: int, n_endpoints: int,
                                prefixes: Dict[str, int],
                                states: List[PolicyMapState], seed: int = 3
                                ) -> Dict[str, np.ndarray]:
    """The config-1 stream with its sources drawn inside the policy's
    prefixes (a prefix uniformly, then an address in it), 70% of the
    destination ports drawn from the rules' ports (those of
    ``states[0]``), the rest as in ``config1_packets``, and lengths
    uniform in [40, 1500).  All [batch] int32."""
    pk = config1_packets(batch, n_endpoints, seed=seed)
    rng = np.random.default_rng(seed)
    nets = parse_prefixes(prefixes)
    start = np.array([net[0] for net in nets], np.int64)
    span = np.array([1 << (32 - net[2]) for net in nets], np.int64)
    pick = rng.integers(0, len(nets), batch)
    src = start[pick] + rng.integers(0, span[pick])
    ports = np.array(sorted({k.dest_port for k in states[0]}), np.int32)
    pk["src_addr"] = src.astype(np.uint32).view(np.int32)
    pk["dport"] = np.where(rng.random(batch) < 0.7,
                           rng.choice(ports, batch),
                           pk["dport"]).astype(np.int32)
    pk["length"] = rng.integers(40, 1500, batch).astype(np.int32)
    return pk


TRAFFICS = ("uniform", "allow-heavy")


class Config1Run:
    """One config-1 state on a device, ready to step through both
    engines: the hash step (ipcache LPM hash probes -> 3-stage hash
    verdict) and the dense step (dense LPM -> the dense verdict kernel),
    each with its own counters, on one packet batch of one of
    ``TRAFFICS``: "uniform" (``config1_packets``) or "allow-heavy"
    (``config1_allow_heavy_packets``)."""

    def __init__(self, n_rules: int, batch: int, device: DeviceLike = None,
                 n_endpoints: int = 16):
        self.device = resolve_device(device)
        self.batch, self.n_endpoints = batch, n_endpoints
        self.states, self.prefixes = build_config1(n_rules, n_endpoints)
        self.compiled = compile_endpoints(self.states, revision=1)
        self.lpm = compile_lpm(self.prefixes)
        self.step, self.tables, self.counters = make_step(
            self.compiled, self.lpm, device=self.device)
        self.dense = compile_dense(self.states, device=self.device)
        self.segments = dense_segments(self.dense)
        self.dense_lpm = compile_dense_lpm(self.prefixes, device=self.device)
        n = self.dense.ep.shape[0]
        self.dense_packets = torch.zeros(n, dtype=torch.int32,
                                         device=self.device)
        self.dense_bytes = torch.zeros(n, dtype=torch.int32,
                                       device=self.device)
        self.set_traffic("uniform")

    def set_traffic(self, traffic: str) -> None:
        """Make this run's packet batch from the stream ``traffic`` and
        zero both engines' counters."""
        if traffic == "uniform":
            self.host = config1_packets(self.batch, self.n_endpoints)
        elif traffic == "allow-heavy":
            self.host = config1_allow_heavy_packets(
                self.batch, self.n_endpoints, self.prefixes, self.states)
        else:
            raise ValueError(f"traffic {traffic!r} is none of {TRAFFICS}")
        self.traffic = traffic
        for counter in (*self.counters, self.dense_packets,
                        self.dense_bytes):
            counter.zero_()
        self.pkt = {k: torch.as_tensor(v, device=self.device)
                    for k, v in self.host.items()}
        self.raw = RawPacketBatch(
            is_fragment=torch.zeros_like(self.pkt["endpoint"]), **self.pkt)

    def hash_step(self):
        """(verdict, identity, counters) of one hash-engine step."""
        return self.step(self.tables, self.counters, self.raw)

    def dense_step(self):
        """(verdict, identity, packets, bytes) of one dense-engine step."""
        p = self.pkt
        return dense_datapath_step(
            self.dense, self.dense_lpm, self.dense_packets,
            self.dense_bytes, p["endpoint"], p["src_addr"], p["dport"],
            p["proto"], p["direction"], p["length"], segments=self.segments)


# ---------------------------------------------------------------------------
# The v4 serving state and its traffic
# ---------------------------------------------------------------------------

def _ip(a: int, b: int, c: int, d: int) -> int:
    return (a << 24) | (b << 16) | (c << 8) | d


SERVICE_BASE = _ip(10, 96, 0, 1)    # service VIPs (10.96.0.0/12)
POOL_CLIENTS = _ip(10, 128, 0, 0)   # pool flows' client pods, one each
NEW_CLIENTS = _ip(10, 129, 0, 0)    # sources of the uniform new flows
NODE_BASE = _ip(192, 168, 0, 1)     # tunnel endpoints of the peer nodes
SERVICE_PORTS = (80, 443, 8080)
ENDPOINT_IDENTITY_BASE = 60000
# seconds of traffic a batch, batches between CT garbage collections
V4_SECONDS_PER_BATCH = 1
V4_GC_EVERY = 8


@dataclass
class V4ServingState:
    """What the v4 stateful step serves: the config-1 policy and ipcache
    (``states``, ``prefixes``), ``services`` in compile order (the last
    one has no backend), the prefilter's deny CIDRs, the tunnel map
    (pod CIDR -> node IP) and each endpoint slot's own identity.
    ``ident_port`` maps each policy identity to its rule's port."""

    states: List[PolicyMapState]
    prefixes: Dict[str, int]
    services: List[Service]
    prefilter: List[str]
    tunnel: Dict[str, int]
    ep_identity: List[int]
    ident_port: Dict[int, int]

    def load(self, dp: Datapath) -> None:
        """Program a ``Datapath`` with this state.  The services go in
        as copies: the load balancer assigns their rev-NAT indices."""
        dp.lb.upsert_services([Service(vip=s.vip, port=s.port,
                                       proto=s.proto,
                                       backends=list(s.backends))
                               for s in self.services])
        dp.prefilter.insert(self.prefilter)
        dp.load_tunnel(self.tunnel)
        for slot, ident in enumerate(self.ep_identity):
            dp.set_endpoint_identity(slot, ident)
        dp.load_policy(self.states, revision=1,
                       ipcache_prefixes=self.prefixes)


def _resolve(lpm, addrs: np.ndarray) -> np.ndarray:
    """Identity (LPM value, -1 on a miss) of each uint32 address, by the
    port's LPM on the CPU."""
    put = lambda x: torch.as_tensor(x)  # noqa: E731
    _, val = lpm_lookup(put(lpm.masks), put(lpm.key_a), put(lpm.key_b),
                        put(lpm.value), put(lpm.prefix_lens),
                        put(addrs.astype(np.uint32).view(np.int32)),
                        lpm.max_probe)
    return val.numpy()


def _inside(rng, nets, pick: np.ndarray) -> np.ndarray:
    """A uniform address inside each picked prefix (int64)."""
    start = np.array([net[0] for net in nets], np.int64)
    span = np.array([1 << (32 - net[2]) for net in nets], np.int64)
    return start[pick] + rng.integers(0, span[pick])


def v4_serving_state(n_rules: int = 10_000, n_endpoints: int = 16,
                     n_services: int = 10_000, backends: int = 4,
                     n_prefilter: int = 1000, n_nodes: int = 256,
                     seed: int = 11) -> V4ServingState:
    """The v4 serving state at full width by default: the 10k-rule
    config-1 policy over 16 endpoints; 10,000 services (the per-cluster
    service count of the Kubernetes scalability thresholds) on ports
    80/443/8080 with ``backends`` backends each inside the policy's
    prefixes on their identity's rule port, so DNAT'd flows are allowed,
    and a last service without backends; ``n_prefilter`` deny CIDRs
    (/24 and /32) outside the ipcache and the pod ranges; ``n_nodes``
    peer nodes whose pod CIDRs are /24 prefixes of the policy."""
    states, prefixes = build_config1(n_rules, n_endpoints)
    rng = np.random.default_rng(seed)
    ident_port = {k.identity: k.dest_port for k in states[0]
                  if k.dest_port}
    nets = parse_prefixes(prefixes)
    lpm = compile_lpm(prefixes)

    n_back = (n_services - 1) * backends
    addrs = _inside(rng, nets, rng.integers(0, len(nets), n_back))
    ports = [ident_port[int(i)] for i in _resolve(lpm, addrs)]
    services = []
    for i in range(n_services):
        rows = range(i * backends, (i + 1) * backends) \
            if i < n_services - 1 else ()
        services.append(Service(
            vip=SERVICE_BASE + i, port=SERVICE_PORTS[i % 3],
            backends=[Backend(addr=int(addrs[r]), port=ports[r])
                      for r in rows]))

    # deny CIDRs: first octet 11..223, outside 10/8 (the pods and
    # services) and outside every ipcache prefix
    cand = rng.integers(_ip(11, 0, 0, 0), _ip(224, 0, 0, 0),
                        4 * n_prefilter + 64)
    cand = cand[_resolve(lpm, cand) < 0][:n_prefilter]
    plen = np.where(rng.random(cand.shape[0]) < 0.7, 24, 32)
    prefilter = []
    for a, p in zip(cand.tolist(), plen.tolist()):
        a &= (0xFFFFFFFF << (32 - p)) & 0xFFFFFFFF
        prefilter.append(f"{a >> 24}.{(a >> 16) & 255}.{(a >> 8) & 255}."
                         f"{a & 255}/{p}")

    slash24 = [c for c in prefixes if c.endswith("/24")]
    pods = [slash24[i] for i in rng.permutation(len(slash24))[:n_nodes]]
    tunnel = {cidr: NODE_BASE + k for k, cidr in enumerate(pods)}
    return V4ServingState(
        states=states, prefixes=prefixes, services=services,
        prefilter=prefilter, tunnel=tunnel,
        ep_identity=[ENDPOINT_IDENTITY_BASE + e
                     for e in range(n_endpoints)],
        ident_port=ident_port)


# Shares of a batch (the rest, about 59.5%, are forward egress packets
# of pool flows).
V4_SHARES = {"service": 0.25, "reply": 0.10, "new": 0.04,
             "prefilter": 0.01, "close": 0.005}


def _v4_backends(state: V4ServingState):
    """``pick(vip, vport, client, sport) -> (backend, port)``: the
    backend that the v4 LB picks for each service connection (int64
    addresses), by the port's ``lb_step`` on the CPU."""
    lb = compile_lb([Service(vip=s.vip, port=s.port, proto=s.proto,
                             backends=list(s.backends))
                     for s in state.services], device="cpu")

    def pick(vip, vport, client, sport):
        u32 = lambda x: torch.as_tensor(  # noqa: E731
            x.astype(np.uint32).view(np.int32))
        back, bport, _, _ = lb_step(
            lb.tables, u32(vip), u32(vport),
            torch.full((vip.shape[0],), 6, dtype=torch.int32),
            u32(client), u32(sport), max_probe=lb.max_probe)
        return back.numpy().view(np.uint32).astype(np.int64), bport.numpy()
    return pick


def _serving_rows(state: V4ServingState, batch: int, n_flows: int,
                  seed: int, pick_backend, reserved: int = 0):
    """Endless (rng, columns) of the connection stream of
    ``v4_serving_packets``, unshuffled and without lengths: int64 [m]
    columns of ``PACKED_FIELDS`` but length, m = ``batch - reserved``.
    The caller draws its shuffle and lengths from ``rng`` before the
    next batch, so a caller that reserves no rows sees the v4 stream."""
    rng = np.random.default_rng(seed)
    n_ep = len(state.ep_identity)
    nets = parse_prefixes(state.prefixes)
    tun_nets = parse_prefixes(state.tunnel)
    lpm = compile_lpm(state.prefixes)
    pf_nets = parse_prefixes({c: 1 for c in state.prefilter})

    flow = np.arange(n_flows, dtype=np.int64)
    ep = (flow % n_ep).astype(np.int32)
    client = POOL_CLIENTS + flow
    remote = rng.random(n_flows) < 0.2
    dst = np.where(remote,
                   _inside(rng, tun_nets,
                           rng.integers(0, len(tun_nets), n_flows)),
                   _inside(rng, nets, rng.integers(0, len(nets), n_flows)))
    dst_port = np.array([state.ident_port[int(i)]
                         for i in _resolve(lpm, dst)], np.int64)
    svc = rng.integers(0, len(state.services), n_flows)
    svc[0] = len(state.services) - 1
    vip = np.array([state.services[i].vip for i in svc], np.int64)
    vport = np.array([state.services[i].port for i in svc], np.int64)
    gen = np.zeros(n_flows, np.int64)
    opened = np.zeros(n_flows, np.int64)   # batch of the flow's SYN

    def sport(j):
        return 20000 + 2 * (gen[j] % 20000)

    n_closing = int(round(V4_SHARES["close"] * batch / 2))
    counts = {k: int(round(v * batch)) for k, v in V4_SHARES.items()
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
        cols = {f: [] for f in PACKED_FIELDS if f != "length"}

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
            return np.where(opened[j] == t, conntrack.TCP_SYN,
                            conntrack.TCP_ACK)

        n_rep = counts["reply"] if answer.shape[0] else 0
        j = rng.choice(active, batch - reserved - 2 * closing.shape[0] -
                       n_rep - counts["service"] - counts["new"] -
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
                np.where(via_svc, sport(j) + 1, sport(j)), 0,
                conntrack.TCP_ACK)
        n_new = counts["new"]
        udp = rng.random(n_new) < 0.2
        add(rng.integers(0, n_ep, n_new),
            NEW_CLIENTS + rng.integers(0, 1 << 16, n_new),
            rng.integers(_ip(1, 0, 0, 0), _ip(224, 0, 0, 0), n_new),
            rng.integers(1024, 65536, n_new), rng.integers(1, 65536, n_new),
            1, np.where(udp, 0, conntrack.TCP_SYN), np.where(udp, 17, 6))
        n_pf = counts["prefilter"]
        j = rng.choice(active, n_pf)
        add(ep[j], _inside(rng, pf_nets, rng.integers(0, len(pf_nets),
                                                      n_pf)),
            client[j], rng.integers(1024, 65536, n_pf), sport(j), 0,
            conntrack.TCP_SYN)
        j = np.concatenate([closing, closing])
        twin = np.repeat([0, 1], closing.shape[0])
        add(ep[j], client[j], np.where(twin, vip[j], dst[j]),
            sport(j) + twin, np.where(twin, vport[j], dst_port[j]), 1,
            np.where(rng.random(j.shape[0]) < 0.8,
                     conntrack.TCP_FIN | conntrack.TCP_ACK,
                     conntrack.TCP_RST))
        yield rng, {f: np.concatenate(v) for f, v in cols.items()}
        # the closed flows reopen with new source ports next batch
        gen[closing] += 1
        opened[closing] = t + 1
        t += 1


def v4_serving_packets(state: V4ServingState, batch: int,
                       n_flows: int = 1 << 16, seed: int = 5
                       ) -> Iterator[np.ndarray]:
    """Endless [10, batch] int32 batches (``PACKED_FIELDS`` order) of
    connections over ``state``.

    A pool of ``n_flows`` flows, one client pod each on endpoint
    ``j % E``, each with a direct destination (an address of a policy
    prefix on its identity's rule port; a fifth of them in a peer
    node's pod CIDR) and a service twin (another source port to one
    service's VIP; flow 0's to the backend-less one).  A batch holds
    about 59.5% forward egress packets of pool flows and 25% of their
    service twins (SYN in a flow's first batch, ACK after), 10% ingress
    replies of flows opened in earlier batches (half of them from the
    service backend the LB picked), 4% new flows to uniform addresses
    and ports (mostly denied), 1% ingress packets sourced inside the
    prefilter's CIDRs, and 0.5% FIN or RST packets that close both
    connections of a flow, which sends nothing else in that batch and
    reopens with new source ports in the next.  Lengths 64-1,499."""
    for rng, cols in _serving_rows(state, batch, n_flows, seed,
                                   _v4_backends(state)):
        order = rng.permutation(batch)
        length = rng.integers(64, 1500, batch)
        out = np.empty((len(PACKED_FIELDS), batch), np.int32)
        for i, f in enumerate(PACKED_FIELDS):
            col = length if f == "length" else cols[f]
            out[i] = col.astype(np.uint32).view(np.int32)[order]
        yield out


V4_T0 = 1_000_000  # the clock of the first batch, seconds


class _ServingRun:
    """A serving state behind a ``Datapath`` on a device, with its
    packet stream and clock: batch ``t`` is served at ``V4_T0 + t``
    seconds, and the CT is garbage-collected every ``V4_GC_EVERY``
    batches (``advance``)."""

    def __init__(self, batch: int, device: DeviceLike, ct_slots: int,
                 ct_probe: int):
        self.device = resolve_device(device)
        self.dp = Datapath(ct_slots=ct_slots, ct_probe=ct_probe,
                           device=self.device)
        # the runs time the step alone, as the reference's benches do:
        # telemetry's verdict-count reads would add host reads to it
        self.dp.telemetry_enabled = False
        self.batch = batch
        self.stream: Iterator[np.ndarray] = iter(())
        self.t = 0

    @property
    def now(self) -> int:
        return V4_T0 + self.t * V4_SECONDS_PER_BATCH

    def next_batch(self) -> np.ndarray:
        """The stream's next int32 batch matrix, on the host."""
        return next(self.stream)

    def advance(self) -> int:
        """Move the clock to the next batch; run the CT GC when it is
        due and return the entries it deleted (0 otherwise)."""
        self.t += 1
        return self.dp.gc(self.now) if self.t % V4_GC_EVERY == 0 else 0


class V4Run(_ServingRun):
    """The v4 serving state and its stream (``v4_serving_packets``)
    behind a ``Datapath``.  ``state`` defaults to the full-width
    ``v4_serving_state()``."""

    def __init__(self, batch: int, device: DeviceLike = None,
                 ct_slots: int = 1 << 20, ct_probe: int = 8,
                 state: V4ServingState = None, n_flows: int = 1 << 16,
                 seed: int = 5):
        super().__init__(batch, device, ct_slots, ct_probe)
        self.state = state if state is not None else v4_serving_state()
        self.state.load(self.dp)
        self.stream = v4_serving_packets(self.state, batch, n_flows, seed)

    def step(self, packed: torch.Tensor):
        """``process_packed`` of a [10, B] batch on the device, now."""
        return self.dp.process_packed(packed, now=self.now)


# ---------------------------------------------------------------------------
# The v6 serving state and its traffic
# ---------------------------------------------------------------------------

ULA_WORD0 = 0xFD000000           # fd00::/96: v4 address a -> fd00::a
# the node's router (its pods' gateway), inside its pod block
# fd00::10.127.255.0/120
ROUTER_V4 = _ip(10, 127, 255, 1)
# shares of a v6 batch taken out of the forward egress share: NS for
# the router (every pod resolves its gateway), NS for another address
# of the pod block, echo requests to the router (health probes)
V6_ICMP_SHARES = {"ns_router": 0.005, "ns_other": 0.001, "echo": 0.004}
# rows of the packed v6 batch matrix: addresses and the ND target take
# four rows each (big-endian words)
PACKED6_FIELDS = (("endpoint", 1), ("saddr", 4), ("daddr", 4),
                  ("sport", 1), ("dport", 1), ("proto", 1),
                  ("direction", 1), ("tcp_flags", 1), ("length", 1),
                  ("is_fragment", 1), ("icmp_type", 1), ("nd_target", 4))
PACKED6_ROWS = sum(w for _, w in PACKED6_FIELDS)


def embed6(addr) -> np.ndarray:
    """uint32 v4 addresses [m] -> [m, 4] int64 words of fd00::a."""
    a = np.asarray(addr, np.int64)
    out = np.zeros(a.shape + (4,), np.int64)
    out[..., 0] = ULA_WORD0
    out[..., 3] = a & 0xFFFFFFFF
    return out


def embed6_cidr(cidr: str) -> str:
    """"a.b.c.d/p" -> "fd00::a.b.c.d/(96 + p)"."""
    addr, plen = cidr.split("/")
    return f"fd00::{addr}/{96 + int(plen)}"


def _words6(words) -> Tuple[int, int, int, int]:
    return tuple(int(w) & 0xFFFFFFFF for w in words)


@dataclass
class V6ServingState:
    """What the v6 step serves, the twin of ``v4`` (a
    ``V4ServingState``): the same policy, its prefixes embedded
    (``prefixes6``), its services embedded (``services6``), its
    prefilter CIDRs embedded (``prefilter6``) and the node's router
    address (``router6``)."""

    v4: V4ServingState
    prefixes6: Dict[str, int]
    services6: List[Service6]
    prefilter6: List[str]
    router6: str

    def load(self, dp: Datapath) -> None:
        """Program a ``Datapath`` with the v6 state and the shared policy
        (with the v4 ipcache).  The services go in as copies.  The v4
        services, prefilter and tunnel map come from ``v4.load``."""
        dp.load_ipcache6(self.prefixes6)
        dp.upsert_services6([Service6(vip=s.vip, port=s.port,
                                      proto=s.proto,
                                      backends=list(s.backends))
                             for s in self.services6])
        dp.prefilter.insert(self.prefilter6)
        dp.set_router_ip6(self.router6)
        for slot, ident in enumerate(self.v4.ep_identity):
            dp.set_endpoint_identity(slot, ident)
        dp.load_policy(self.v4.states, revision=1,
                       ipcache_prefixes=self.v4.prefixes)


def v6_serving_state(**v4_args) -> V6ServingState:
    """The v6 serving state, full width by default: ``v6_of`` the
    ``v4_serving_state`` of the same arguments."""
    return v6_of(v4_serving_state(**v4_args))


def v6_of(v4: V4ServingState) -> V6ServingState:
    """``v4`` embedded into ``fd00::/96``: the policy prefixes' /16 and
    /24 become /112 and /120 (the /120 is the per-node pod block of
    Cilium's cluster-pool IPv6 default), the services keep their
    backends (the last still has none), the prefilter's /24 and /32
    become /120 and /128; the router is ``fd00::`` + ``ROUTER_V4``."""
    services6 = [Service6(
        vip=_words6(embed6(s.vip)), port=s.port, proto=s.proto,
        backends=[Backend6(addr=_words6(embed6(b.addr)), port=b.port)
                  for b in s.backends]) for s in v4.services]
    r = ROUTER_V4
    return V6ServingState(
        v4=v4, prefixes6={embed6_cidr(c): i for c, i in v4.prefixes.items()},
        services6=services6,
        prefilter6=[embed6_cidr(c) for c in v4.prefilter],
        router6=f"fd00::{r >> 24}.{(r >> 16) & 255}.{(r >> 8) & 255}."
                f"{r & 255}")


def _v6_backends(state: V6ServingState):
    """``_v4_backends`` for the v6 LB: the backend that ``lb6_step``
    picks (its hash folds the v6 addresses), as the v4 word."""
    lb = compile_lb6([Service6(vip=s.vip, port=s.port, proto=s.proto,
                               backends=list(s.backends))
                      for s in state.services6], device="cpu")

    def pick(vip, vport, client, sport):
        w = lambda x: torch.as_tensor(  # noqa: E731
            embed6(x).astype(np.uint32).view(np.int32))
        i32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x).astype(np.int32))
        back, bport, _, _ = lb6_step(
            lb.tables, w(vip), i32(vport),
            torch.full((vip.shape[0],), 6, dtype=torch.int32),
            w(client), i32(sport), max_probe=lb.max_probe)
        return (back[:, 3].numpy().view(np.uint32).astype(np.int64),
                bport.numpy())
    return pick


def v6_serving_packets(state: V6ServingState, batch: int,
                       n_flows: int = 1 << 16, seed: int = 5
                       ) -> Iterator[np.ndarray]:
    """Endless [PACKED6_ROWS, batch] int32 batches (``PACKED6_FIELDS``
    order; ``unpack6`` makes a ``FullPacketBatch6`` of one): the
    connection stream of ``v4_serving_packets`` with every address
    embedded (service replies from the backend the v6 LB picks), and
    ``V6_ICMP_SHARES`` of the batch, taken out of the forward egress
    share, ICMPv6 from pool clients: neighbour solicitations for the
    router and for another address of its pod block, and echo requests
    to the router."""
    counts = {k: int(round(v * batch)) for k, v in V6_ICMP_SHARES.items()}
    n_icmp = sum(counts.values())
    router = np.array(ipv6_to_words(state.router6), np.int64)
    # the solicited-node multicast address of the router (ff02::1:ffXX:XXXX)
    solicited = np.array([0xFF020000, 0, 1, 0xFF000000 |
                          (int(router[3]) & 0xFFFFFF)], np.int64)
    n_ep = len(state.v4.ep_identity)
    for rng, cols in _serving_rows(state.v4, batch, n_flows, seed,
                                   _v6_backends(state), reserved=n_icmp):
        m = batch - n_icmp
        flow = rng.integers(0, n_flows, n_icmp)
        kind = np.repeat([135, 135, 128], [counts["ns_router"],
                                           counts["ns_other"],
                                           counts["echo"]])
        other = router.copy()
        other[3] += 1
        target = np.where((np.arange(n_icmp) < counts["ns_router"])
                          [:, None], router, other)
        target[kind == 128] = 0
        full = {
            "endpoint": np.r_[cols["endpoint"], flow % n_ep],
            "saddr": np.r_[embed6(cols["saddr"]),
                           embed6(POOL_CLIENTS + flow)],
            "daddr": np.r_[embed6(cols["daddr"]),
                           np.where((kind == 128)[:, None], router,
                                    solicited)],
            "sport": np.r_[cols["sport"], np.zeros(n_icmp, np.int64)],
            "dport": np.r_[cols["dport"], np.zeros(n_icmp, np.int64)],
            "proto": np.r_[cols["proto"], np.full(n_icmp, 58)],
            "direction": np.r_[cols["direction"], np.ones(n_icmp,
                                                          np.int64)],
            "tcp_flags": np.r_[cols["tcp_flags"], np.zeros(n_icmp,
                                                           np.int64)],
            "is_fragment": np.zeros(batch, np.int64),
            "icmp_type": np.r_[np.zeros(m, np.int64), kind],
            "nd_target": np.r_[np.zeros((m, 4), np.int64), target]}
        order = rng.permutation(batch)
        full["length"] = rng.integers(64, 1500, batch)
        out = np.empty((PACKED6_ROWS, batch), np.int32)
        row = 0
        for f, width in PACKED6_FIELDS:
            col = full[f].astype(np.uint32).view(np.int32)[order]
            out[row:row + width] = col.T if width > 1 else col
            row += width
        yield out


def unpack6(packed: torch.Tensor) -> FullPacketBatch6:
    """A ``FullPacketBatch6`` of views into one [PACKED6_ROWS, B] int32
    matrix (addresses as [B, 4] transposed views)."""
    fields, row = {}, 0
    for f, width in PACKED6_FIELDS:
        fields[f] = packed[row:row + width].T if width > 1 else packed[row]
        row += width
    return FullPacketBatch6(**fields)


class V6Run(_ServingRun):
    """The v6 serving state and its stream (``v6_serving_packets``)
    behind a ``Datapath``, served through ``process6``.  ``state``
    defaults to the full-width ``v6_serving_state()``."""

    def __init__(self, batch: int, device: DeviceLike = None,
                 ct_slots: int = 1 << 20, ct_probe: int = 8,
                 state: V6ServingState = None, n_flows: int = 1 << 16,
                 seed: int = 5):
        super().__init__(batch, device, ct_slots, ct_probe)
        self.state = state if state is not None else v6_serving_state()
        self.state.load(self.dp)
        self.stream = v6_serving_packets(self.state, batch, n_flows, seed)

    def step(self, packed: torch.Tensor):
        """``process6`` of a [PACKED6_ROWS, B] batch on the device, now."""
        return self.dp.process6(unpack6(packed), now=self.now)


# ---------------------------------------------------------------------------
# Config 2: identity-label L4 at scale, on the bucket engine
# ---------------------------------------------------------------------------

# packet columns of the bucket engine's call, in its argument order
CONFIG2_FIELDS = ("endpoint", "identity", "dport", "proto", "direction",
                  "length", "is_fragment")


@dataclass
class Config2State:
    """BASELINE config 2: ``rules_per_ep`` exact INGRESS TCP keys per
    endpoint, as [E, R] uint32 identity and meta words (all values 0:
    allow), and the bucket tables built from them (``build_s`` host
    seconds)."""

    ident: np.ndarray
    meta: np.ndarray
    tables: BucketTables
    build_s: float

    @property
    def ep_col(self) -> np.ndarray:
        """[E*R] endpoint of each flat entry."""
        e, r = self.ident.shape
        return np.repeat(np.arange(e, dtype=np.int64), r)

    def oracle_verdict(self, endpoint: int, identity: int, dport: int,
                       proto: int, direction: int, frag: int) -> int:
        """One packet's verdict from the endpoint's flat entries (the
        3-stage chain of ``policy_tables.oracle_verdict``; every value
        of this state is 0)."""
        ids = self.ident[endpoint]
        metas = self.meta[endpoint]
        ident = identity & 0xFFFFFFFF
        exact = pack_meta(dport, proto, direction)
        if not frag and ((ids == ident) & (metas == exact)).any():
            return VERDICT_ALLOW
        if ((ids == ident) & (metas == pack_meta(0, 0, direction))).any():
            return VERDICT_ALLOW
        if not frag and ((ids == 0) & (metas == exact)).any():
            return VERDICT_ALLOW
        return VERDICT_DROP_FRAG if frag else VERDICT_DROP


def build_config2(n_endpoints: int = 10_000, rules_per_ep: int = 1_000,
                  seed: int = 3) -> Config2State:
    """The port's copy of ``bench_suite.py:_make_policy_tables``: random
    identities, ports distinct within each endpoint (stride 61, coprime
    to 65535) so the (identity, port) keys are unique, INGRESS TCP meta
    words, all built as flat arrays."""
    rng = np.random.default_rng(seed)
    ident = rng.integers(256, 1 << 22,
                         (n_endpoints, rules_per_ep)).astype(np.uint32)
    ports = 1 + (np.arange(rules_per_ep, dtype=np.uint32)[None, :] * 61
                 + rng.integers(0, 65535, (n_endpoints, 1))) % 65535
    meta = ((ports << 16) | (6 << 8) | (INGRESS << 1) | 1).astype(
        np.uint32)
    ep_col = np.repeat(np.arange(n_endpoints, dtype=np.int64), rules_per_ep)
    t0 = time.perf_counter()
    tables = build_bucket_tables(
        ep_col, ident.ravel(), meta.ravel(),
        np.zeros(n_endpoints * rules_per_ep, np.int32),
        num_endpoints=n_endpoints, revision=1)
    return Config2State(ident=ident, meta=meta, tables=tables,
                        build_s=time.perf_counter() - t0)


def config2_packets(state: Config2State, batch: int, seed: int = 4
                    ) -> Dict[str, np.ndarray]:
    """The traffic of ``bench_suite.py:bench_identity_l4``: half the
    packets on installed exact keys, half random misses; TCP ingress,
    256-byte packets, no fragments.  All [batch] int32."""
    rng = np.random.default_rng(seed)
    e = state.ident.shape[0]
    sel = rng.integers(0, state.ident.size, batch)
    hit = rng.random(batch) < 0.5
    pep = np.where(hit, state.ep_col[sel], rng.integers(0, e, batch))
    pid = np.where(hit, state.ident.ravel()[sel].view(np.int32),
                   rng.integers(256, 1 << 22, batch))
    key_port = (state.meta.ravel()[sel] >> 16).astype(np.int32)
    dpt = np.where(hit, key_port, rng.integers(1, 65536, batch))
    cols = {"endpoint": pep, "identity": pid, "dport": dpt,
            "proto": np.full(batch, 6), "direction": np.zeros(batch),
            "length": np.full(batch, 256), "is_fragment": np.zeros(batch)}
    return {k: v.astype(np.int32) for k, v in cols.items()}


def mixed_bucket_states(n_endpoints: int, per_ep: int, seed: int
                        ) -> List[PolicyMapState]:
    """Map states of all three entry kinds (exact with proxy ports,
    L3-only, L4-wildcard), both directions, so every stage of the
    bucket verdict hits (the states of the reference's bucket tests)."""
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(n_endpoints):
        st = PolicyMapState()
        for ident in rng.choice(np.arange(256, 5000), per_ep, replace=False):
            kind = rng.integers(0, 3)
            d = int(rng.integers(0, 2))
            if kind == 0:
                st[PolicyKey(identity=int(ident),
                             dest_port=int(rng.integers(1, 65536)),
                             nexthdr=6, direction=d)] = PolicyMapStateEntry(
                    proxy_port=int(rng.choice([0, 0, 15001])))
            elif kind == 1:
                st[PolicyKey(identity=int(ident), direction=d)] = \
                    PolicyMapStateEntry()
            else:
                st[PolicyKey(identity=0,
                             dest_port=int(rng.integers(1, 65536)),
                             nexthdr=6, direction=d)] = PolicyMapStateEntry()
        states.append(st)
    return states


def mixed_bucket_packets(states: List[PolicyMapState], batch: int,
                         seed: int) -> Dict[str, np.ndarray]:
    """Packets over ``mixed_bucket_states``: half take a key of their
    endpoint (a random identity for wildcard keys, a random port for
    L3-only ones), half are random; 10% fragments, lengths up to 2**31
    so the byte counters wrap.  All [batch] int32."""
    rng = np.random.default_rng(seed)
    keys = [list(st) for st in states]
    ep = rng.integers(0, len(states), batch)
    ident = rng.integers(0, 5200, batch)
    dport = rng.integers(1, 65536, batch)
    direction = rng.integers(0, 2, batch)
    for i in np.flatnonzero(rng.random(batch) < 0.5):
        k = keys[ep[i]][rng.integers(0, len(keys[ep[i]]))]
        ident[i] = k.identity or ident[i]
        dport[i] = k.dest_port or dport[i]
        direction[i] = k.direction
    cols = {"endpoint": ep, "identity": ident, "dport": dport,
            "proto": rng.choice([6, 6, 6, 17], batch),
            "direction": direction,
            "length": rng.integers(40, 1 << 31, batch),
            "is_fragment": (rng.random(batch) < 0.1)}
    return {k: v.astype(np.int32) for k, v in cols.items()}


class Config2Run:
    """The config-2 state behind a ``BucketVerdictEngine`` on a device.
    ``state`` defaults to the full BASELINE width (10,000 endpoints x
    1,000 rules)."""

    def __init__(self, batch: int, device: DeviceLike = None,
                 state: Config2State = None):
        self.device = resolve_device(device)
        self.batch = batch
        self.state = state if state is not None else build_config2()
        self.engine = BucketVerdictEngine(self.state.tables,
                                          device=self.device)

    def packets(self, seed: int) -> Dict[str, np.ndarray]:
        """One batch of the config-2 traffic, on the host."""
        return config2_packets(self.state, self.batch, seed)

    def to_device(self, host: Dict[str, np.ndarray]) -> List[torch.Tensor]:
        """A host batch as the engine's argument tensors on its device."""
        return [torch.as_tensor(host[f], device=self.device)
                for f in CONFIG2_FIELDS]

    def step(self, pkts: List[torch.Tensor]) -> torch.Tensor:
        """One verdict step (counters add in place)."""
        return self.engine(*pkts)


# ---------------------------------------------------------------------------
# Configs 3-5: the L7 rule sets and requests of bench_suite.py:138-231
# ---------------------------------------------------------------------------

# config 3: HTTP method+path regex, 4 rules
HTTP_RULES = (PortRuleHTTP(method="GET", path="/public/.*"),
              PortRuleHTTP(method="GET", path="/api/v[0-9]+/users/.*"),
              PortRuleHTTP(method="POST", path="/api/v[0-9]+/orders"),
              PortRuleHTTP(method="PUT", path="/admin/.*",
                           host="admin\\.example\\.com"))
HTTP_PATHS = ("/public/idx.html", "/api/v2/users/42", "/api/v2/orders",
              "/secret/x", "/admin/panel", "/api/vX/users/1")
HTTP_METHODS = ("GET", "POST", "PUT")
# config 4: Kafka topic/API-key ACLs
KAFKA_RULES = (PortRuleKafka(role="consume", topic="events.page"),
               PortRuleKafka(api_key="produce", topic="logs"),
               PortRuleKafka(client_id="trusted-0"))
# config 5: FQDN wildcard selectors
FQDN_SELECTORS = (FQDNSelector(match_pattern="*.example.com"),
                  FQDNSelector(match_name="api.internal.svc"),
                  FQDNSelector(match_pattern="db-*.prod.local"))


def config3_requests(batch: int) -> List[HTTPRequest]:
    """The http-regex bench's requests: 6 paths x 3 methods, host
    ``admin.example.com``."""
    return [HTTPRequest(method=HTTP_METHODS[i % 3], path=HTTP_PATHS[i % 6],
                        host="admin.example.com") for i in range(batch)]


def config4_requests(batch: int) -> List[KafkaRequest]:
    """The kafka-acl bench's requests: fetch and produce, two topics,
    seven client ids."""
    return [KafkaRequest(api_key=0 if i % 2 else 1, api_version=2,
                         correlation_id=i,
                         topics=["events.page" if i % 3 else "logs"],
                         client_id=f"client-{i % 7}") for i in range(batch)]


def config5_names(batch: int) -> List[str]:
    """The fqdn bench's names: half ``host<i>.example.com``, half
    ``db-<i>.prod.local``."""
    return [f"host{i}.example.com" if i % 2 else f"db-{i}.prod.local"
            for i in range(batch)]


# ---------------------------------------------------------------------------
# The fused optional stages: L7 fast verdicts, threat scoring, analytics
# ---------------------------------------------------------------------------

# bench_suite.py:276-292 (bench_l7_fast): the proxy ports and window
L7_WINDOW = 128
L7_HTTP_PORT = 15001
L7_DNS_PORT = 15002
# the two redirect peers' identities, outside the policy's 256.. and the
# endpoints' 60000..
L7_HTTP_ID = 50001
L7_DNS_ID = 50002
# share of the pool flows aimed at the redirects (half HTTP, half DNS),
# and the shares of those flows' rows whose payload is overlong (-2
# poison) or absent (all -1)
L7_FLOW_SHARE = 0.10
L7_BAD_SHARES = {"overlong": 0.05, "absent": 0.05}
# bench_suite.py:332-336: the names of the DNS mix
L7_DNS_NAMES = ("host1.example.com", "api.internal.svc",
                "db-3.prod.local", "evil.attacker.net")
# the daemon's analytics defaults (utils/option.py:343-347)
ANALYTICS = {"width": 1 << 12, "depth": 2, "lanes": 4, "stripe": 16}
# the daemon's threat defaults: buckets, window, stripe
THREAT = {"buckets": 1 << 10, "window_s": 8, "stripe": 4}


def threat_enforce_config(redirect: bool = False) -> ThreatConfig:
    """The enforce leg of ``bench_suite.py:1116-1118`` (drop 245,
    rate-limit 170, 1e5 tokens/s, burst 2**16); ``redirect`` adds a
    redirect arm at score 200 to port 15003."""
    return ThreatConfig(mode="enforce", drop_score=245,
                        ratelimit_score=170, rate_per_s=1e5,
                        burst=1 << 16, generation=3,
                        redirect_score=200 if redirect else 0,
                        redirect_port=15003 if redirect else 0)


@dataclass
class L7ServingState:
    """A v4 serving state (``v4``) whose every endpoint also redirects
    HTTP ingress :80 from ``http_net`` to 15001 and DNS egress :53 to
    ``dns_net`` to 15002, the fused ``programs`` of the bench's rules
    for those ports, and the payload ``table``: one encoded row per
    string of ``strings`` (the 18 requests, the 4 names, an overlong
    request, and None for absent).  ``base`` is the state without the
    redirects, whose prefixes the pool traffic is drawn from."""

    v4: V4ServingState
    base: V4ServingState
    programs: L7FastPrograms
    http_net: int
    dns_net: int
    strings: List[Optional[str]]
    table: np.ndarray

    @property
    def n_http(self) -> int:
        return len(HTTP_PATHS) * len(HTTP_METHODS)

    @property
    def overlong_row(self) -> int:
        return len(self.strings) - 2

    @property
    def absent_row(self) -> int:
        return len(self.strings) - 1


def l7_fast_programs(window: int = L7_WINDOW) -> L7FastPrograms:
    """The bench's fused programs: the 4 HTTP rules on 15001, the 3
    FQDN selectors on 15002."""
    return build_fast_programs(
        [FastProgramSpec(port=L7_HTTP_PORT, protocol=FAST_HTTP,
                         patterns=tuple(classify_http(HTTP_RULES))),
         FastProgramSpec(port=L7_DNS_PORT, protocol=FAST_DNS,
                         patterns=tuple(classify_dns(FQDN_SELECTORS)))],
        window=window)


def _free_slash16(v4: V4ServingState, count: int) -> List[int]:
    """``count`` /16 networks in 100.64.0.0/10 that overlap no ipcache
    prefix, prefilter CIDR or pod CIDR of ``v4``."""
    taken = [ipaddress.ip_network(c, strict=False) for c in
             list(v4.prefixes) + list(v4.prefilter) + list(v4.tunnel)]
    out = []
    for second in range(64, 128):
        net = ipaddress.ip_network(f"100.{second}.0.0/16")
        if not any(net.overlaps(t) for t in taken):
            out.append(int(net.network_address))
            if len(out) == count:
                return out
    raise ValueError("no free /16 in 100.64.0.0/10")


def l7_serving_state(v4: V4ServingState,
                     window: int = L7_WINDOW) -> L7ServingState:
    """``v4`` plus the two redirects of the L7 fast-verdict bench on
    every endpoint and their peers' two /16 prefixes in the ipcache
    (overlapping none of the state's own); ``v4`` is not changed."""
    http_net, dns_net = _free_slash16(v4, 2)
    states = []
    for st in v4.states:
        st = PolicyMapState(st)
        st[PolicyKey(identity=L7_HTTP_ID, dest_port=80, nexthdr=6,
                     direction=INGRESS)] = \
            PolicyMapStateEntry(proxy_port=L7_HTTP_PORT)
        st[PolicyKey(identity=L7_DNS_ID, dest_port=53, nexthdr=17,
                     direction=EGRESS)] = \
            PolicyMapStateEntry(proxy_port=L7_DNS_PORT)
        states.append(st)
    prefixes = dict(v4.prefixes)
    for net, ident in ((http_net, L7_HTTP_ID), (dns_net, L7_DNS_ID)):
        prefixes[f"{ipaddress.ip_address(net)}/16"] = ident
    state = V4ServingState(
        states=states, prefixes=prefixes, services=v4.services,
        prefilter=v4.prefilter, tunnel=v4.tunnel,
        ep_identity=v4.ep_identity, ident_port=v4.ident_port)
    strings: List[Optional[str]] = [
        http_match_string(m, p, "admin.example.com")
        for p in HTTP_PATHS for m in HTTP_METHODS]
    strings += [dns_match_string(n) for n in L7_DNS_NAMES]
    strings += [http_match_string("GET", "/public/" + "p" * window,
                                  "admin.example.com"), None]
    return L7ServingState(v4=state, base=v4,
                          programs=l7_fast_programs(window),
                          http_net=http_net, dns_net=dns_net,
                          strings=strings,
                          table=encode_payloads(strings, window))


def _aim_l7(state: L7ServingState, packed: np.ndarray, rows: Dict,
            n_flows: int, rng) -> np.ndarray:
    """Rewrite, in place, the forward TCP rows of every tenth pool flow
    of a packed batch into L7 traffic: flows j = 0 (mod 20) become HTTP
    ingress to the client on :80 from ``http_net``, j = 10 (mod 20) DNS
    egress over UDP to ``dns_net`` :53.  ``rows`` maps a field to its
    row of ``packed`` (for an address, the row of its v4 word).  Returns
    each row's index into ``state.table``: the flow's request or name on
    the L7 rows (``L7_BAD_SHARES`` of them overlong or absent), absent
    elsewhere."""
    u32 = lambda f: packed[rows[f]].view(np.uint32)  # noqa: E731
    j = u32("saddr").astype(np.int64) - POOL_CLIENTS
    every = int(round(1 / L7_FLOW_SHARE))
    aimed = (packed[rows["direction"]] == 1) & \
        (packed[rows["proto"]] == 6) & (j >= 0) & (j < n_flows) & \
        (j % every == 0)
    http = aimed & (j % (2 * every) == 0)
    dns = aimed & ~http
    client = u32("saddr").copy()
    peer = (j & 0xFFFF).astype(np.uint32)
    for f, val in (("saddr", np.where(http, state.http_net + peer,
                                      client)),
                   ("daddr", np.where(http, client,
                                      np.where(dns, state.dns_net + peer,
                                               u32("daddr"))))):
        packed[rows[f]] = val.astype(np.uint32).view(np.int32)
    packed[rows["direction"]][http] = 0
    packed[rows["dport"]][http] = 80
    packed[rows["dport"]][dns] = 53
    packed[rows["proto"]][dns] = 17
    packed[rows["tcp_flags"]][dns] = 0
    b = packed.shape[1]
    # a flow's request or name is its own, so a flow denied inline stays
    # denied; overlong and absent payloads fall on rows at random
    idx = np.full(b, state.absent_row, np.int32)
    flow = j // (2 * every)
    idx[http] = flow[http] % state.n_http
    idx[dns] = state.n_http + flow[dns] % len(L7_DNS_NAMES)
    u = rng.random(b)
    bad_o = L7_BAD_SHARES["overlong"]
    idx[aimed & (u < bad_o)] = state.overlong_row
    idx[aimed & (u >= bad_o) & (u < bad_o + L7_BAD_SHARES["absent"])] = \
        state.absent_row
    return idx


def l7_serving_packets(state: L7ServingState, batch: int,
                       n_flows: int = 1 << 16, seed: int = 5
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (packed [10, batch], payload index [batch]) pairs:
    ``v4_serving_packets`` over ``state.base`` with every tenth pool
    flow aimed at the redirects (``_aim_l7``).  The payload lane of a
    batch is ``state.table[index]``."""
    rng = np.random.default_rng(seed + 1000)
    rows = {f: PACKED_FIELDS.index(f) for f in PACKED_FIELDS}
    for packed in v4_serving_packets(state.base, batch, n_flows, seed):
        yield packed, _aim_l7(state, packed, rows, n_flows, rng)


def l7_serving_packets6(state: L7ServingState, batch: int,
                        n_flows: int = 1 << 16, seed: int = 5
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The v6 twin of ``l7_serving_packets``, served by ``v6_of(
    state.v4)``: ``v6_serving_packets`` over ``v6_of(state.base)`` with
    the same rewrite on the low words of the embedded addresses."""
    rng = np.random.default_rng(seed + 1000)
    rows, row = {}, 0
    for f, width in PACKED6_FIELDS:
        rows[f] = row + width - 1       # an address's v4 word is its last
        row += width
    for packed in v6_serving_packets(v6_of(state.base), batch, n_flows,
                                     seed):
        yield packed, _aim_l7(state, packed, rows, n_flows, rng)


# ---------------------------------------------------------------------------
# Rules to verdicts: a rule set as users import it, and the policy path
# ---------------------------------------------------------------------------

POLICY_APPS = ("web", "api", "db", "cache", "auth", "queue", "search",
               "store")
POLICY_TIERS = ("front", "back", "data", "ops", "edge")
POLICY_PORTS = 200                 # distinct destination ports rules name
POLICY_ENDPOINT_ID_BASE = 1000
POLICY_HTTP_PATHS = ("/api/v1/.*", "/public/.*", "/static/.*", "/health")
# rule kinds and their shares (the kinds of tests/test_policygen_matrix.py:
# L3-only, L4 with and without fromEndpoints, HTTP on targeted rules,
# egress L3 / L4), with toCIDR / fromCIDR rules beside them; a few
# fromRequires rules are added on top (``policy_state``)
POLICY_KINDS = {"l3": 0.14, "l4": 0.22, "l4-any": 0.08, "l7": 0.10,
                "egress-l3": 0.12, "egress-l4": 0.16, "to-cidr": 0.10,
                "from-cidr": 0.08}


@dataclass
class PolicyState:
    """A rule set and the workloads it is written for.  ``rules_json`` is
    the rule text a user imports (``policy/jsonio.rules_from_json``);
    ``endpoints`` are the node's own (endpoint id, IPv4, labels) and
    ``peers`` the (IPv4, labels) of remote workloads; ``cidrs`` are the
    prefixes the rules name; ``ports`` the destination ports they name
    and ``stranger_ports`` ports that none names."""

    rules_json: str
    endpoints: List[Tuple[int, str, Tuple[str, ...]]]
    peers: List[Tuple[str, Tuple[str, ...]]]
    cidrs: List[str]
    ports: List[int]
    stranger_ports: List[int]


def _workload_labels(w: int) -> Tuple[str, ...]:
    return (f"k8s:app={POLICY_APPS[w % len(POLICY_APPS)]}",
            f"k8s:tier={POLICY_TIERS[(w // len(POLICY_APPS)) % len(POLICY_TIERS)]}")


def _policy_cidrs(n_cidrs: int) -> List[str]:
    """A quarter /16s in 172.16/12, the rest /24s: half inside those /16s
    (so a rule naming the /16 selects them), half in 192.168/16."""
    n16 = max(1, n_cidrs // 4) if n_cidrs else 0
    out = [f"172.{16 + j}.0.0/16" for j in range(n16)]
    for k in range(n_cidrs - n16):
        out.append(f"172.{16 + k % n16}.{k + 1}.0/24" if k % 2 == 0
                   else f"192.168.{k + 1}.0/24")
    return out


def policy_state(n_rules: int = 1000, n_endpoints: int = 16,
                 n_peers: int = 24, n_cidrs: int = 24, seed: int = 9
                 ) -> PolicyState:
    """``n_rules`` rules from a numpy seed over ``n_endpoints`` local
    endpoints and ``n_peers`` remote workloads (each with ``k8s:app=`` and
    ``k8s:tier=`` labels and an IPv4 in 10.128/16) and ``n_cidrs``
    prefixes, in the kinds of ``POLICY_KINDS``, plus one ``fromRequires``
    rule per 200 (at least one).  Destination ports come from a set of
    ``POLICY_PORTS``, TCP or UDP; HTTP rules (TCP) redirect to the proxy.
    Every rule carries a label ``k8s:rule=r<i>`` of its own."""
    rng = np.random.default_rng(seed)
    n_work = n_endpoints + n_peers
    ips = [f"10.128.{w // 250}.{w % 250 + 2}" for w in range(n_work)]
    endpoints = [(POLICY_ENDPOINT_ID_BASE + i, ips[i], _workload_labels(i))
                 for i in range(n_endpoints)]
    peers = [(ips[w], _workload_labels(w)) for w in range(n_endpoints,
                                                           n_work)]
    cidrs = _policy_cidrs(n_cidrs)
    ports = sorted(int(p) for p in rng.choice(np.arange(1, 65536),
                                              POLICY_PORTS, replace=False))
    named = set(ports)
    stranger = []
    while len(stranger) < 20:
        p = int(rng.integers(1, 65536))
        if p not in named and p not in stranger:
            stranger.append(p)

    def selector() -> Dict:
        roll = rng.random()
        app = POLICY_APPS[rng.integers(len(POLICY_APPS))]
        tier = POLICY_TIERS[rng.integers(len(POLICY_TIERS))]
        if roll < 0.6:
            return {"matchLabels": {"k8s:app": app}}
        if roll < 0.9:
            return {"matchLabels": {"k8s:tier": tier}}
        return {"matchLabels": {"k8s:app": app, "k8s:tier": tier}}

    def port_rule(l7: bool = False) -> Dict:
        proto = "TCP" if l7 or rng.random() < 0.7 else "UDP"
        pr: Dict = {"ports": [{"port": str(ports[rng.integers(len(ports))]),
                               "protocol": proto}]}
        if l7:
            pr["rules"] = {"http": [
                {"method": "GET",
                 "path": POLICY_HTTP_PATHS[rng.integers(
                     len(POLICY_HTTP_PATHS))]}]}
        return pr

    kinds = list(POLICY_KINDS)
    shares = np.array([POLICY_KINDS[k] for k in kinds])
    rules: List[Dict] = []
    for i in range(n_rules):
        kind = kinds[rng.choice(len(kinds), p=shares / shares.sum())]
        rule: Dict = {"endpointSelector": selector(),
                      "labels": [f"k8s:rule=r{i}"]}
        if kind == "l3":
            rule["ingress"] = [{"fromEndpoints": [selector()]}]
        elif kind == "l4":
            rule["ingress"] = [{"fromEndpoints": [selector()],
                                "toPorts": [port_rule()]}]
        elif kind == "l4-any":
            rule["ingress"] = [{"toPorts": [port_rule()]}]
        elif kind == "l7":
            rule["ingress"] = [{"fromEndpoints": [selector()],
                                "toPorts": [port_rule(l7=True)]}]
        elif kind == "egress-l3":
            rule["egress"] = [{"toEndpoints": [selector()]}]
        elif kind == "egress-l4":
            rule["egress"] = [{"toEndpoints": [selector()],
                               "toPorts": [port_rule()]}]
        elif kind == "to-cidr" and cidrs:
            eg: Dict = {"toCIDR": [cidrs[rng.integers(len(cidrs))]]}
            if rng.random() < 0.5:
                eg["toPorts"] = [port_rule()]
            rule["egress"] = [eg]
        elif kind == "from-cidr" and cidrs:
            rule["ingress"] = [{"fromCIDR": [cidrs[rng.integers(
                len(cidrs))]]}]
        else:                       # a CIDR kind without prefixes
            rule["ingress"] = [{"fromEndpoints": [selector()]}]
        rules.append(rule)
    for j in range(max(1, n_rules // 200)):
        rules.append({
            "endpointSelector": {"matchLabels": {
                "k8s:app": POLICY_APPS[rng.integers(len(POLICY_APPS))]}},
            "ingress": [{"fromRequires": [{"matchLabels": {
                "k8s:tier": POLICY_TIERS[rng.integers(
                    len(POLICY_TIERS))]}}]}],
            "labels": [f"k8s:rule=q{j}"]})
    return PolicyState(rules_json=json.dumps(rules, indent=2,
                                             sort_keys=True),
                       endpoints=endpoints, peers=peers, cidrs=cidrs,
                       ports=ports, stranger_ports=stranger)


def policy_remotes(state: PolicyState, seed: int = 11) -> List[str]:
    """The remote addresses of ``policy_packets``: every endpoint's and
    peer's IPv4, then 3 addresses inside each of the rules' prefixes
    (their own identities come from the ipcache's longest match)."""
    rng = np.random.default_rng(seed)
    out = [ip for _, ip, _ in state.endpoints] + [ip for ip, _ in
                                                   state.peers]
    for cidr in state.cidrs:
        net = ipaddress.ip_network(cidr)
        for off in rng.integers(1, net.num_addresses - 1, 3):
            out.append(str(net.network_address + int(off)))
    return out


def policy_packets(state: PolicyState, remotes: Sequence[str], batch: int,
                   seed: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """(packed [10, batch] int32, remote index [batch]): new connections
    (random source ports, TCP SYN or UDP) between the local endpoint in
    slot ``endpoint`` (endpoint i of ``state`` in slot i) and a remote
    of ``remotes``, half ingress (the remote is the source) and half
    egress (the remote is the destination), to a port the rules name or,
    for a fifth of the rows, one they do not; 70% TCP."""
    rng = np.random.default_rng(seed)
    n_ep = len(state.endpoints)
    u32 = lambda ip: int(ipaddress.IPv4Address(ip))  # noqa: E731
    ep_addr = np.array([u32(ip) for _, ip, _ in state.endpoints], np.int64)
    rem_addr = np.array([u32(ip) for ip in remotes], np.int64)
    slot = rng.integers(0, n_ep, batch)
    remote = rng.integers(0, len(remotes), batch)
    egress = rng.random(batch) < 0.5
    ports = np.where(rng.random(batch) < 0.2,
                     rng.choice(state.stranger_ports, batch),
                     rng.choice(state.ports, batch))
    udp = rng.random(batch) >= 0.7
    local, far = ep_addr[slot], rem_addr[remote]
    cols = {"endpoint": slot,
            "saddr": np.where(egress, local, far),
            "daddr": np.where(egress, far, local),
            "sport": rng.integers(1024, 65536, batch),
            "dport": ports,
            "proto": np.where(udp, 17, 6),
            "direction": egress.astype(np.int64),
            "tcp_flags": np.where(udp, 0, conntrack.TCP_SYN),
            "length": rng.integers(64, 1501, batch),
            "is_fragment": np.zeros(batch, np.int64)}
    packed = np.stack([cols[f].astype(np.uint32).view(np.int32)
                       if f in ("saddr", "daddr") else
                       cols[f].astype(np.int32) for f in PACKED_FIELDS])
    return packed, remote.astype(np.int32)


class PolicyRun:
    """Rules to verdicts: labels, identities, the policy repository, the
    endpoints with their build queue, the ipcache and the proxy's
    redirects, feeding a ``Datapath`` through a ``DeviceTableManager``.

    The port's stand-in for the daemon's policy path, wired as
    ``cilium_tpu/daemon/daemon.py`` wires it: ``endpoint_create`` as
    ``:1439-1500`` (table slot, identity from labels, the slot's
    identity on the engine, the IP in the ipcache, a build queued),
    ``policy_add`` / ``policy_delete`` as ``:599-646`` and ``:702-742``
    (sanitize, one CIDR-identity reference per prefix a rule names, the
    repository, every endpoint regenerated), ``_regenerate_endpoint`` as
    ``:1358-1397`` (regenerate against an identity-cache snapshot with
    the proxy, apply, ``sync_endpoint``, ``refresh_policy(rev)``) and
    the ipcache's debounced LPM reload as ``:324-331``.  The daemon
    itself is ported (``daemon/daemon.py``), and ``chip_smoke.py`` holds
    it against this run.  ``add_peer`` enters a remote workload as the
    kvstore's watchers do (the agent's come through the store).

    Builds run on the manager's builder threads; a build that raises
    leaves its endpoint ``not-ready`` (the reference's worker swallows
    the exception), so callers check ``endpoint_states`` after
    ``wait_for_policy_revision``.  Call ``shutdown`` to stop the
    threads."""

    def __init__(self, device: DeviceLike = None, ct_slots: int = 1 << 16):
        self.device = resolve_device(device)
        self.repo = Repository()
        self.allocator = LocalIdentityAllocator()
        self.ipcache = IPCache()
        self.proxy = ProxyManager(device=self.device)
        self.table_mgr = DeviceTableManager(device=self.device)
        self.datapath = Datapath(ct_slots=ct_slots, device=self.device)
        self.datapath.use_table_manager(self.table_mgr)
        self._lock = RMutex("policy-run")
        # prefix -> (CIDR identity, references); rule -> its prefixes
        self._cidr_idents: Dict[str, Tuple[Identity, int]] = {}
        self._rule_prefixes: Dict[int, List[str]] = {}
        # (endpoint id, revision, regeneration s, sync + refresh s) of
        # every build, in completion order
        self.builds: List[Tuple[int, int, float, float]] = []
        self.endpoints = EndpointManager(
            regenerate_fn=self._regenerate_endpoint)
        self._regen_trigger = Trigger(
            lambda reasons: self.endpoints.regenerate_all(
                ",".join(reasons) or "policy-update"),
            min_interval=0.01, name="policy-updates")
        self._lpm_trigger = Trigger(
            lambda _r: self.datapath.load_ipcache(
                *self.ipcache.to_lpm_prefix_families()),
            min_interval=0.01, name="ipcache-lpm")
        self.ipcache.add_listener(
            lambda *_a: self._lpm_trigger.trigger("ipcache"), replay=False)

    @classmethod
    def from_state(cls, state: PolicyState, **kwargs) -> "PolicyRun":
        """A run with ``state``'s endpoints and peers created and its
        rules imported from their JSON text; the builds may still be
        running (``wait_for_policy_revision``)."""
        run = cls(**kwargs)
        for ep_id, ip, labels in state.endpoints:
            run.endpoint_create(ep_id, ipv4=ip, labels=labels)
        for ip, labels in state.peers:
            run.add_peer(ip, labels)
        run.policy_add(rules_from_json(state.rules_json))
        return run

    # -------------------------------------------------------- endpoints

    def endpoint_create(self, endpoint_id: int, ipv4: str = "",
                        labels: Sequence[str] = ()) -> Endpoint:
        ep = Endpoint(endpoint_id, ipv4=ipv4)
        ep.table_slot = self.table_mgr.attach(endpoint_id)
        self.endpoints.insert(ep)
        ep.update_labels(self.allocator, Labels.from_model(list(labels)))
        self.datapath.set_endpoint_identity(ep.table_slot,
                                            ep.security_identity)
        if ipv4:
            self.ipcache.upsert(ipv4, ep.security_identity,
                                SOURCE_AGENT_LOCAL,
                                metadata=f"endpoint:{endpoint_id}")
        self.endpoints.queue_regeneration(endpoint_id)
        return ep

    def add_peer(self, ipv4: str, labels: Sequence[str]) -> Identity:
        """A remote workload: its identity, and its IP in the ipcache."""
        ident, _ = self.allocator.allocate(Labels.from_model(list(labels)))
        self.ipcache.upsert(ipv4, ident.id, SOURCE_KVSTORE)
        return ident

    # ----------------------------------------------------------- policy

    def policy_add(self, rules: Sequence[Rule]) -> int:
        for r in rules:
            r.sanitize()
        with self._lock:
            for r in rules:
                prefixes = rule_cidr_prefixes(r)
                self._retain_prefixes(prefixes)
                self._rule_prefixes[id(r)] = prefixes
            rev = self.repo.add_list(list(rules))
        self._regen_trigger.trigger("policy-add")
        return rev

    def policy_delete(self, labels: LabelArray) -> Tuple[int, int]:
        with self._lock:
            doomed = self.repo.search(labels) if len(labels) else \
                self.repo.rules
            rev, deleted = self.repo.delete_by_labels(labels)
            if deleted:
                for r in doomed:
                    self._release_prefixes(
                        self._rule_prefixes.pop(id(r), None) or
                        rule_cidr_prefixes(r))
        if deleted:
            self._regen_trigger.trigger("policy-delete")
        return rev, deleted

    def _retain_prefixes(self, prefixes: Sequence[str]) -> None:
        for p in prefixes:
            if p in self._cidr_idents:
                ident, n = self._cidr_idents[p]
                self._cidr_idents[p] = (ident, n + 1)
            else:
                allocated = allocate_cidr_identities(
                    self.allocator, self.ipcache, [p])
                self._cidr_idents[p] = (allocated[p], 1)

    def _release_prefixes(self, prefixes: Sequence[str]) -> None:
        for p in prefixes:
            ident, n = self._cidr_idents.get(p, (None, 0))
            if ident is None:
                continue
            if n <= 1:
                release_cidr_identities(self.allocator, self.ipcache,
                                        {p: ident})
                del self._cidr_idents[p]
            else:
                self._cidr_idents[p] = (ident, n - 1)

    def _regenerate_endpoint(self, ep: Endpoint) -> None:
        cache = IdentityCache.snapshot(self.allocator)
        res = ep.regenerate_policy(self.repo, cache, proxy=self.proxy)
        ep.apply_regeneration(res)
        t0 = time.perf_counter()
        self.table_mgr.sync_endpoint(ep.id, ep.realized, res.revision)
        self.datapath.refresh_policy(res.revision)
        self.builds.append((ep.id, res.revision, res.total.seconds(),
                            time.perf_counter() - t0))

    # ------------------------------------------------------------ waits

    def wait_for_policy_revision(self, revision: Optional[int] = None,
                                 timeout: float = 60.0) -> bool:
        """Block until every endpoint has applied ``revision`` (default:
        the repository's), the build queue is idle and the engine's LPM
        holds the ipcache's prefixes; False on timeout."""
        rev = self.repo.revision if revision is None else revision
        deadline = time.monotonic() + timeout

        def done() -> bool:
            return all(ep.policy_revision >= rev
                       for ep in self.endpoints.endpoints()) and \
                self.endpoints.wait_for_quiesce(0.05) and \
                self.datapath.ipcache_prefixes == \
                self.ipcache.to_lpm_prefix_families()[0]

        while time.monotonic() < deadline:
            if done():
                return True
            time.sleep(0.01)
        return done()

    def endpoint_states(self) -> Dict[int, Tuple[str, int]]:
        """{endpoint id: (state, realized policy revision)}."""
        return {ep.id: (ep.state, ep.policy_revision)
                for ep in self.endpoints.endpoints()}

    def shutdown(self) -> None:
        """Stop the builder and trigger threads."""
        self._regen_trigger.shutdown()
        self._lpm_trigger.shutdown()
        self.endpoints.shutdown()


def rule_cidr_prefixes(rule: Rule) -> List[str]:
    """Every CIDR prefix one rule names (``daemon.py:727-742``)."""
    out: List[str] = []
    for ing in rule.ingress:
        out.extend(ing.from_cidr)
        out.extend(c.cidr for c in ing.from_cidr_set)
    for eg in rule.egress:
        out.extend(eg.to_cidr)
        out.extend(c.cidr for c in eg.to_cidr_set)
    return sorted(set(out))
