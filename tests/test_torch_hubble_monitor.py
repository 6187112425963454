"""The monitor, the Hubble observer and relay, and the agent's small host
parts: the JAX package's vs the port's, on the same events.

One seeded batch of datapath events (event codes, endpoints, identities,
ports, protocols, lengths, provenance tiers and match slots, the packed
threat lane) goes through both packages' ``MonitorHub`` (numpy arrays
into the reference's, torch tensors into the port's), with agent and L7
notifications beside it; a ``FlowObserver`` follows each hub.  Samples,
counts, per-rule drops, flows under a set of filters, the relay's
federated answer and the cross-process monitor stream must be equal
apart from wall-clock fields.  The node manager, the clustermesh, the
host-scope IPAM, the backoff and the controllers are compared on the
same inputs.
"""

import time

import numpy as np
import pytest
import torch

from cilium_tpu import ipam as ref_ipam
from cilium_tpu import monitor as ref_monitor
from cilium_tpu import proxy as ref_proxy
from cilium_tpu.clustermesh import ClusterMesh as RefClusterMesh
from cilium_tpu.hubble import filter as ref_filter
from cilium_tpu.hubble import flow as ref_flow
from cilium_tpu.hubble.observer import FlowObserver as RefFlowObserver
from cilium_tpu.hubble.relay import HubbleRelay as RefHubbleRelay
from cilium_tpu.ipcache.ipcache import IPCache as RefIPCache
from cilium_tpu.node import NodeManager as RefNodeManager
from cilium_tpu.node.node import Node as RefNode
from cilium_tpu.node.node import NodeAddress as RefNodeAddress
from cilium_tpu.utils.backoff import Exponential as RefExponential

from cilium_tpu_torch import ipam, monitor, proxy
from cilium_tpu_torch.clustermesh import ClusterMesh
from cilium_tpu_torch.datapath.events import DROP_NAMES, TRACE_NAMES
from cilium_tpu_torch.hubble import filter as flt_mod
from cilium_tpu_torch.hubble import flow as flow_mod
from cilium_tpu_torch.hubble.observer import FlowObserver
from cilium_tpu_torch.hubble.relay import HubbleRelay
from cilium_tpu_torch.ipcache.ipcache import IPCache
from cilium_tpu_torch.node import NodeManager
from cilium_tpu_torch.node.node import Node, NodeAddress
from cilium_tpu_torch.utils.backoff import Exponential
from cilium_tpu_torch.utils.controller import (ControllerManager,
                                               ControllerParams)

REF = dict(monitor=ref_monitor, proxy=ref_proxy, filter=ref_filter,
           flow=ref_flow, FlowObserver=RefFlowObserver,
           HubbleRelay=RefHubbleRelay, ipam=ref_ipam,
           NodeManager=RefNodeManager, Node=RefNode,
           NodeAddress=RefNodeAddress, IPCache=RefIPCache,
           ClusterMesh=RefClusterMesh, Exponential=RefExponential,
           lane=np.asarray)
PORT = dict(monitor=monitor, proxy=proxy, filter=flt_mod, flow=flow_mod,
            FlowObserver=FlowObserver, HubbleRelay=HubbleRelay, ipam=ipam,
            NodeManager=NodeManager, Node=Node, NodeAddress=NodeAddress,
            IPCache=IPCache, ClusterMesh=ClusterMesh,
            Exponential=Exponential, lane=torch.as_tensor)
PKGS = {"ref": REF, "port": PORT}


def events(seed: int, batch: int = 512):
    """One batch of datapath event lanes, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    codes = np.array(sorted(DROP_NAMES) + sorted(TRACE_NAMES), np.int32)
    code = rng.choice(codes, batch, p=None).astype(np.int32)
    slots = rng.integers(-1, 40, batch).astype(np.int32)
    return dict(
        event_codes=code,
        endpoints=rng.integers(0, 8, batch).astype(np.int32),
        identities=rng.choice([2, 256, 257, 300, 4096, 70000],
                              batch).astype(np.int32),
        dports=rng.choice([0, 53, 80, 443, 8080], batch).astype(np.int32),
        protos=rng.choice([1, 6, 17, 58], batch).astype(np.int32),
        lengths=rng.integers(40, 1500, batch).astype(np.int32),
        tiers=rng.integers(0, 13, batch).astype(np.int32),
        match_slots=slots,
        threat_out=(rng.integers(0, 256, batch)
                    | (rng.integers(0, 4, batch) << 8)
                    | (rng.integers(0, 2, batch) << 10)).astype(np.int32))


def rule_of(slot) -> str:
    return f"identity={slot},dport=80,proto=6,ingress" if slot % 3 else ""


def l7_proto_of(slot) -> str:
    return ("http", "kafka", "dns", "")[slot % 4]


def drive(pkg, seed: int = 4):
    """A hub fed two batches and some agent and L7 notifications, with
    an observer following it."""
    hub = pkg["monitor"].MonitorHub(ring_capacity=256, samples_per_batch=8)
    obs = pkg["FlowObserver"](node="node-a", capacity=128)
    obs.attach_monitor(hub)
    log = pkg["proxy"].AccessLog()
    obs.attach_access_log(log)
    log.subscribers.append(hub.notify_l7)
    for i, s in enumerate((seed, seed + 1)):
        ev = {k: pkg["lane"](v) for k, v in events(s).items()}
        if i == 0:
            hub.ingest_batch(**ev, rule_of=rule_of,
                             l7_proto_of=l7_proto_of)
        else:
            hub.ingest_batch(ev["event_codes"], ev["endpoints"],
                             ev["identities"], ev["dports"], ev["protos"],
                             ev["lengths"])
    hub.notify_agent("policy-updated", "revision=2 rules=3")
    hub.notify_agent("endpoint-created", "id=5 ipv4=10.0.0.5")
    for i, (verdict, info) in enumerate((
            ("forwarded", {"method": "GET", "path": "/public/a",
                           "status": 200}),
            ("denied", {"method": "POST", "path": "/admin",
                        "status": 403}),
            ("forwarded", {"query": "example.com", "rcode": 0}))):
        log.log(pkg["proxy"].AccessLogEntry(
            timestamp=1000.0 + i, proxy_id=f"p{i}",
            l7_protocol="dns" if "query" in info else "http",
            verdict=verdict, src_identity=256 + i, dst_identity=300,
            info=info))
    return hub, obs


def _event(e):
    d = ref_monitor._monitor_event_dict(e)
    d.pop("timestamp")
    return d


def _flow(f):
    d = dict(f if isinstance(f, dict) else f.to_dict())
    d.pop("timestamp")
    return d


@pytest.fixture(scope="module")
def driven():
    return {name: drive(pkg) for name, pkg in PKGS.items()}


def test_monitor_hub_matches(driven):
    (h_r, _o), (h_p, _p) = driven["ref"], driven["port"]
    for kwargs in ({}, {"n": 5}, {"drops_only": True}, {"kind": "agent"},
                   {"kind": "l7"}, {"kind": ""}, {"since": 10, "n": 7}):
        assert [_event(e) for e in h_p.tail(**kwargs)] == \
            [_event(e) for e in h_r.tail(**kwargs)], kwargs
    assert [e.describe() for e in h_p.tail(300)] == \
        [e.describe() for e in h_r.tail(300)]
    assert h_p.stats() == h_r.stats()
    assert h_p.top_dropped_rules(10) == h_r.top_dropped_rules(10)
    assert (h_p.lost, h_p.last_seq) == (h_r.lost, h_r.last_seq)
    assert len(h_p.tail(300)) > 20


FILTERS = [{}, {"verdict": "dropped"}, {"verdict": "FORWARDED"},
           {"drop_reason": "-130"}, {"identity": "256"},
           {"src_identity": "257"}, {"dport": "80"}, {"proto": "udp"},
           {"proto": "6"}, {"tier": "l4-rule"}, {"endpoint": "3"},
           {"l7_protocol": "http"}, {"l7_method": "GET"},
           {"l7_path": "/pub"}, {"l7_status": "403"}, {"since": "12"},
           {"node": "node-b"}]


@pytest.mark.parametrize("query", FILTERS,
                         ids=[",".join(q) or "all" for q in FILTERS])
def test_observer_filters_match(driven, query):
    (_h, o_r), (_g, o_p) = driven["ref"], driven["port"]
    f_r = ref_filter.FlowFilter.from_query(query)
    f_p = flt_mod.FlowFilter.from_query(query)
    assert f_p.to_query() == f_r.to_query()
    got = [_flow(f) for f in o_p.get_flows(f_p, limit=500)]
    assert got == [_flow(f) for f in o_r.get_flows(f_r, limit=500)]
    assert [flow_mod.flow_from_dict(f).describe() for f in
            o_p.get_flows(f_p, limit=500)] == \
        [ref_flow.flow_from_dict(f).describe() for f in
         o_r.get_flows(f_r, limit=500)]


@pytest.mark.parametrize("fn,value", [
    ("parse_proto", "tcp"), ("parse_proto", "ICMPv6"), ("parse_proto", "17"),
    ("parse_proto", "bogus"), ("parse_verdict", "redirected"),
    ("parse_verdict", "maybe"), ("parse_drop_reason", "Prefilter denied"),
    ("parse_drop_reason", "policy"),
    ("parse_drop_reason", "-130"), ("parse_drop_reason", "nope"),
    ("parse_tier", "deny"), ("parse_tier", "7"), ("parse_tier", "x")])
def test_filter_parsers_match(fn, value):
    def run(mod):
        try:
            return getattr(mod, fn)(value)
        except ValueError as exc:
            return ("ValueError", str(exc))
    assert run(flt_mod) == run(ref_filter)


def test_observer_stats_and_flow_dicts_match(driven):
    (_h, o_r), (_g, o_p) = driven["ref"], driven["port"]
    assert o_p.stats() == o_r.stats()
    assert o_p.last_seq == o_r.last_seq
    for d in o_p.get_flows(limit=20):
        f = flow_mod.flow_from_dict(d)
        assert f.to_dict() == d
        assert _flow(ref_flow.flow_from_dict(d)) == _flow(f)


def test_relay_answers_match(driven):
    """The federated answer over the local observer and a peer that
    fails: flows merged in order, the failing peer flagged."""
    def build(pkg, obs):
        def local(query, since, limit):
            flt = pkg["filter"].FlowFilter.from_query(query)
            return {"flows": obs.get_flows(flt, since=since, limit=limit)}

        def broken(query, since, limit):
            raise OSError("peer down")
        relay = pkg["HubbleRelay"](local_name="node-a", local_fetch=local,
                                   deadline_s=5.0)
        relay.add_peer("node-z", broken)
        return relay

    answers = []
    for name in ("ref", "port"):
        pkg, (_hub, obs) = PKGS[name], driven[name]
        relay = build(pkg, obs)
        out = relay.get_flows(pkg["filter"].FlowFilter(verdict="DROPPED"),
                              limit=50)
        flows = [_flow(f) for f in out["flows"]]
        nodes = [{k: v for k, v in n.items() if k != "seconds"}
                 for n in out["nodes"]]
        answers.append((flows, nodes, out["partial"], relay.peers()))
    assert answers[0] == answers[1]
    assert answers[1][2] is True and answers[1][0]


def test_monitor_stream_matches():
    """``MonitorServer`` replays the ring, then follows live events, in
    both packages, each framing with its own kvstore server's
    frames."""
    streams = []
    for pkg in (REF, PORT):
        hub = pkg["monitor"].MonitorHub(ring_capacity=64)
        for i in range(5):
            hub.notify_agent("endpoint-created", f"id={i}")
        srv = pkg["monitor"].MonitorServer(hub).start()
        try:
            follow = pkg["monitor"].monitor_follow(srv.port, replay=3)
            got = [next(follow) for _ in range(3)]
            hub.notify_agent("policy-updated", "revision=9")
            got.append(next(follow))
            follow.close()
        finally:
            srv.shutdown()
        for g in got:
            g.pop("timestamp")
        streams.append(got)
    assert streams[0] == streams[1]
    assert [g["note"] for g in streams[1]] == [
        "endpoint-created id=2", "endpoint-created id=3",
        "endpoint-created id=4", "policy-updated revision=9"]


# ------------------------------------------------ nodes, IPAM, controllers

def test_node_manager_and_clustermesh_match():
    out = []
    for pkg in (REF, PORT):
        ipc = pkg["IPCache"]()
        mgr = pkg["NodeManager"]("default/self", ipcache=ipc)
        node = pkg["Node"]
        addr = pkg["NodeAddress"]
        mgr.node_updated(node(name="self", addresses=[addr(
            "InternalIP", "192.168.0.1")], ipv4_alloc_cidr="10.1.0.0/24"))
        mgr.node_updated(node(name="b", addresses=[addr(
            "InternalIP", "192.168.0.2")], ipv4_alloc_cidr="10.2.0.0/24"))
        mgr.node_updated(node(name="c", addresses=[addr(
            "InternalIP", "192.168.0.3")], ipv4_alloc_cidr="10.3.0.0/24"))
        mgr.node_updated(node(name="b", addresses=[addr(
            "InternalIP", "192.168.0.2")], ipv4_alloc_cidr="10.4.0.0/24"))
        mgr.node_deleted("default/c")
        mesh = pkg["ClusterMesh"](ipcache=ipc,
                                  on_node_update=mgr.node_updated,
                                  on_node_delete=mgr.node_deleted)
        out.append((sorted(mgr.tunnel_map.items()), len(mgr),
                    [n.to_model() for n in mgr.nodes()],
                    mgr.tunnel_endpoint_for("10.4.0.0/24"),
                    ipc.to_lpm_prefix_families(), mesh.status(),
                    mesh.peer_nodes()))
        mesh.close()
    assert out[0] == out[1]


def test_host_scope_ipam_matches():
    out = []
    for pkg in (REF, PORT):
        pool = pkg["ipam"].HostScopeIPAM("10.200.0.0/29")
        steps = [pool.router_ip()]
        for owner in ("a", "b", "c", "d", "e"):
            try:
                steps.append(pool.allocate_next(owner))
            except pkg["ipam"].IPAMError as exc:
                steps.append(("IPAMError", str(exc)))
        for ip, owner in (("10.200.0.3", "x"), ("10.9.0.1", "y")):
            try:
                steps.append(pool.allocate_ip(ip, owner))
            except pkg["ipam"].IPAMError as exc:
                steps.append(("IPAMError", str(exc)))
        steps += [pool.release("10.200.0.3"),
                  pool.release_if_owner("10.200.0.4", "nobody"),
                  pool.release_if_owner("10.200.0.4", "b"),
                  pool.owner_of("10.200.0.5"), pool.allocated(), len(pool)]
        out.append(steps)
    assert out[0] == out[1]


def test_backoff_durations_match():
    for kwargs in ({"min_s": 0.1, "max_s": 2.0}, {"min_s": 1.0},
                   {"min_s": 0.05, "max_s": 1.0, "factor": 3.0}):
        a, b = Exponential(**kwargs), RefExponential(**kwargs)
        assert [a.duration(i) for i in range(8)] == \
            [b.duration(i) for i in range(8)]


def test_controllers_run_retry_and_report():
    """A controller runs at once and on its interval, a failing one
    retries with backoff and is reported failing after three runs in a
    row, and ``remove_all`` stops every thread."""
    mgr = ControllerManager()
    runs = {"ok": 0, "bad": 0}

    def ok():
        runs["ok"] += 1

    def bad():
        runs["bad"] += 1
        raise RuntimeError("boom")

    try:
        mgr.update_controller("ok", ControllerParams(do_func=ok,
                                                     run_interval=0.01))
        mgr.update_controller("bad", ControllerParams(
            do_func=bad, error_retry_base=0.001))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not (
                runs["ok"] >= 3 and mgr.failing()):
            time.sleep(0.01)
        failing = mgr.failing()
        assert [f["name"] for f in failing] == ["bad"]
        assert "boom" in failing[0]["last-error"]
        status = {c["name"]: c for c in mgr.status_model()}
        assert status["ok"]["success-count"] >= 3
        assert status["bad"]["consecutive-failure-count"] >= 3
    finally:
        mgr.remove_all()
    n = dict(runs)
    time.sleep(0.05)
    assert runs == n
