"""A JAX agent and a port agent on one store.

The JAX package's ``Daemon`` and the port's ``Daemon(device="cpu")``
join one cluster through one ``MiniEtcd`` (the etcd gateway) or one
``KVStoreServer`` (the TCP store), each agent holding its own endpoints
and the same rules.  Identities, ipcache entries and nodes cross the
store in both directions with equal numbers, the two nodes give equal
verdicts for the same traffic, and the REST ``/kvstore`` routes answer
alike.  Seeded allocators hand out equal IDs in both packages.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cilium_tpu.daemon import Daemon as RefDaemon
from cilium_tpu.daemon.rest import APIServer as RefAPIServer
from cilium_tpu.kvstore.etcd import EtcdBackend as RefEtcdBackend
from cilium_tpu.kvstore.identity_allocator import \
    DistributedIdentityAllocator as RefDistributed
from cilium_tpu.kvstore.memory import InMemoryBackend as RefMemory
from cilium_tpu.kvstore.remote import RemoteBackend as RefRemoteBackend
from cilium_tpu.labels import Labels as RefLabels
from cilium_tpu.policy.jsonio import rules_from_json as ref_rules_from_json
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig

from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.daemon.rest import APIServer
from cilium_tpu_torch.identity import CLUSTER_ID_SHIFT
from cilium_tpu_torch.kvstore import (EtcdBackend, InMemoryBackend,
                                      KVStoreServer, MiniEtcd,
                                      RemoteBackend)
from cilium_tpu_torch.kvstore.identity_allocator import \
    DistributedIdentityAllocator
from cilium_tpu_torch.labels import Labels
from cilium_tpu_torch.policy.jsonio import rules_from_json
from cilium_tpu_torch.utils.option import DaemonConfig

WAIT_S = 60.0
# every identity the store hands out is above 2**16
CLUSTER_ID = 3
WEB, DB, TMP = "k8s:app=web", "k8s:app=db", "k8s:app=tmp"
# (endpoint id, last octet, labels) on each node; the JAX node's
# endpoints live in 10.1.0.0/24, the port's in 10.2.0.0/24
ENDPOINTS = ((1, 1, [WEB]), (2, 2, [DB]), (3, 3, ["k8s:app=only"]))
NODES = {"ref": ("node-j", "192.168.0.1", "10.1.0.0/24", 1),
         "port": ("node-p", "192.168.0.2", "10.2.0.0/24", 2)}
RULES = json.dumps([{
    "endpointSelector": {"matchLabels": {"app": "db"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"app": "web"}}],
                 "toPorts": [{"ports": [{"port": "5432",
                                         "protocol": "TCP"}]}]}],
    "labels": ["k8s:policy=kv-agents"],
}])


def _wait_for(cond, msg, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _net(side):
    return NODES[side][3]


def _settled(d):
    return d.wait_for_policy_revision(None, timeout=WAIT_S) and \
        d.datapath.ipcache_prefixes == d.ipcache.to_lpm_prefix_families()[0]


@pytest.fixture(scope="module", params=["etcd", "tcp"])
def cluster(request):
    """{"ref": JAX agent, "port": port agent} on one store, populated,
    with each node registered and each agent's LPM holding the other's
    endpoints."""
    if request.param == "etcd":
        srv = MiniEtcd(reap_interval=0.1).start()
        backends = (RefEtcdBackend(port=srv.port, lease_ttl=30.0),
                    EtcdBackend(port=srv.port, lease_ttl=30.0))
    else:
        srv = KVStoreServer(port=0, expire_interval=0.1).start()
        backends = (RefRemoteBackend(port=srv.port, lease_ttl=30.0),
                    RemoteBackend(port=srv.port, lease_ttl=30.0))
    agents = {}
    try:
        agents["ref"] = RefDaemon(
            config=RefDaemonConfig(state_dir="", drift_audit_interval_s=0,
                                   ct_checkpoint_interval_s=0,
                                   cluster_id=CLUSTER_ID),
            kvstore_backend=backends[0], node_name=NODES["ref"][0])
        agents["port"] = Daemon(
            config=DaemonConfig(state_dir="", drift_audit_interval_s=0,
                                cluster_id=CLUSTER_ID),
            kvstore_backend=backends[1], node_name=NODES["port"][0],
            device="cpu")
        for side, d in agents.items():
            for ep_id, octet, labels in ENDPOINTS:
                d.endpoint_create(ep_id, ipv4=f"10.{_net(side)}.0.{octet}",
                                  labels=list(labels))
            _name, ip, cidr, _n = NODES[side]
            d.register_node(ip, cidr)
        agents["ref"].policy_add(ref_rules_from_json(RULES))
        agents["port"].policy_add(rules_from_json(RULES))
        for side, d in agents.items():
            other = 3 - _net(side)
            _wait_for(lambda d=d, other=other: all(
                d.ipcache.lookup_by_ip(f"10.{other}.0.{o}") is not None
                for _e, o, _l in ENDPOINTS), f"{side} learned its peer")
            _wait_for(lambda d=d: _settled(d), f"{side} settled")
        yield request.param, srv, agents
    finally:
        for d in agents.values():
            d.shutdown()
        # the port's shutdown closes the backend it was given; the
        # reference leaves its backend to the caller
        backends[0].close()
        if "port" not in agents:
            backends[1].close()
        srv.shutdown()


def _ident(d, labels, pkg_labels):
    ident = d.identity_allocator.lookup_by_labels(
        pkg_labels.from_model(list(labels)))
    return None if ident is None else ident.id


def test_identities_cross_with_equal_ids(cluster):
    _kind, _srv, agents = cluster
    ref, port = agents["ref"], agents["port"]
    for _e, _o, labels in ENDPOINTS:
        ids = (_ident(ref, labels, RefLabels), _ident(port, labels, Labels))
        assert ids[0] is not None and ids[0] == ids[1], labels
        assert ids[0] >> CLUSTER_ID_SHIFT == CLUSTER_ID
    # one allocated by each side after start is seen by the other
    a, _ = port.identity_allocator.allocate(Labels.from_model([TMP]))
    b, _ = ref.identity_allocator.allocate(
        RefLabels.from_model(["k8s:app=late"]))
    _wait_for(lambda: ref.identity_allocator.lookup_by_id(a.id)
              is not None, "the JAX agent saw the port's identity")
    _wait_for(lambda: port.identity_allocator.lookup_by_id(b.id)
              is not None, "the port agent saw the JAX identity")
    assert sorted(str(l) for l in
                  port.identity_allocator.lookup_by_id(b.id).labels
                  .to_array()) == ["k8s:app=late"]
    assert sorted(str(l) for l in
                  ref.identity_allocator.lookup_by_id(a.id).labels
                  .to_array()) == [TMP]
    port.identity_allocator.release(a)
    ref.identity_allocator.release(b)


def test_ipcache_and_nodes_cross_both_ways(cluster):
    _kind, _srv, agents = cluster
    for side, d in agents.items():
        other_side = "port" if side == "ref" else "ref"
        other = agents[other_side]
        net = _net(other_side)
        for ep_id, octet, _labels in ENDPOINTS:
            ip = f"10.{net}.0.{octet}"
            want = other.endpoints.lookup(ep_id).security_identity
            assert d.ipcache.lookup_by_ip(ip) == want, (side, ip)
            assert d.datapath.ipcache_prefixes[f"{ip}/32"] == want
        name, node_ip, cidr, _n = NODES[other_side]
        full = f"default/{name}"
        assert full in {n.full_name for n in d.node_registry.nodes()}
        _wait_for(lambda d=d, cidr=cidr: cidr in
                  d.datapath.map_dump("tunnel"),
                  f"{side} tunnels to {cidr}")
        assert d.datapath.map_dump("tunnel") == {cidr: _ip_u32(node_ip)}


def _ip_u32(dotted):
    a, b, c, d = (int(x) for x in dotted.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def _batch(side, slot):
    """Ingress to the node's db endpoint from its own web endpoint, the
    peer node's web endpoint, the peer's third endpoint and the world,
    on 5432 and 80, SYN then ACK."""
    own, other = _net(side), 3 - _net(side)
    sources = [f"10.{own}.0.1", f"10.{other}.0.1", f"10.{other}.0.3",
               "10.9.9.9"]
    rows = [(s, dport, flags) for flags in (0x02, 0x10)
            for s in sources for dport in (5432, 80)]
    n = len(rows)
    return n, {
        "endpoint": np.full(n, slot, np.int32),
        "saddr": np.array([_ip_u32(s) for s, _p, _f in rows],
                          np.uint32).view(np.int32),
        "daddr": np.full(n, _ip_u32(f"10.{own}.0.2"),
                         np.uint32).view(np.int32),
        "sport": (41000 + np.arange(n) % 8).astype(np.int32),
        "dport": np.array([p for _s, p, _f in rows], np.int32),
        "proto": np.full(n, 6, np.int32),
        "direction": np.zeros(n, np.int32),
        "tcp_flags": np.array([f for _s, _p, f in rows], np.int32),
        "is_fragment": np.zeros(n, np.int32),
        "length": np.full(n, 128, np.int32)}


def test_verdicts_agree_on_both_nodes(cluster):
    _kind, _srv, agents = cluster
    out = {}
    for side, d in agents.items():
        n, recs = _batch(side, d.endpoints.lookup(2).table_slot)
        ticket = d.datapath.serving().submit_records(recs, n)
        v, ident = ticket.result(timeout=120)
        assert ticket.error is None
        out[side] = (np.asarray(v), np.asarray(ident))
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])
    v = out["port"][0]
    # web on 5432 from either node is allowed; everything else is not
    assert (v[[0, 2, 8, 10]] == 0).all()
    assert (np.delete(v, [0, 2, 8, 10]) < 0).all()


def _call(url, method, path, body=None):
    req = urllib.request.Request(
        url + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_rest_kvstore_routes_answer_alike(cluster):
    _kind, _srv, agents = cluster
    servers = {"ref": RefAPIServer(agents["ref"]).start(),
               "port": APIServer(agents["port"]).start()}
    try:
        urls = {k: s.base_url for k, s in servers.items()}
        script = [("PUT", "/kvstore/test/a", {"value": "1"}),
                  ("PUT", "/kvstore/test/b", {"value": "2"}),
                  ("GET", "/kvstore/test/a", None),
                  ("GET", "/kvstore/test/?prefix=1", None),
                  ("GET", "/kvstore/cilium/state/nodes/v1?prefix=true",
                   None),
                  ("DELETE", "/kvstore/test/a", None),
                  ("GET", "/kvstore/test/a", None),
                  ("DELETE", "/kvstore/test/?prefix=1", None),
                  ("GET", "/kvstore/test/?prefix=1", None)]
        answers = {}
        for side in ("ref", "port"):
            answers[side] = [_call(urls[side], m, p, b)
                             for m, p, b in script]
        assert answers["port"] == answers["ref"]
        assert [code for code, _ in answers["port"]] == \
            [200, 200, 200, 200, 200, 200, 404, 200, 200]
        assert answers["port"][3][1] == {"test/a": "1", "test/b": "2"}
        nodes = answers["port"][4][1]
        assert sorted(nodes) == [
            f"cilium/state/nodes/v1/default/{NODES[s][0]}"
            for s in ("ref", "port")]
        # a key one agent writes, the other reads
        _call(urls["ref"], "PUT", "/kvstore/test/x", {"value": "j"})
        assert _call(urls["port"], "GET", "/kvstore/test/x") == \
            (200, {"test/x": "j"})
        _call(urls["port"], "DELETE", "/kvstore/test/x")
        assert _call(urls["ref"], "GET", "/kvstore/test/x")[0] == 404
    finally:
        for s in servers.values():
            s.shutdown()


@pytest.mark.parametrize("seed", [1, 7, 2024])
def test_seeded_allocators_give_identical_ids(seed):
    """The port's allocator draws IDs with the reference's
    ``random.Random(seed)``: one label sequence, one ID sequence, in
    both packages, cluster bits included."""
    seq = [f"k8s:app=a{i}" for i in range(40)] + ["k8s:app=a3", WEB]
    ids = []
    for dist, labels, backend in (
            (RefDistributed, RefLabels, RefMemory()),
            (DistributedIdentityAllocator, Labels, InMemoryBackend())):
        alloc = dist(backend, "n1", cluster_id=5, seed=seed)
        try:
            ids.append([alloc.allocate(labels.from_model([s]))[0].id
                        for s in seq])
        finally:
            alloc.close()
            backend.close()
    assert ids[0] == ids[1]
    assert len(set(ids[1])) == 41
    assert all(i >> CLUSTER_ID_SHIFT == 5 for i in ids[1])


def test_an_unreachable_store_fails_as_in_the_reference():
    """No fallback hides the store: a backend that cannot reach its
    store fails in the port as in the reference, and the agent never
    starts on a node-local allocator instead."""
    errors = []
    for cls in (RefEtcdBackend, EtcdBackend):
        with pytest.raises(Exception) as info:
            cls(port=1, lease_ttl=5.0, timeout=0.5)
        errors.append(type(info.value).__name__)
    assert errors[0] == errors[1]
