"""The list/watch transport across packages: the port's ``K8sClient`` and
reflectors against the JAX package's ``FakeAPIServer``, and the JAX
client against the port's fake.

Each case of ``tests/test_k8s_transport.py`` runs in both pairings: LIST,
the chunked WATCH stream, 410 Gone on a compacted version, a reflector
feeding a ``K8sWatcher`` and its agent (the client's package, the port's
on the CPU) until the policy's verdicts change, the re-watch from the
last version after a stream drop, the full relist after 410 (deletions
made meanwhile reconstructed), the resourceVersion dedup of a relist and
the transport's stop.  Both fakes must also serve the same bytes for the
same script.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from cilium_tpu.daemon import Daemon as RefDaemon
from cilium_tpu.datapath.engine import make_full_batch as ref_make_batch
from cilium_tpu.k8s import K8sWatcher as RefWatcher
from cilium_tpu.k8s import client as ref_client
from cilium_tpu.k8s.fake_apiserver import FakeAPIServer as RefFake
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig

from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.datapath.engine import make_full_batch
from cilium_tpu_torch.k8s import K8sWatcher
from cilium_tpu_torch.k8s import client
from cilium_tpu_torch.k8s.fake_apiserver import FakeAPIServer
from cilium_tpu_torch.utils.option import DaemonConfig

CNP_PATH = "/apis/cilium.io/v2/ciliumnetworkpolicies"
POD_PATH = "/api/v1/pods"

REF = dict(client=ref_client, Watcher=RefWatcher,
           agent=lambda: RefDaemon(config=RefDaemonConfig(state_dir="")),
           batch=ref_make_batch)
PORT = dict(client=client, Watcher=K8sWatcher,
            agent=lambda: Daemon(config=DaemonConfig(state_dir=""),
                                 device="cpu"),
            batch=lambda **kw: make_full_batch(device="cpu", **kw))

# (the client's package, the fake apiserver's class)
PAIRS = {"port-client-jax-fake": (PORT, RefFake),
         "jax-client-port-fake": (REF, FakeAPIServer)}


def _cnp(name="web-policy", port="80", ns="prod", app="web"):
    return {
        "apiVersion": "cilium.io/v2", "kind": "CiliumNetworkPolicy",
        "metadata": {"name": name, "namespace": ns},
        "spec": {
            "endpointSelector": {"matchLabels": {"app": app}},
            "ingress": [{"fromEndpoints": [
                {"matchLabels": {"app": "client"}}],
                "toPorts": [{"ports": [
                    {"port": port, "protocol": "TCP"}]}]}],
        },
    }


def _pod(name, ip, ns="prod", labels=None):
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": ns,
                     "labels": labels or {"app": "web"}},
        "status": {"podIP": ip, "hostIP": "192.168.1.10",
                   "phase": "Running"},
        "spec": {},
    }


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    """(client package, running fake of the other package)."""
    pkg, fake_cls = PAIRS[request.param]
    fake = fake_cls().start()
    try:
        yield pkg, fake
    finally:
        fake.shutdown()


@pytest.fixture()
def wired(pair):
    """(client package, fake, agent, watcher) with the agent and the
    watcher stopped at the end."""
    pkg, fake = pair
    d = pkg["agent"]()
    kw = pkg["Watcher"](d)
    try:
        yield pkg, fake, d, kw
    finally:
        kw.stop()
        d.shutdown()


def _wait(fn, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


# ------------------------------------------------------------ raw client

def test_client_list_and_watch_stream(pair):
    pkg, fake = pair
    c = pkg["client"].K8sClient(fake.base_url)
    fake.upsert("ciliumnetworkpolicies", _cnp("a"))
    items, rv = c.list(CNP_PATH)
    assert len(items) == 1 and items[0]["metadata"]["name"] == "a"
    got = []

    def consume():
        for etype, obj in c.watch(CNP_PATH, rv):
            got.append((etype, obj["metadata"]["name"]))
            if len(got) >= 3:
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)
    fake.upsert("ciliumnetworkpolicies", _cnp("b"))
    fake.upsert("ciliumnetworkpolicies", _cnp("b", port="81"))
    fake.delete("ciliumnetworkpolicies", "prod", "b")
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [("ADDED", "b"), ("MODIFIED", "b"), ("DELETED", "b")]


def test_watch_from_compacted_version_is_gone(pair):
    pkg, fake = pair
    c = pkg["client"].K8sClient(fake.base_url)
    fake.upsert("ciliumnetworkpolicies", _cnp("a"))
    fake.upsert("ciliumnetworkpolicies", _cnp("b"))
    fake.compact()
    with pytest.raises(pkg["client"].GoneError):
        for _ in c.watch(CNP_PATH, "1"):
            pass


def _raw(fake, path, lines=0):
    """The body of a GET: the whole of a list, or the first ``lines``
    frames of a watch stream."""
    conn = http.client.HTTPConnection("127.0.0.1", fake.port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        if not lines:
            return resp.status, json.loads(resp.read())
        out = []
        for raw in resp:
            if raw.strip():
                out.append(json.loads(raw))
            if len(out) >= lines:
                break
        return resp.status, out
    finally:
        conn.close()


def test_both_fakes_serve_the_same_wire():
    """The same script of upserts and deletes gives the same list body,
    the same watch frames and the same 410 frame from either fake."""
    out = []
    for fake_cls in (RefFake, FakeAPIServer):
        fake = fake_cls().start()
        try:
            fake.upsert("ciliumnetworkpolicies", _cnp("a"))
            fake.upsert("pods", _pod("p1", "10.0.0.1"))
            fake.upsert("ciliumnetworkpolicies", _cnp("a", port="81"))
            fake.delete("pods", "prod", "p1")
            fake.upsert("pods", _pod("p2", "10.0.0.2"))
            res = [_raw(fake, CNP_PATH), _raw(fake, POD_PATH),
                   _raw(fake, f"{POD_PATH}?watch=true&resourceVersion=0",
                        lines=3),
                   _raw(fake, "/api/v1/nope")]
            fake.compact()
            res.append(_raw(fake, f"{POD_PATH}?watch=true&"
                            "resourceVersion=1", lines=1))
            out.append((res, fake.list_requests, fake.watch_requests))
        finally:
            fake.shutdown()
    assert out[1] == out[0]
    assert out[1][0][4][1][0]["object"]["code"] == 410


# ----------------------------------------------------------- reflector

def test_reflector_feeds_watcher_and_agent_enforces(wired):
    """Object in the fake apiserver -> LIST/WATCH -> K8sWatcher ->
    repository -> the step's verdicts."""
    pkg, fake, d, kw = wired
    d.endpoint_create(1, ipv4="10.0.0.31", labels=[
        "k8s:app=client", "k8s:io.kubernetes.pod.namespace=prod"])
    db = d.endpoint_create(2, ipv4="10.0.0.32", labels=[
        "k8s:app=web", "k8s:io.kubernetes.pod.namespace=prod"])
    transport = pkg["client"].K8sTransport(kw, fake.base_url)
    try:
        transport.start()
        assert transport.wait_synced(10)
        fake.upsert("ciliumnetworkpolicies", _cnp())
        assert _wait(lambda: kw.events_by_kind.get("cnp", 0) >= 1)
        assert kw.wait_idle(10)
        assert d.wait_for_policy_revision()
        slot = db.table_slot
        batch = pkg["batch"](
            endpoint=[slot, slot], saddr=["10.0.0.31", "10.0.0.31"],
            daddr=["10.0.0.32", "10.0.0.32"], sport=[40100, 40101],
            dport=[80, 22], direction=[0, 0])
        v = np.asarray(d.datapath.process(batch)[0])
        assert v[0] >= 0 and v[1] < 0
        fake.delete("ciliumnetworkpolicies", "prod", "web-policy")
        assert _wait(lambda: kw.events_by_kind.get("cnp", 0) >= 2)
        assert kw.wait_idle(10)
        assert _wait(lambda: d.repo.revision >= 3)
    finally:
        transport.stop()


def test_reflector_reconnects_after_stream_drop(wired):
    """The server drops every watch stream; the reflector re-watches
    from its last version and the event made in the gap arrives
    without a relist."""
    pkg, fake, d, kw = wired
    cl = pkg["client"]
    r = cl.Reflector(cl.K8sClient(fake.base_url), POD_PATH, "pod",
                     kw).start()
    try:
        assert r.synced.wait(10)
        fake.upsert("pods", _pod("p1", "10.0.0.41"))
        assert _wait(lambda: kw.events_by_kind.get("pod", 0) >= 1)
        relists_before = r.relists
        fake.disconnect_watchers()
        fake.upsert("pods", _pod("p2", "10.0.0.42"))
        assert _wait(lambda: kw.events_by_kind.get("pod", 0) >= 2)
        assert _wait(lambda: r.rewatches >= 2)
        assert r.relists == relists_before
        assert d.ipcache.lookup_by_ip("10.0.0.42") is not None
    finally:
        r.stop()


def test_reflector_410_gone_triggers_full_relist(wired):
    """Compaction during a partition: the watch answers 410, the
    reflector relists and converges, the deletion made meanwhile
    included."""
    pkg, fake, d, kw = wired
    cl = pkg["client"]
    fake.upsert("pods", _pod("stay", "10.0.0.51"))
    fake.upsert("pods", _pod("doomed", "10.0.0.52"))
    r = cl.Reflector(cl.K8sClient(fake.base_url), POD_PATH, "pod",
                     kw).start()
    try:
        assert r.synced.wait(10)
        assert _wait(lambda: d.ipcache.lookup_by_ip("10.0.0.52")
                     is not None)
        relists_before = r.relists
        fake.delete("pods", "prod", "doomed")
        fake.upsert("pods", _pod("newcomer", "10.0.0.53"))
        fake.compact()
        fake.disconnect_watchers()
        assert _wait(lambda: r.relists > relists_before)
        assert _wait(lambda: d.ipcache.lookup_by_ip("10.0.0.53")
                     is not None)
        assert _wait(lambda: d.ipcache.lookup_by_ip("10.0.0.52") is None)
        assert d.ipcache.lookup_by_ip("10.0.0.51") is not None
    finally:
        r.stop()


def test_relist_resync_is_deduped_by_resource_version(wired):
    """A relist re-delivers every object; the watcher's resourceVersion
    dedup drops the unchanged ones."""
    pkg, fake, d, kw = wired
    cl = pkg["client"]
    fake.upsert("pods", _pod("p1", "10.0.0.61"))
    r = cl.Reflector(cl.K8sClient(fake.base_url), POD_PATH, "pod",
                     kw).start()
    try:
        assert r.synced.wait(10)
        assert _wait(lambda: kw.events_by_kind.get("pod", 0) == 1)
        fake.upsert("services", {
            "metadata": {"name": "svc", "namespace": "prod"},
            "spec": {"clusterIP": "10.96.0.99",
                     "ports": [{"port": 80, "protocol": "TCP"}]}})
        fake.compact()
        fake.disconnect_watchers()
        assert _wait(lambda: r.relists >= 2)
        time.sleep(0.3)
        assert kw.events_by_kind.get("pod", 0) == 1
    finally:
        r.stop()


def test_transport_stop_terminates_reflector_threads(wired):
    pkg, fake, _d, kw = wired
    transport = pkg["client"].K8sTransport(kw, fake.base_url).start()
    assert transport.wait_synced(10)
    assert sorted(r.kind for r in transport.reflectors) == \
        sorted(ref_client.WATCHED_RESOURCES.values())
    transport.stop()
    assert not [r.kind for r in transport.reflectors
                if r._thread.is_alive()]


def test_watched_resources_and_paths_match():
    from cilium_tpu.k8s import fake_apiserver as ref_fake_mod

    from cilium_tpu_torch.k8s import fake_apiserver as fake_mod
    assert client.WATCHED_RESOURCES == ref_client.WATCHED_RESOURCES
    assert fake_mod.RESOURCE_PATHS == ref_fake_mod.RESOURCE_PATHS
    assert fake_mod.LIST_KINDS == ref_fake_mod.LIST_KINDS
