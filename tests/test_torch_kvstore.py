"""The port's kvstore layer on the CPU: the cases of the JAX package's
``tests/test_kvstore.py``, ``test_etcd_backend.py``,
``test_remote_kvstore.py``, ``test_control_plane_chaos.py`` and
``test_transport_chaos.py`` run on ``cilium_tpu_torch``'s copies.

- the in-process backend, the shared store and the master/slave-key
  allocator with its identity binding;
- the etcd v3 JSON-gateway client against ``MiniEtcd`` and the TCP
  frame client against ``KVStoreServer``, with lease reaping after a
  kill -9 of ``python -m cilium_tpu_torch.cli agent`` on either store;
- the outage guard, its write journal and the identity fallback, and
  the whole outage journey of a port agent (``Daemon(device="cpu")``)
  through a ``ControlPlaneFaultInjector``;
- the transport faults: the compaction relist, the ambiguous lock txn
  and the lost create_only reply;
- the loudness lint over the port's ``DEGRADED_SIGNALS``.

These hold the port to the reference's own expectations;
``test_torch_kvstore_outage.py`` runs the journal, guard, fallback,
transport-fault and outage-journey scripts on both packages and
compares them step by step.

The apiserver cases wait for the host integrations (ROADMAP.md queue
1 item 8.4) and the function-queue case for its module; the verdict
service's stall cases are not kvstore cases.  Every server, backend
and agent is closed in ``finally`` or in a fixture, so no watch,
keepalive or lease thread outlives its test.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.identity import (LOCAL_SCOPE_IDENTITY_BASE,
                                       MINIMAL_NUMERIC_IDENTITY,
                                       RESERVED_WORLD,
                                       is_local_scope_identity)
from cilium_tpu_torch.ipcache.ipcache import IPCache
from cilium_tpu_torch.ipcache.kvstore_sync import (IP_IDENTITIES_PATH,
                                                   IPIdentityWatcher)
from cilium_tpu_torch.kvstore import (EVENT_CREATE, EVENT_DELETE,
                                      EVENT_LIST_DONE, EVENT_MODIFY,
                                      InMemoryBackend, KVLockError)
from cilium_tpu_torch.kvstore.allocator import Allocator
from cilium_tpu_torch.kvstore.etcd import EtcdBackend
from cilium_tpu_torch.kvstore.identity_allocator import (
    DistributedIdentityAllocator, FallbackIdentityAllocator,
    decode_labels, encode_labels)
from cilium_tpu_torch.kvstore.journal import WriteJournal
from cilium_tpu_torch.kvstore.memory import MemStore
from cilium_tpu_torch.kvstore.mini_etcd import MiniEtcd
from cilium_tpu_torch.kvstore.outage import (PROBE_KEY,
                                              KVStoreDegradedError,
                                              OutageGuard)
from cilium_tpu_torch.kvstore.remote import RemoteBackend, RemoteTimeout
from cilium_tpu_torch.kvstore.server import KVStoreServer
from cilium_tpu_torch.kvstore.store import SharedStore
from cilium_tpu_torch.labels import Labels, parse_label
from cilium_tpu_torch.node.registry import NODES_PATH, NodeRegistry
from cilium_tpu_torch.observability.events import (DEGRADED_SIGNALS,
                                                   EVENT_TYPES)
from cilium_tpu_torch.policy.jsonio import rules_from_json
from cilium_tpu_torch.policy.mapstate import PolicyMapState
from cilium_tpu_torch.utils import metrics as metrics_mod
from cilium_tpu_torch.utils import resilience
from cilium_tpu_torch.utils.faultinject import (ControlPlaneFaultInjector,
                                                FaultProxy, FaultySocket)
from cilium_tpu_torch.utils.metrics import (KVSTORE_RECONCILE,
                                            POLICY_REGENERATION_COUNT)
from cilium_tpu_torch.utils.option import DaemonConfig
from cilium_tpu_torch.utils.resilience import CircuitBreaker, Deadline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDENT_PREFIX = "cilium/state/identities/v1/"
ALLOC_PREFIX = "cilium/test-chaos-alloc"
WEB_IP, DB_IP, TMP_IP = "10.200.0.10", "10.200.0.11", "10.200.0.12"


def _wait_for(cond, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def _labels(*items):
    return Labels.from_labels(parse_label(i) for i in items)


def two_clients():
    store = MemStore()
    return InMemoryBackend(store), InMemoryBackend(store)


# ------------------------------------------ in-process backend and store

class TestBackend:
    def test_set_get_delete(self):
        b = InMemoryBackend()
        assert b.get("a") is None
        b.set("a", b"1")
        assert b.get("a") == b"1"
        b.delete("a")
        assert b.get("a") is None

    def test_create_only_is_atomic_between_clients(self):
        a, b = two_clients()
        assert a.create_only("k", b"a")
        assert not b.create_only("k", b"b")
        assert b.get("k") == b"a"

    def test_create_if_exists(self):
        b = InMemoryBackend()
        assert not b.create_if_exists("master", "slave", b"v")
        b.set("master", b"m")
        assert b.create_if_exists("master", "slave", b"v")
        assert b.get("slave") == b"v"
        # second create of an existing slave fails
        assert not b.create_if_exists("master", "slave", b"v2")

    def test_list_prefix(self):
        b = InMemoryBackend()
        b.set("p/x", b"1")
        b.set("p/y", b"2")
        b.set("q/z", b"3")
        assert b.list_prefix("p/") == {"p/x": b"1", "p/y": b"2"}
        b.delete_prefix("p/")
        assert b.list_prefix("p/") == {}

    def test_watch_sees_changes(self):
        a, b = two_clients()
        w = a.watch("pfx/")
        b.set("pfx/k", b"v")
        b.set("pfx/k", b"v2")
        b.delete("pfx/k")
        b.set("other/k", b"x")  # not under the prefix
        evs = [w.next_event(timeout=1.0) for _ in range(3)]
        assert [(e.typ, e.key) for e in evs] == [
            (EVENT_CREATE, "pfx/k"), (EVENT_MODIFY, "pfx/k"),
            (EVENT_DELETE, "pfx/k")]
        assert w.next_event(timeout=0.05) is None
        w.stop()

    def test_list_and_watch_replays_then_streams(self):
        a, b = two_clients()
        b.set("s/1", b"one")
        w = a.list_and_watch("s/")
        first = w.next_event(timeout=1.0)
        assert (first.typ, first.key, first.value) == \
            (EVENT_CREATE, "s/1", b"one")
        assert w.next_event(timeout=1.0).typ == EVENT_LIST_DONE
        b.set("s/2", b"two")
        assert w.next_event(timeout=1.0).key == "s/2"
        w.stop()

    def test_lease_keys_vanish_when_session_dies(self):
        a, b = two_clients()
        w = b.watch("lease/")
        a.set("lease/mine", b"v", lease=True)
        a.set("lease/plain", b"v")
        assert w.next_event(timeout=1.0).typ == EVENT_CREATE
        assert w.next_event(timeout=1.0).typ == EVENT_CREATE
        a.expire_now()  # node failure
        ev = w.next_event(timeout=1.0)
        assert (ev.typ, ev.key) == (EVENT_DELETE, "lease/mine")
        assert b.get("lease/plain") == b"v"
        w.stop()

    def test_lock_mutual_exclusion_and_timeout(self):
        a, b = two_clients()
        lock = a.lock_path("locks/x", timeout=1.0)
        with pytest.raises(KVLockError):
            b.lock_path("locks/x", timeout=0.1)
        lock.unlock()
        with b.lock_path("locks/x", timeout=1.0):
            pass

    def test_lock_released_on_session_death(self):
        a, b = two_clients()
        a.lock_path("locks/y", timeout=1.0)
        a.expire_now()
        with b.lock_path("locks/y", timeout=1.0):
            pass


class TestSharedStore:
    def test_two_nodes_converge(self):
        a, b = two_clients()
        seen = {}
        sa = SharedStore(a, "cilium/state/nodes/v1")
        sb = SharedStore(b, "cilium/state/nodes/v1",
                         on_update=lambda n, v: seen.__setitem__(n, v))
        assert sa.wait_synced() and sb.wait_synced()
        sa.update_local("node1", {"ip": "10.0.0.1"})
        deadline = threading.Event()
        for _ in range(100):
            if sb.snapshot().get("node1") == {"ip": "10.0.0.1"}:
                break
            deadline.wait(0.01)
        assert sb.snapshot()["node1"] == {"ip": "10.0.0.1"}
        assert seen["node1"] == {"ip": "10.0.0.1"}
        sa.delete_local("node1")
        for _ in range(100):
            if "node1" not in sb.snapshot():
                break
            deadline.wait(0.01)
        assert "node1" not in sb.snapshot()
        sa.close()
        sb.close()


class TestAllocator:
    def test_same_key_same_id_across_nodes(self):
        a, b = two_clients()
        alloc_a = Allocator(a, "cilium/state/identities/v1", "node-a",
                            256, 65535, seed=1)
        alloc_b = Allocator(b, "cilium/state/identities/v1", "node-b",
                            256, 65535, seed=2)
        id_a, new_a = alloc_a.allocate("app=foo")
        id_b, new_b = alloc_b.allocate("app=foo")
        assert id_a == id_b
        assert new_a and not new_b
        assert 256 <= id_a <= 65535

    def test_different_keys_different_ids(self):
        alloc = Allocator(InMemoryBackend(), "pfx", "n", 256, 65535, seed=3)
        ids = {alloc.allocate(f"key-{i}")[0] for i in range(50)}
        assert len(ids) == 50

    def test_refcount_release_and_gc(self):
        a, b = two_clients()
        alloc_a = Allocator(a, "pfx", "node-a", 256, 65535, seed=4)
        alloc_b = Allocator(b, "pfx", "node-b", 256, 65535, seed=5)
        id_, _ = alloc_a.allocate("k")
        alloc_b.allocate("k")
        alloc_a.allocate("k")  # refcount 2 on node-a
        # master survives while any slave key exists
        assert not alloc_a.release("k")
        assert alloc_a.release("k")
        assert alloc_a.run_gc() == 0  # node-b still holds it
        assert alloc_b.release("k")
        assert alloc_b.run_gc() == 1  # masterless now; reclaimed
        assert a.get(f"pfx/id/{id_}") is None

    def test_lease_expiry_frees_ids_for_gc(self):
        a, b = two_clients()
        alloc_a = Allocator(a, "pfx", "node-a", 256, 65535, seed=6)
        alloc_b = Allocator(b, "pfx", "node-b", 256, 65535, seed=7)
        alloc_a.allocate("k")
        a.expire_now()  # node-a dies; its slave key lease reaps
        assert alloc_b.run_gc() == 1

    def test_watch_cache_feeds_other_nodes(self):
        a, b = two_clients()
        alloc_a = Allocator(a, "pfx", "node-a", 256, 65535, seed=8)
        alloc_b = Allocator(b, "pfx", "node-b", 256, 65535, seed=9)
        id_, _ = alloc_a.allocate("shared")
        for _ in range(100):
            if alloc_b.get("shared") == id_:
                break
            threading.Event().wait(0.01)
        assert alloc_b.get("shared") == id_
        assert alloc_b.get_by_id(id_) == "shared"

    def test_concurrent_allocation_converges(self):
        store = MemStore()
        results = {}

        def worker(name):
            alloc = Allocator(InMemoryBackend(store), "pfx", name,
                              256, 65535)
            results[name] = alloc.allocate("contended")[0]

        threads = [threading.Thread(target=worker, args=(f"n{i}",))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(set(results.values())) == 1


class TestDistributedIdentityAllocator:
    def labels(self, *strs):
        return Labels.from_labels(parse_label(s) for s in strs)

    def test_label_key_roundtrip(self):
        lbls = self.labels("k8s:app=web", "k8s:io.kubernetes.pod.namespace=x",
                           "cidr:10.0.0.0/8")
        assert decode_labels(encode_labels(lbls)).sorted_list() == \
            lbls.sorted_list()

    def test_same_labels_same_identity_across_nodes(self):
        a, b = two_clients()
        da = DistributedIdentityAllocator(a, "node-a", seed=1)
        db = DistributedIdentityAllocator(b, "node-b", seed=2)
        lbls = self.labels("k8s:app=web")
        ia, new_a = da.allocate(lbls)
        ib, new_b = db.allocate(lbls)
        assert ia.id == ib.id >= MINIMAL_NUMERIC_IDENTITY
        assert new_a and not new_b
        assert db.lookup_by_id(ia.id).labels.sorted_list() == \
            lbls.sorted_list()

    def test_reserved_short_circuit(self):
        da = DistributedIdentityAllocator(InMemoryBackend(), "n")
        ident, is_new = da.allocate(self.labels("reserved:world"))
        assert ident.id == RESERVED_WORLD and not is_new

    def test_cluster_id_bits(self):
        da = DistributedIdentityAllocator(InMemoryBackend(), "n",
                                          cluster_id=3, seed=3)
        ident, _ = da.allocate(self.labels("k8s:app=x"))
        assert ident.id >> 16 == 3
        assert da.lookup_by_id(ident.id) is not None

    def test_change_events(self):
        a, b = two_clients()
        events = []
        DistributedIdentityAllocator(
            b, "node-b", on_change=lambda t, i: events.append((t, i.id)))
        da = DistributedIdentityAllocator(a, "node-a", seed=4)
        ident, _ = da.allocate(self.labels("k8s:app=ev"))
        da.release(ident)
        da.run_gc()
        for _ in range(100):
            if ("delete", ident.id) in events:
                break
            threading.Event().wait(0.01)
        assert ("add", ident.id) in events
        assert ("delete", ident.id) in events

    def test_snapshot_feeds_identity_cache(self):
        from cilium_tpu_torch.identity import IdentityCache
        da = DistributedIdentityAllocator(InMemoryBackend(), "n", seed=5)
        ident, _ = da.allocate(self.labels("k8s:app=cache"))
        cache = IdentityCache.snapshot(da)
        assert ident.id in cache
        assert RESERVED_WORLD in cache


# ---------------------------------------------------- etcd JSON gateway

@pytest.fixture()
def etcd_server():
    srv = MiniEtcd(reap_interval=0.1).start()
    yield srv
    srv.shutdown()


@pytest.fixture()
def etcd_client(etcd_server):
    c = EtcdBackend(port=etcd_server.port, lease_ttl=5.0)
    yield c
    c.close()


def test_basic_ops_over_etcd_wire(etcd_server, etcd_client):
    assert etcd_client.get("a") is None
    etcd_client.set("a", b"1")
    assert etcd_client.get("a") == b"1"
    etcd_client.set("dir/x", b"x")
    etcd_client.set("dir/y", b"y")
    assert etcd_client.list_prefix("dir/") == {"dir/x": b"x", "dir/y": b"y"}
    assert etcd_client.get_prefix("dir/") == b"x"
    etcd_client.delete("dir/x")
    assert etcd_client.list_prefix("dir/") == {"dir/y": b"y"}
    etcd_client.delete_prefix("dir/")
    assert etcd_client.list_prefix("dir/") == {}


def test_atomic_ops_between_clients(etcd_server, etcd_client):
    other = EtcdBackend(port=etcd_server.port, lease_ttl=5.0)
    try:
        assert etcd_client.create_only("ck", b"first")
        assert not other.create_only("ck", b"second")
        assert other.get("ck") == b"first"
        # create_if_exists: condition key present vs absent
        assert etcd_client.create_if_exists("ck", "dep", b"v")
        assert other.get("dep") == b"v"
        assert not etcd_client.create_if_exists("missing", "dep2", b"v")
        assert other.get("dep2") is None
    finally:
        other.close()


def test_lease_keys_vanish_when_client_dies(etcd_server):
    short = EtcdBackend(port=etcd_server.port, lease_ttl=1.0)
    observer = EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    try:
        short.set("leased/a", b"1", lease=True)
        short.set("plain/b", b"2")
        assert observer.get("leased/a") == b"1"
        # kill the keepalive without revoking (process-death model)
        short._closed.set()
        deadline = time.time() + 10
        while time.time() < deadline and \
                observer.get("leased/a") is not None:
            time.sleep(0.1)
        assert observer.get("leased/a") is None, \
            "lease-backed key must vanish after TTL"
        assert observer.get("plain/b") == b"2"
    finally:
        observer.close()
        short.close()


def test_watch_sees_other_clients_writes(etcd_server, etcd_client):
    other = EtcdBackend(port=etcd_server.port, lease_ttl=5.0)
    try:
        w = etcd_client.watch("w/")
        time.sleep(0.2)  # stream established
        other.set("w/k", b"v1")
        other.set("w/k", b"v2")
        other.delete("w/k")
        evs = [w.next_event(timeout=5) for _ in range(3)]
        assert [e.typ for e in evs] == [EVENT_CREATE, EVENT_MODIFY,
                                        EVENT_DELETE]
        assert evs[0].key == "w/k" and evs[0].value == b"v1"
        assert evs[1].value == b"v2"
        w.stop()
    finally:
        other.close()


def test_list_and_watch_replays_then_streams(etcd_server, etcd_client):
    etcd_client.set("lw/a", b"1")
    etcd_client.set("lw/b", b"2")
    w = etcd_client.list_and_watch("lw/")
    replay = {w.next_event(timeout=5).key for _ in range(2)}
    assert replay == {"lw/a", "lw/b"}
    assert w.next_event(timeout=5).typ == EVENT_LIST_DONE
    etcd_client.set("lw/c", b"3")
    ev = w.next_event(timeout=5)
    assert ev.typ == EVENT_CREATE and ev.key == "lw/c"
    w.stop()


def test_locks_exclude_across_clients(etcd_server, etcd_client):
    other = EtcdBackend(port=etcd_server.port, lease_ttl=5.0)
    try:
        lock = etcd_client.lock_path("locks/x", timeout=5)
        with pytest.raises(KVLockError):
            other.lock_path("locks/x", timeout=0.4)
        lock.unlock()
        other.lock_path("locks/x", timeout=5).unlock()
    finally:
        other.close()


def test_lock_released_when_holder_dies(etcd_server):
    holder = EtcdBackend(port=etcd_server.port, lease_ttl=1.0)
    waiter = EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    try:
        holder.lock_path("locks/y", timeout=5)
        holder._closed.set()  # keepalive dies; lease lapses
        lock = waiter.lock_path("locks/y", timeout=10)
        lock.unlock()
    finally:
        waiter.close()
        holder.close()


# -------------------------------------------------------- allocator tier

def test_identity_allocation_converges_across_etcd_clients(etcd_server):
    a = EtcdBackend(port=etcd_server.port, lease_ttl=5.0)
    b = EtcdBackend(port=etcd_server.port, lease_ttl=5.0)
    try:
        da = DistributedIdentityAllocator(a, "node-a")
        db = DistributedIdentityAllocator(b, "node-b")
        labels = Labels.from_model(["k8s:app=web"])
        ia, _ = da.allocate(labels)
        ib, _ = db.allocate(labels)
        assert ia.id == ib.id, \
            "same labels must resolve to one identity across the wire"
        other, _ = db.allocate(Labels.from_model(["k8s:app=db"]))
        assert other.id != ia.id
    finally:
        a.close()
        b.close()



# ------------------------------------------------------ TCP frame store

@pytest.fixture()
def tcp_server():
    srv = KVStoreServer(port=0, expire_interval=0.1).start()
    yield srv
    srv.shutdown()


@pytest.fixture()
def tcp_client(tcp_server):
    c = RemoteBackend(port=tcp_server.port, lease_ttl=5.0)
    yield c
    c.close()


def test_basic_ops_over_tcp(tcp_server, tcp_client):
    assert tcp_client.get("a") is None
    tcp_client.set("a", b"1")
    assert tcp_client.get("a") == b"1"
    tcp_client.set("dir/x", b"x")
    tcp_client.set("dir/y", b"y")
    assert tcp_client.list_prefix("dir/") == {"dir/x": b"x", "dir/y": b"y"}
    assert tcp_client.get_prefix("dir/") == b"x"
    tcp_client.delete("dir/x")
    assert tcp_client.list_prefix("dir/") == {"dir/y": b"y"}
    tcp_client.delete_prefix("dir/")
    assert tcp_client.list_prefix("dir/") == {}


def test_atomic_ops_over_tcp(tcp_server, tcp_client):
    assert tcp_client.create_only("k", b"v") is True
    assert tcp_client.create_only("k", b"w") is False
    assert tcp_client.get("k") == b"v"
    assert tcp_client.create_if_exists("k", "dep", b"d") is True
    assert tcp_client.create_if_exists("nope", "dep2", b"d") is False
    assert tcp_client.create_if_exists("k", "dep", b"again") is False


def test_watch_sees_other_clients_writes_over_tcp(tcp_server, tcp_client):
    other = RemoteBackend(port=tcp_server.port, lease_ttl=5.0)
    try:
        tcp_client.set("pre/existing", b"0")
        w = tcp_client.list_and_watch("pre/")
        ev = w.next_event(timeout=5)
        assert (ev.typ, ev.key) == (EVENT_CREATE, "pre/existing")
        assert w.next_event(timeout=5).typ == EVENT_LIST_DONE
        other.set("pre/live", b"1")
        ev = w.next_event(timeout=5)
        assert (ev.typ, ev.key, ev.value) == (EVENT_CREATE, "pre/live",
                                              b"1")
        other.delete("pre/live")
        ev = w.next_event(timeout=5)
        assert (ev.typ, ev.key) == (EVENT_DELETE, "pre/live")
        w.stop()
    finally:
        other.close()


def test_locks_exclude_across_clients_over_tcp(tcp_server, tcp_client):
    other = RemoteBackend(port=tcp_server.port, lease_ttl=5.0)
    try:
        lk = tcp_client.lock_path("locks/x", timeout=5)
        t0 = time.monotonic()
        with pytest.raises(KVLockError):
            other.lock_path("locks/x", timeout=0.4)
        assert time.monotonic() - t0 >= 0.35
        lk.unlock()
        other.lock_path("locks/x", timeout=5).unlock()
    finally:
        other.close()


def test_lease_expiry_after_disconnect(tcp_server):
    short = RemoteBackend(port=tcp_server.port, lease_ttl=0.5)
    watcher_client = RemoteBackend(port=tcp_server.port, lease_ttl=5.0)
    try:
        short.set("leased/gone", b"v", lease=True)
        short.set("plain/stays", b"v")
        w = watcher_client.watch("leased/")
        # hard disconnect: no clean close, keepalive stops
        short._closed.set()
        short._sock.close()
        ev = w.next_event(timeout=5)
        assert (ev.typ, ev.key) == (EVENT_DELETE, "leased/gone")
        assert watcher_client.get("leased/gone") is None
        assert watcher_client.get("plain/stays") == b"v"
        w.stop()
    finally:
        watcher_client.close()


def test_lease_survives_while_renewed(tcp_server):
    c = RemoteBackend(port=tcp_server.port, lease_ttl=0.6)
    try:
        c.set("alive/k", b"v", lease=True)
        time.sleep(1.5)  # > 2 TTLs; keepalive at ttl/3 keeps it alive
        assert c.get("alive/k") == b"v"
    finally:
        c.close()



# ---------------------------------------------- the agent as a process

def _spawn_agent(tmp_path, backend, store_port, node, ttl):
    """``python -m cilium_tpu_torch.cli agent`` on the CPU against the
    store at ``store_port``; returns (process, REST base URL) once the
    agent serves."""
    errfile = open(tmp_path / f"{node}.stderr", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.cli", "agent",
         "--device", "cpu", "--api-port", "0", "--node-name", node,
         "--kvstore", backend, "--kvstore-opt", f"port={store_port}",
         "--kvstore-opt", f"lease_ttl={ttl}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=errfile, text=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    proc._errfile = errfile
    out = {}
    reader = threading.Thread(
        target=lambda: out.update(line=proc.stdout.readline()),
        daemon=True)
    reader.start()
    reader.join(120)
    line = out.get("line") or ""
    if "api=" not in line:
        proc.kill()
        proc.wait(timeout=10)
        errfile.seek(0)
        raise AssertionError(f"agent did not start: {line!r}\n"
                             f"{errfile.read()[-2000:]}")
    return proc, line.split("api=")[1].split()[0]


def _rest(url, method, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        url + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _agent_endpoints(url, node):
    """The agent_proc.py pair: one endpoint with cluster-shared labels,
    one with labels unique to the node; their identities."""
    net = 1 if node.endswith("a") else 2
    shared = _rest(url, "PUT", "/endpoint/1", {
        "ipv4": f"10.50.{net}.1", "labels": ["k8s:app=shared-web"]})
    unique = _rest(url, "PUT", "/endpoint/2", {
        "ipv4": f"10.50.{net}.2", "labels": [f"k8s:app=only-{node}"]})
    return shared["identity"]["id"], unique["identity"]["id"]


def _stop(proc, sig=signal.SIGINT):
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    proc._errfile.close()


@pytest.mark.parametrize("backend", ["etcd", "remote"])
def test_kill9_agent_lease_reaped(backend, tmp_path):
    """kill -9 of a port agent models node death: its slave keys vanish
    when its lease lapses and GC reclaims the masterless identities, on
    the etcd gateway and on the TCP store."""
    if backend == "etcd":
        srv = MiniEtcd(reap_interval=0.1).start()
        observer_cls = EtcdBackend
    else:
        srv = KVStoreServer(port=0, expire_interval=0.1).start()
        observer_cls = RemoteBackend
    observer = victim = None
    try:
        observer = observer_cls(port=srv.port, lease_ttl=30.0)
        victim, url = _spawn_agent(tmp_path, backend, srv.port, "node-a",
                                   ttl=1.0)
        _agent_endpoints(url, "node-a")
        slaves = observer.list_prefix(IDENT_PREFIX + "value/")
        assert len(slaves) == 2, "one lease-backed slave key per identity"
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=10)
        _wait_for(lambda: not observer.list_prefix(IDENT_PREFIX + "value/"),
                  timeout=10, msg="slave keys reaped")
        masters = observer.list_prefix(IDENT_PREFIX + "id/")
        assert len(masters) == 2
        gc_alloc = Allocator(observer, "cilium/state/identities/v1",
                             node="gc-node", min_id=256, max_id=65535)
        try:
            assert gc_alloc.run_gc() == len(masters)
        finally:
            gc_alloc.close()
        assert observer.list_prefix(IDENT_PREFIX + "id/") == {}
    finally:
        if victim is not None:
            _stop(victim, signal.SIGKILL)
        if observer is not None:
            observer.close()
        srv.shutdown()


def test_two_agent_processes_converge(tcp_server, tmp_path):
    """Two port agents in separate processes on one TCP store: same
    labels -> same identity, distinct labels -> distinct identities,
    and each agent's engine LPM learns the other's endpoint IP."""
    agents = []
    try:
        for node in ("node-a", "node-b"):
            agents.append(_spawn_agent(tmp_path, "remote",
                                       tcp_server.port, node, ttl=2.0))
        (pa, url_a), (pb, url_b) = agents
        shared_a, unique_a = _agent_endpoints(url_a, "node-a")
        shared_b, unique_b = _agent_endpoints(url_b, "node-b")
        assert shared_a == shared_b
        assert unique_a != unique_b

        def learned(url, ip, ident):
            return _rest(url, "GET", "/map/ipcache").get(f"{ip}/32") == \
                ident
        _wait_for(lambda: learned(url_a, "10.50.2.1", shared_b),
                  msg="node-a learned node-b's endpoint")
        _wait_for(lambda: learned(url_b, "10.50.1.1", shared_a),
                  msg="node-b learned node-a's endpoint")
        for proc, _url in agents:
            _stop(proc)
            assert proc.returncode == 0
    finally:
        for proc, _url in agents:
            _stop(proc, signal.SIGKILL)

# ------------------------------------------------------- unit: journal

def test_write_journal_coalesces_and_bounds():
    j = WriteJournal(max_entries=3)
    j.record("set", "a", b"1")
    j.record("set", "a", b"2")
    assert j.depth() == 1 and j.stats()["coalesced"] == 1
    j.record("delete", "a")
    # the delete replaced the pending set — replay ends with a delete
    assert j.depth() == 1 and j.snapshot()[0].op == "delete"
    # delete_prefix subsumes pending mutations under the prefix
    j.record("set", "p/x", b"1")
    j.record("set", "p/y", b"2")
    j.record("delete_prefix", "p/")
    assert j.depth() == 2
    ops = [e.op for e in j.snapshot()]
    assert ops == ["delete", "delete_prefix"]
    # bound: oldest evicted with accounting
    j.record("set", "b", b"1")
    j.record("set", "c", b"1")
    assert j.depth() == 3
    assert j.stats()["dropped"] == 1
    # replay order is by sequence
    seqs = [e.seq for e in j.snapshot()]
    assert seqs == sorted(seqs)
    # a live write supersedes the pending entry
    j.discard_key("c")
    assert all(e.key != "c" for e in j.snapshot())


# --------------------------------------------------- unit: outage guard

class _FlakyBackend(InMemoryBackend):
    """In-memory backend with a failure switch."""

    def __init__(self):
        super().__init__()
        self.fail = False

    def _gate(self):
        if self.fail:
            raise OSError("injected kvstore failure")

    def get(self, key):
        self._gate()
        return super().get(key)

    def list_prefix(self, prefix):
        self._gate()
        return super().list_prefix(prefix)

    def set(self, key, value, lease=False):
        self._gate()
        return super().set(key, value, lease)

    def delete(self, key):
        self._gate()
        return super().delete(key)

    def lock_path(self, path, timeout=30.0):
        self._gate()
        return super().lock_path(path, timeout)


def test_outage_guard_degrades_journals_and_reconciles():
    inner = _FlakyBackend()
    guard = OutageGuard(inner, degrade=True, failure_threshold=2,
                        probe_interval=0.05)
    guard.track_prefix("t/")
    guard.set("t/pre", b"v0", lease=True)
    assert guard.mode == "ok" and guard.staleness() == 0.0

    inner.fail = True
    # mutations during the failing window journal instead of raising
    guard.set("t/k", b"v1", lease=True)
    guard.set("t/k", b"v2", lease=True)   # coalesces
    assert guard.mode == "degraded"
    assert guard.journal.depth() == 1
    # reads and locks fail FAST while degraded (no per-op timeouts)
    t0 = time.monotonic()
    with pytest.raises((KVStoreDegradedError, OSError)):
        guard.get("t/pre")
    assert time.monotonic() - t0 < 0.5
    with pytest.raises((KVStoreDegradedError, OSError)):
        guard.lock_path("t/lock")
    # a non-lease CAS create must not be faked
    with pytest.raises((KVStoreDegradedError, OSError)):
        guard.create_only("t/master", b"x")
    assert guard.staleness() > 0.0
    rep = guard.report()
    assert rep["mode"] == "degraded" and rep["journal-depth"] == 1

    # the server "reaps" a lease-backed key behind our back (lease
    # expiry during the outage) — the reconcile must re-assert it
    InMemoryBackend.delete(inner, "t/pre")

    inner.fail = False
    reconciles = KVSTORE_RECONCILE.value(labels={"result": "ok"})
    time.sleep(0.1)
    event = guard.tick()
    assert event.get("reconciled") is True
    assert guard.mode == "ok"
    assert inner.get("t/k") == b"v2"       # journal replayed
    assert inner.get("t/pre") == b"v0"     # lease-grace repair
    report = event["report"]
    assert report["replayed"] == 1 and report["repaired"] == 1
    assert KVSTORE_RECONCILE.value(labels={"result": "ok"}) > reconciles
    assert guard.journal.depth() == 0


def test_probe_that_outlives_ok_leaves_the_journal_to_the_reconcile():
    """A tick reads the mode as ok and probes; the probe blocks for the
    backend's timeout while other callers' failures degrade the guard
    and journal a write; the backend comes back before the probe
    returns.  That tick must leave the journal to the reconcile, whose
    report then counts the write replayed (the reference drained it on
    the stale reading, and ``test_daemon_outage_journey`` read
    ``replayed`` 0 about one run in three)."""
    entered, release = threading.Event(), threading.Event()

    class _SlowProbe(_FlakyBackend):
        def get(self, key):
            if key == PROBE_KEY and not release.is_set():
                entered.set()
                release.wait(10)
            return super().get(key)

    inner = _SlowProbe()
    guard = OutageGuard(inner, degrade=True, failure_threshold=2,
                        probe_interval=0.0)
    guard.set("t/pre", b"v0", lease=True)
    ticking = threading.Thread(target=guard.tick)
    ticking.start()
    try:
        assert entered.wait(10)
        inner.fail = True
        guard.set("t/k", b"v1", lease=True)
        guard.set("t/k", b"v2", lease=True)
        assert guard.mode == "degraded" and guard.journal.depth() == 1
        inner.fail = False
    finally:
        release.set()
        ticking.join(10)
    assert guard.mode == "degraded" and guard.journal.depth() == 1
    event = guard.tick()
    assert event.get("reconciled") is True and guard.mode == "ok"
    assert event["report"]["replayed"] == 1
    assert inner.get("t/k") == b"v2"


def test_outage_guard_disabled_is_passthrough():
    """degrade=False: bookkeeping only — every op delegates with
    identical semantics and exceptions (the pre-change behavior)."""
    inner = _FlakyBackend()
    guard = OutageGuard(inner, degrade=False)
    guard.set("k", b"v")
    assert guard.get("k") == b"v"
    inner.fail = True
    with pytest.raises(OSError):
        guard.set("k", b"v2")      # raises, never journals
    with pytest.raises(OSError):
        guard.get("k")
    assert guard.journal.depth() == 0
    assert guard.mode == "ok"      # mode never flips when disabled
    # ... but the status bookkeeping still tracks the failure
    assert guard.staleness() > 0.0
    assert guard.report()["consecutive-failures"] >= 2
    inner.fail = False
    assert guard.get("k") == b"v"
    assert guard.staleness() == 0.0
    assert guard.tick() == {}      # tick is inert when disabled


# ------------------------------------- unit: identity fallback/adoption

def test_fallback_allocator_local_scope_and_adoption():
    backend = InMemoryBackend()
    guard = OutageGuard(backend, degrade=True, failure_threshold=1,
                        probe_interval=0.05)
    dist = DistributedIdentityAllocator(guard, node="n1")
    fb = FallbackIdentityAllocator(dist, guard=guard)
    try:
        # healthy: plain distributed allocation
        web, is_new = fb.allocate(_labels("k8s:id=web"))
        assert is_new and not is_local_scope_identity(web.id)

        # force degraded
        guard._note_failure()
        assert guard.mode == "degraded"

        # labels the cluster already bound: ADOPT the cached ID
        again, _ = fb.allocate(_labels("k8s:id=web"))
        assert again.id == web.id
        # release the extra ref (delete journals while degraded)
        fb.release(again)

        # genuinely new labels: node-local ephemeral identity
        tmp, is_new = fb.allocate(_labels("k8s:id=tmp"))
        assert is_new and is_local_scope_identity(tmp.id)
        assert tmp.id >= LOCAL_SCOPE_IDENTITY_BASE
        assert fb.local_count() == 1
        # same labels -> same local id, refcounted
        tmp2, is_new = fb.allocate(_labels("k8s:id=tmp"))
        assert not is_new and tmp2.id == tmp.id
        assert fb.lookup_by_id(tmp.id) == tmp
        assert fb.lookup_by_labels(_labels("k8s:id=tmp")).id == tmp.id
        assert any(i.id == tmp.id for i in fb.snapshot_identities())
        assert fb.release(tmp2) is False
        assert fb.release(tmp) is True
        assert fb.local_count() == 0
    finally:
        fb.close()


# ----------------------------------------- live-daemon outage journey

RULES_JSON = json.dumps([{
    "endpointSelector": {"matchLabels": {"id": "db"}},
    "ingress": [
        {"fromEndpoints": [{"matchLabels": {"id": "web"}}],
         "toPorts": [{"ports": [{"port": "5432", "protocol": "TCP"}]}]},
        {"fromEndpoints": [{"matchLabels": {"id": "tmp"}}],
         "toPorts": [{"ports": [{"port": "7000", "protocol": "TCP"}]}]},
    ],
    "labels": ["k8s:policy=cp-chaos"],
}])


@pytest.fixture()
def injector(etcd_server):
    proxy = FaultProxy("127.0.0.1", etcd_server.port).start()
    inj = ControlPlaneFaultInjector(etcd=proxy,
                                    lease_expirer=etcd_server
                                    .expire_leases)
    yield inj
    inj.close()
    proxy.close()


def _ip_u32(dotted):
    a, b, c, d = (int(x) for x in dotted.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def _recs(slot, n, dport, saddr, sport0, flags=0x02):
    return {"endpoint": np.full(n, slot, np.int32),
            "saddr": np.full(n, _ip_u32(saddr),
                             np.uint32).view(np.int32),
            "daddr": np.full(n, _ip_u32(DB_IP),
                             np.uint32).view(np.int32),
            "sport": (sport0 + np.arange(n)).astype(np.int32),
            "dport": np.full(n, dport, np.int32),
            "proto": np.full(n, 6, np.int32),
            "direction": np.zeros(n, np.int32),   # ingress to db
            "tcp_flags": np.full(n, flags, np.int32),
            "is_fragment": np.zeros(n, np.int32),
            "length": np.full(n, 256, np.int32)}


def _verdicts(disp, recs):
    t = disp.submit_records(recs, len(recs["sport"]))
    v, i = t.result(timeout=120)
    assert t.error is None
    return np.asarray(v), np.asarray(i)


def test_daemon_outage_journey(etcd_server, injector):
    """The acceptance journey: blackhole etcd mid-run -> degraded with
    growing staleness, dataplane bit-exact, outage endpoint on a
    local-scope identity with correct verdicts; reconnect -> journal
    replay + reconcile converge, drift audit green, local identities
    promoted without dropping established flows, regeneration bounded
    by the actually-diverged endpoint set."""
    kv = EtcdBackend(host="127.0.0.1", port=injector.proxy("etcd").port,
                     lease_ttl=30.0, timeout=1.0)
    cfg = DaemonConfig(state_dir="", drift_audit_interval_s=0,
                       ct_checkpoint_interval_s=0,
                       enable_kvstore_survival=True,
                       kvstore_probe_interval_s=0.1,
                       kvstore_failure_threshold=2)
    d = Daemon(config=cfg, kvstore_backend=kv, node_name="n1",
               device="cpu")
    observer = EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    try:
        d.endpoint_create(1, ipv4=WEB_IP, labels=["k8s:id=web"])
        d.endpoint_create(2, ipv4=DB_IP, labels=["k8s:id=db"])
        # bystanders: endpoints the promotion must NOT regenerate
        for k in range(4):
            d.endpoint_create(10 + k, ipv4=f"10.200.1.{10 + k}",
                              labels=[f"k8s:id=bystander{k}"])
        rev = d.policy_add(rules_from_json(RULES_JSON))
        assert d.wait_for_policy_revision(rev, timeout=60)
        st = d.status()["kvstore"]
        assert st["mode"] == "ok" and st["backend"] == "EtcdBackend"

        disp = d.datapath.serving()
        slot = d.endpoints.lookup(2).table_slot
        # establish a long-lived flow web -> db:5432 (SYN then ACK)
        v, _ = _verdicts(disp, _recs(slot, 4, 5432, WEB_IP, 40000))
        assert (v == 0).all()
        v, _ = _verdicts(disp, _recs(slot, 4, 5432, WEB_IP, 40000,
                                     flags=0x10))
        assert (v == 0).all()

        # ---- blackhole etcd mid-run ----
        injector.blackhole("etcd")
        _wait_for(lambda: d.status()["kvstore"]["mode"] == "degraded",
                  msg="kvstore degraded")
        s1 = d.status()["kvstore"]["staleness-seconds"]
        time.sleep(0.4)
        st = d.status()["kvstore"]
        assert st["staleness-seconds"] > s1, "staleness must grow"
        assert "DEGRADED" in st["state"]
        assert st["breaker"] != "closed"

        # dataplane keeps serving bit-exact: drift audit replays the
        # live compiled tables against the host oracles
        rep = d.run_drift_audit()
        assert rep["status"] in ("ok", "idle")
        # established flow still forwards, denied still denied
        v, _ = _verdicts(disp, _recs(slot, 4, 5432, WEB_IP, 40000,
                                     flags=0x10))
        assert (v == 0).all()
        v, _ = _verdicts(disp, _recs(slot, 4, 9999, WEB_IP, 41000))
        assert (v < 0).all()

        # ---- endpoint created DURING the outage ----
        t0 = time.monotonic()
        ep3 = d.endpoint_create(3, ipv4=TMP_IP, labels=["k8s:id=tmp"])
        create_s = time.monotonic() - t0
        assert create_s < 5.0, \
            f"degraded create took {create_s:.1f}s (not failing fast)"
        local_id = ep3.security_identity
        assert is_local_scope_identity(local_id)
        assert d.wait_for_policy_revision(rev, timeout=60)
        st = d.status()["kvstore"]
        assert st["local-identities"] == 1
        assert st["journal-depth"] >= 1   # the ipcache upsert journaled

        # correct verdicts for the outage endpoint: tmp -> db:7000
        # allowed, anything else denied
        v, ident = _verdicts(disp, _recs(slot, 4, 7000, TMP_IP, 42000))
        assert (v == 0).all()
        assert (ident == local_id).all()
        v, _ = _verdicts(disp, _recs(slot, 4, 9999, TMP_IP, 43000))
        assert (v < 0).all()
        rep = d.run_drift_audit()
        assert rep["status"] in ("ok", "idle")

        # ---- reconnect ----
        regen_before = POLICY_REGENERATION_COUNT.total()
        injector.heal()
        _wait_for(lambda: d.status()["kvstore"]["mode"] == "ok",
                  msg="kvstore mode back to ok")
        _wait_for(lambda:
                  d.status()["kvstore"]["local-identities"] == 0,
                  msg="local identities promoted")
        ep3 = d.endpoints.lookup(3)
        new_id = ep3.security_identity
        assert not is_local_scope_identity(new_id)

        # converged: db's realized map now names the promoted identity
        def _db_promoted():
            state = PolicyMapState(d.endpoints.lookup(2).realized)
            keys = [k for k in state.keys() if k.dest_port == 7000]
            return keys and all(k.identity == new_id for k in keys)
        _wait_for(lambda: _db_promoted() and
                  d.wait_for_quiesce(0.1),
                  msg="referencing endpoint re-keyed")

        # regeneration bounded by the actually-diverged set (ep3 +
        # db), never the bystanders (a full-resync would be 7 builds)
        regens = POLICY_REGENERATION_COUNT.total() - regen_before
        assert regens <= 3, \
            f"{regens} regenerations — promotion fanned out too wide"

        # reconcile replayed the journal; the store now carries the
        # PROMOTED identity for the outage endpoint's IP
        st = d.status()["kvstore"]
        assert st["last-reconcile"] is not None
        assert st["last-reconcile"]["replayed"] >= 1

        def _published():
            raw = observer.get(f"cilium/state/ip/v1/default/{TMP_IP}/32")
            return raw is not None and \
                json.loads(raw.decode())["ID"] == new_id
        _wait_for(_published, msg="promoted identity published")

        # established flow survived the whole journey (CT untouched)
        v, _ = _verdicts(disp, _recs(slot, 4, 5432, WEB_IP, 40000,
                                     flags=0x10))
        assert (v == 0).all()
        # post-promotion verdicts stay correct and drift-free
        v, ident = _verdicts(disp, _recs(slot, 4, 7000, TMP_IP, 44000))
        assert (v == 0).all() and (ident == new_id).all()
        rep = d.run_drift_audit()
        assert rep["status"] in ("ok", "idle")
    finally:
        d.shutdown()        # closes kv, the backend it was given
        observer.close()


def test_promotion_follows_up_a_build_in_flight(etcd_server, injector):
    """A build that takes its identity snapshot while an outage
    endpoint still holds its local identity, and realizes its map only
    after the promotion scanned the realized maps, is built again: db's
    map names the promoted identity, not the local one.  (The
    reference's scan, copied before, missed such a build and left its
    map stale; ``chip_smoke.py``'s ``kvstore-outage`` leg hit that.)"""
    kv = EtcdBackend(host="127.0.0.1", port=injector.proxy("etcd").port,
                     lease_ttl=30.0, timeout=1.0)
    cfg = DaemonConfig(state_dir="", drift_audit_interval_s=0,
                       ct_checkpoint_interval_s=0,
                       enable_kvstore_survival=True,
                       kvstore_probe_interval_s=0.1,
                       kvstore_failure_threshold=2)
    d = Daemon(config=cfg, kvstore_backend=kv, node_name="n1",
               device="cpu")
    gate, held = threading.Event(), threading.Event()
    try:
        d.endpoint_create(1, ipv4=WEB_IP, labels=["k8s:id=web"])
        db = d.endpoint_create(2, ipv4=DB_IP, labels=["k8s:id=db"])
        rev = d.policy_add(rules_from_json(RULES_JSON))
        assert d.wait_for_policy_revision(rev, timeout=60)
        injector.blackhole("etcd")
        _wait_for(lambda: d.status()["kvstore"]["mode"] == "degraded",
                  msg="kvstore degraded")
        # db's next build resolves its policy, then waits before it
        # realizes the map
        resolve = db.regenerate_policy

        def held_resolve(*a, **kw):
            res = resolve(*a, **kw)
            held.set()
            gate.wait(60)
            return res

        db.regenerate_policy = held_resolve
        local_id = d.endpoint_create(
            3, ipv4=TMP_IP, labels=["k8s:id=tmp"]).security_identity
        assert is_local_scope_identity(local_id)
        # the new identity's own trigger rebuilds every endpoint
        assert held.wait(30), "db's build did not start"
        injector.heal()
        # the promotion's note comes after its scan of the maps
        _wait_for(lambda: any(
            e.note.startswith("identity-promotion")
            for e in d.monitor.tail(1000, kind="agent")),
            msg="local identities promoted")
        del db.regenerate_policy
        gate.set()
        new_id = d.endpoints.lookup(3).security_identity
        assert not is_local_scope_identity(new_id)

        def db_keys():
            state = PolicyMapState(d.endpoints.lookup(2).realized)
            return {k.identity for k in state.keys() if k.dest_port == 7000}
        _wait_for(lambda: d.wait_for_quiesce(0.1) and
                  db_keys() == {new_id}, msg="db names the promoted id")
        assert d.wait_for_quiesce(5) and db_keys() == {new_id}
    finally:
        gate.set()
        d.shutdown()


def test_daemon_flap_and_lease_expiry_repair(etcd_server, injector):
    """Flap etcd through the injector, then expire every server-side
    lease mid-outage: the reconcile's lease-grace repair re-asserts the
    reaped lease-backed keys (node registration, ipcache entries)."""
    kv = EtcdBackend(host="127.0.0.1", port=injector.proxy("etcd").port,
                     lease_ttl=30.0, timeout=1.0)
    cfg = DaemonConfig(state_dir="", drift_audit_interval_s=0,
                       ct_checkpoint_interval_s=0,
                       enable_kvstore_survival=True,
                       kvstore_probe_interval_s=0.1,
                       kvstore_failure_threshold=2,
                       enable_hubble=False)
    d = Daemon(config=cfg, kvstore_backend=kv, node_name="n1",
               device="cpu")
    observer = EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    try:
        d.register_node("10.0.0.1", "10.200.0.0/16")
        d.endpoint_create(1, ipv4=WEB_IP, labels=["k8s:id=web"])
        node_key = "cilium/state/nodes/v1/default/n1"
        ip_key = f"cilium/state/ip/v1/default/{WEB_IP}/32"
        _wait_for(lambda: observer.get(node_key) is not None,
                  msg="node registered")
        assert observer.get(ip_key) is not None

        # flap: partition/heal cycles — the guard must end closed
        injector.flap("etcd", cycles=2, period_s=0.3).join(timeout=10)
        _wait_for(lambda: d.status()["kvstore"]["mode"] == "ok",
                  msg="guard recovered from flap")

        # long outage: blackhole AND expire every lease server-side
        injector.blackhole("etcd")
        _wait_for(lambda: d.status()["kvstore"]["mode"] == "degraded",
                  msg="degraded after blackhole")
        assert injector.expire_leases() >= 1
        assert observer.get(node_key) is None, "lease reap expected"
        assert observer.get(ip_key) is None

        injector.heal()
        _wait_for(lambda: d.status()["kvstore"]["mode"] == "ok",
                  msg="reconciled after lease expiry")
        # the repair re-asserted our lease-backed keys (with a fresh
        # lease — the old one is gone server-side)
        _wait_for(lambda: observer.get(node_key) is not None,
                  msg="node registration repaired")
        _wait_for(lambda: observer.get(ip_key) is not None,
                  msg="ipcache entry repaired")
        rec = d.status()["kvstore"]["last-reconcile"]
        assert rec["repaired"] >= 1
        assert ("expire-leases" in
                [a for _p, a in injector.stats()["faults"]])
    finally:
        d.shutdown()        # closes kv, the backend it was given
        observer.close()


# ---------------------------------------- disabled path / status fix

def test_disabled_path_unwrapped_allocator_and_hard_failures():
    """enable_kvstore_survival=False (the default): no fallback
    allocator, no outage controller, and a dead backend surfaces hard
    errors exactly as before the change."""
    backend = _FlakyBackend()
    d = Daemon(config=DaemonConfig(state_dir="",
                                   drift_audit_interval_s=0,
                                   ct_checkpoint_interval_s=0,
                                   enable_hubble=False),
               kvstore_backend=backend, node_name="n1", device="cpu")
    try:
        assert isinstance(d.identity_allocator,
                          DistributedIdentityAllocator)
        assert not isinstance(d.identity_allocator,
                              FallbackIdentityAllocator)
        assert d.controllers.lookup("kvstore-outage") is None
        d.endpoint_create(1, ipv4=WEB_IP, labels=["k8s:id=web"])
        backend.fail = True
        # a NEW label set needs the kvstore: hard failure, no fallback
        with pytest.raises(Exception):
            d.endpoint_create(2, ipv4=DB_IP, labels=["k8s:id=db"])
        # ... but the status path now reports the staleness instead of
        # echoing 'ok' between calls (the satellite fix applies in
        # monitor-only mode too).  status() rounds it to the ms, and
        # the port's failed create can come back within half a ms of
        # the last success, so let a few ms pass first
        time.sleep(0.01)
        st = d.status()["kvstore"]
        assert st["mode"] == "ok"          # degradation is opt-in
        assert st["staleness-seconds"] > 0
        assert st["consecutive-failures"] >= 1
        backend.fail = False
        d.endpoint_create(2, ipv4=DB_IP, labels=["k8s:id=db"])
        assert d.status()["kvstore"]["staleness-seconds"] == 0
    finally:
        backend.fail = False
        d.shutdown()


def test_controller_health_top_level_signal():
    """A controller failing >=3x consecutively surfaces as a top-level
    degraded signal in status(), and controller_runs_total counts
    per-run outcomes."""
    from cilium_tpu_torch.utils.controller import ControllerParams
    from cilium_tpu_torch.utils.metrics import CONTROLLER_RUNS
    d = Daemon(config=DaemonConfig(state_dir="",
                                   drift_audit_interval_s=0,
                                   ct_checkpoint_interval_s=0,
                                   enable_hubble=False),
               device="cpu")
    try:
        assert d.status()["controller-health"]["status"] == "ok"
        fails_before = CONTROLLER_RUNS.value(
            labels={"name": "cp-chaos-wedged", "status": "failure"})

        def boom():
            raise RuntimeError("wedged reconcile")

        d.controllers.update_controller(
            "cp-chaos-wedged",
            ControllerParams(do_func=boom, run_interval=0.01,
                             error_retry_base=0.01))
        _wait_for(lambda: d.status()["controller-health"]["failing"],
                  timeout=10.0, msg="controller-health degraded")
        ch = d.status()["controller-health"]
        assert ch["status"].startswith("DEGRADED")
        names = [f["name"] for f in ch["failing"]]
        assert "cp-chaos-wedged" in names
        wedged = next(f for f in ch["failing"]
                      if f["name"] == "cp-chaos-wedged")
        assert wedged["consecutive-failures"] >= 3
        assert "wedged reconcile" in wedged["last-error"]
        assert CONTROLLER_RUNS.value(
            labels={"name": "cp-chaos-wedged",
                    "status": "failure"}) > fails_before
        # healing the controller clears the signal
        d.controllers.update_controller(
            "cp-chaos-wedged",
            ControllerParams(do_func=lambda: None, run_interval=0.01))
        _wait_for(lambda: not
                  d.status()["controller-health"]["failing"],
                  timeout=10.0, msg="controller-health ok again")
    finally:
        d.shutdown()



# ------------------------------------------------------ transport faults

def _ip_key(ip):
    return f"{IP_IDENTITIES_PATH}/{ip}"


def _ip_val(ip, ident):
    return json.dumps({"IP": ip, "ID": ident, "HostIP": None,
                       "Metadata": ""}).encode()


def _node_val(name):
    return json.dumps({"Name": name, "Cluster": "default",
                       "ClusterID": 0, "IPAddresses": [],
                       "IPv4AllocCIDR": None,
                       "IPv6AllocCIDR": None}).encode()


@pytest.fixture()
def proxy(etcd_server):
    p = FaultProxy("127.0.0.1", etcd_server.port).start()
    yield p
    p.close()


# ---------------------------------------------------- compaction window

def test_compaction_blind_window_leaves_no_stale_entries(etcd_server,
                                                         proxy):
    """The compaction blind window end to end: watch streams die, the
    world changes, the history is compacted away, and the reconnecting
    watcher must relist-and-diff — allocator, ipcache, and node
    consumers all converge with the blind-window deletes applied."""
    writer = EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    victim = EtcdBackend(host="127.0.0.1", port=proxy.port,
                         lease_ttl=30.0)
    relists_before = resilience.WATCH_RELISTS.value(
        labels={"transport": "etcd"})
    try:
        # seed the world through the direct writer
        writer.set(_ip_key("10.1.0.1"), _ip_val("10.1.0.1", 1001))
        writer.set(_ip_key("10.1.0.2"), _ip_val("10.1.0.2", 1002))
        writer.set(f"{NODES_PATH}/default/n1", _node_val("n1"))
        writer.set(f"{NODES_PATH}/default/n2", _node_val("n2"))
        writer.set(f"{ALLOC_PREFIX}/id/100", b"keyA")
        writer.set(f"{ALLOC_PREFIX}/id/101", b"keyB")

        # three real consumers on the proxied victim backend
        cache = IPCache()
        ipwatch = IPIdentityWatcher(victim, cache)
        ipwatch.start()
        registry = NodeRegistry(victim)
        alloc = Allocator(victim, ALLOC_PREFIX, node="victim",
                          min_id=100, max_id=200)
        assert ipwatch.wait_synced(10)
        assert registry.wait_synced(10)
        _wait_for(lambda: cache.lookup_by_ip("10.1.0.2/32") == 1002,
                  msg="ipcache seed")
        _wait_for(lambda: registry.get("default/n2") is not None,
                  msg="node seed")
        _wait_for(lambda: alloc.get_by_id(101) == "keyB",
                  msg="allocator seed")

        # blind window: kill every stream, mutate, compact the history
        proxy.pause()
        proxy.reset_all()
        writer.delete(_ip_key("10.1.0.2"))
        writer.delete(f"{NODES_PATH}/default/n2")
        writer.delete(f"{ALLOC_PREFIX}/id/101")
        writer.set(_ip_key("10.1.0.3"), _ip_val("10.1.0.3", 1003))
        etcd_server.compact()
        proxy.resume()

        # relist-and-diff must deliver the synthetic DELETEs (stale
        # entries removed) and the blind-window CREATE
        _wait_for(lambda: cache.lookup_by_ip("10.1.0.2/32") is None,
                  msg="stale ipcache entry removed")
        _wait_for(lambda: registry.get("default/n2") is None,
                  msg="stale node removed")
        _wait_for(lambda: alloc.get_by_id(101) is None,
                  msg="stale allocator id removed")
        _wait_for(lambda: cache.lookup_by_ip("10.1.0.3/32") == 1003,
                  msg="blind-window create delivered")
        # survivors intact
        assert cache.lookup_by_ip("10.1.0.1/32") == 1001
        assert registry.get("default/n1") is not None
        assert alloc.get_by_id(100) == "keyA"
        # and the recovery is visible in the exported counters
        assert resilience.WATCH_RELISTS.value(
            labels={"transport": "etcd"}) > relists_before
        assert resilience.status_summary()["watch-relists"] >= 1

        ipwatch.stop()
        registry.close()
    finally:
        victim.close()
        writer.close()


# ------------------------------------------------- ambiguous mutations

def test_lock_txn_reset_between_send_and_reply_not_orphaned(
        etcd_server, proxy):
    """The create_only lock txn is applied but its reply is
    swallowed and the connection reset.  verify-on-retry reads the
    key back — value == own token — and reclaims the lock instead of
    leaving it orphaned until the lease TTL."""
    client = EtcdBackend(host="127.0.0.1", port=proxy.port,
                         lease_ttl=10.0)
    observer = EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    verifies_before = resilience.TRANSPORT_VERIFIES.total()
    try:
        proxy.drop_response_once(b"/v3/kv/txn")
        lock = client.lock_path("chaos/resource", timeout=10.0)
        assert proxy.resets_injected == 1, \
            "the txn reply should have been dropped"
        # the store holds exactly OUR token: the first (reply-less)
        # create landed and was reclaimed, not re-created or orphaned
        assert observer.get("chaos/resource.lock") == \
            lock.token.encode()
        assert resilience.TRANSPORT_VERIFIES.total() > verifies_before
        lock.unlock()
        assert observer.get("chaos/resource.lock") is None
        # the path is immediately lockable again
        lock2 = client.lock_path("chaos/resource", timeout=5.0)
        lock2.unlock()
    finally:
        client.close()
        observer.close()


def test_remote_create_only_verify_on_lost_reply():
    """The same ambiguity on the TCP frame transport: a create_only
    whose reply frame is lost resolves by reading the key back, and an
    idempotent read retries blindly within its deadline."""
    srv = KVStoreServer(port=0, expire_interval=0.1).start()
    client = RemoteBackend(port=srv.port, lease_ttl=10.0)
    try:
        orig = client._call_once
        dropped = []

        def lossy(op, timeout, args):
            resp = orig(op, timeout, args)
            if op in ("create_only", "get") and len(dropped) < 2:
                dropped.append(op)
                raise RemoteTimeout(f"{op}: injected reply loss")
            return resp

        client._call_once = lossy
        # mutation: applied server-side, reply "lost" -> verified back
        assert client.create_only("amb-key", b"tok-1") is True
        assert dropped.count("create_only") == 1
        client._call_once = orig
        assert client.get("amb-key") == b"tok-1"
        # a competing create still correctly loses
        assert client.create_only("amb-key", b"tok-2") is False
    finally:
        client.close()
        srv.shutdown()


# ------------------------------------------------- watch start revision

def test_minietcd_start_revision_zero_means_from_current(etcd_server):
    """start_revision=0 must mean 'from current' (real etcd
    semantics), not 'replay all retained history' — otherwise a
    restarted watch re-applies stale DELETEs."""
    backend = EtcdBackend(port=etcd_server.port, lease_ttl=10.0)
    try:
        backend.set("zr/a", b"1")
        backend.delete("zr/a")
        backend.set("zr/b", b"2")
        conn = http.client.HTTPConnection("127.0.0.1",
                                          etcd_server.port,
                                          timeout=2.0)
        payload = json.dumps({"create_request": {
            "key": "enIv",  # base64("zr/")
            "range_end": "enIw",  # base64("zr0")
            "start_revision": "0"}}).encode()
        conn.request("POST", "/v3/watch", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        first = json.loads(resp.readline())
        assert first["result"].get("created") is True
        # nothing replayed: the next frame must be the LIVE write
        # below (or an idle progress notify), never history
        backend.set("zr/c", b"3")
        deadline = time.monotonic() + 3.0
        seen = []
        while time.monotonic() < deadline:
            msg = json.loads(resp.readline())
            events = msg.get("result", {}).get("events", [])
            if events:
                seen = events
                break
        assert len(seen) == 1
        assert seen[0]["kv"]["key"] == "enIvYw=="  # base64("zr/c")
        conn.close()
    finally:
        backend.close()



# ------------------------------------------------------- unit tier

def test_circuit_breaker_lifecycle():
    b = CircuitBreaker("unit", failure_threshold=2, reset_timeout=0.1,
                       max_reset=0.4)
    assert b.allow() and b.state == "closed"
    b.record_failure()
    assert b.state == "closed"
    b.record_failure()
    assert b.state == "open"
    assert not b.allow()
    time.sleep(0.12)
    assert b.allow()  # the single half-open probe
    assert b.state == "half-open"
    assert not b.allow()  # nobody else rides along
    b.record_failure()  # probe failed: re-open, timeout doubled
    assert b.state == "open"
    assert 0.1 < b.retry_in() <= 0.2
    time.sleep(0.25)
    assert b.allow()
    b.record_success()
    assert b.state == "closed" and b.allow()


def test_deadline_and_faulty_socket():
    d = Deadline(0.05)
    assert not d.expired and d.remaining() > 0
    time.sleep(0.06)
    assert d.expired and d.remaining() == 0.0
    assert Deadline(None).remaining() == float("inf")

    a, b = socket.socketpair()
    try:
        fs = FaultySocket(a, partial_write=3)
        fs.sendall(b"0123456789")  # fragmented on the wire...
        got = b""
        while len(got) < 10:
            got += b.recv(10)
        assert got == b"0123456789"  # ...but delivered in full
        fs2 = FaultySocket(a, reset_after_bytes=4)
        with pytest.raises(ConnectionResetError):
            fs2.sendall(b"xxxxxxxx")
    finally:
        a.close()
        b.close()


def test_daemon_status_exports_transport_resilience():
    d = Daemon(config=DaemonConfig(state_dir=""), device="cpu")
    try:
        transports = d.status()["transports"]
        for key in ("retries", "deadline-expired", "verify-on-retry",
                    "watch-relists", "synthetic-events",
                    "breaker-transitions", "breakers"):
            assert key in transports
        text = d.metrics_text()
        assert "transport_retries_total" in text
        assert "transport_watch_relists_total" in text
        assert "transport_breaker_transitions_total" in text
    finally:
        d.shutdown()


# ------------------------------------------------------ loudness lint
# A copy of tests/test_flight_recorder.py's lint over the port's
# DEGRADED_SIGNALS, run on a port agent with and without a kvstore.

SIGNAL_KEYS = {"state", "status", "mode", "warnings", "drift-audit"}


def _degraded_sections(status):
    """status() sections that can report a degraded condition: any
    dict section carrying a state/status/mode/warnings signal key."""
    return {k for k, v in status.items()
            if isinstance(v, dict) and SIGNAL_KEYS & set(v)}


@pytest.mark.parametrize("backend", [None, "in-memory"])
def test_loudness_lint_every_degraded_signal_has_event_and_metric(backend):
    """Every status() section of a live port agent that reports a
    degraded condition is covered by DEGRADED_SIGNALS with declared
    flight-recorder event types and registered metric series."""
    kv = InMemoryBackend() if backend else None
    d = Daemon(config=DaemonConfig(
        state_dir="", drift_audit_interval_s=0,
        enable_kvstore_survival=kv is not None),
        kvstore_backend=kv, device="cpu")
    try:
        sections = _degraded_sections(d.status())
    finally:
        d.shutdown()
    assert sections, "status() lost its degraded-signal sections"
    uncovered = sections - set(DEGRADED_SIGNALS)
    assert not uncovered, (
        "status() sections reporting degraded conditions without "
        "flight-recorder coverage (add them to "
        f"observability/events.py DEGRADED_SIGNALS): {uncovered}")
    stale = set(DEGRADED_SIGNALS) - sections
    assert not stale, (
        f"DEGRADED_SIGNALS names status() sections that no longer "
        f"exist: {stale}")
    with metrics_mod.registry._lock:
        registered = set(metrics_mod.registry._metrics)
    for section, cover in DEGRADED_SIGNALS.items():
        assert cover["events"], section
        for ev in cover["events"]:
            assert ev in EVENT_TYPES, (
                f"{section} names undeclared event type {ev!r}")
        assert cover["metrics"], section
        for m in cover["metrics"]:
            assert m in registered, (
                f"{section} names unregistered metric {m!r}")


def test_every_event_type_belongs_to_a_degraded_signal():
    """No orphan event types: each declared type is reachable from some
    degraded condition's coverage."""
    covered = {ev for cover in DEGRADED_SIGNALS.values()
               for ev in cover["events"]}
    orphans = set(EVENT_TYPES) - covered
    assert not orphans, (
        f"EVENT_TYPES declares types no DEGRADED_SIGNALS entry "
        f"covers: {orphans}")
