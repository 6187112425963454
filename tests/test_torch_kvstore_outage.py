"""The kvstore's outage and transport-fault behaviour, held against the
JAX package on the same inputs.

Every case runs one script on both packages and compares what the two
runs saw, step by step:

- the write journal under a seeded random mutation sequence;
- the outage guard with and without degrade (mode, journal, report,
  the exceptions it raises, its reconcile);
- the identity fallback with seeded distributed allocators (adoption,
  node-local identities, refcounts);
- the compaction relist of the ipcache watcher, the node registry and
  the allocator, and the ambiguous lock txn, each package's client
  behind its own ``FaultProxy`` to one ``MiniEtcd``;
- the agent's outage journey: a JAX ``Daemon`` and a port
  ``Daemon(device="cpu")``, each behind its own fault proxy to one
  ``MiniEtcd``, blackholed, given an endpoint, healed and promoted in
  lockstep, with ``status()["kvstore"]``, the flight recorder's kvstore
  events, the promotion report, identities and verdicts compared at
  each step.

Timing fields (staleness, durations, breaker half-open races) are
compared by what they must show (positive, not closed), everything
else by equality.  Every server, proxy, backend and agent is closed in
``finally`` or in a fixture.
"""

import json
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest

import cilium_tpu.daemon as ref_daemon
import cilium_tpu.identity as ref_identity
import cilium_tpu.ipcache.ipcache as ref_ipcache
import cilium_tpu.ipcache.kvstore_sync as ref_kvstore_sync
import cilium_tpu.kvstore.allocator as ref_allocator
import cilium_tpu.kvstore.etcd as ref_etcd
import cilium_tpu.kvstore.identity_allocator as ref_identity_allocator
import cilium_tpu.kvstore.journal as ref_journal
import cilium_tpu.kvstore.memory as ref_memory
import cilium_tpu.kvstore.outage as ref_outage
import cilium_tpu.labels as ref_labels
import cilium_tpu.node.registry as ref_registry
import cilium_tpu.observability.events as ref_events
import cilium_tpu.policy.jsonio as ref_jsonio
import cilium_tpu.policy.mapstate as ref_mapstate
import cilium_tpu.utils.faultinject as ref_faultinject
import cilium_tpu.utils.option as ref_option
import cilium_tpu.utils.resilience as ref_resilience

import cilium_tpu_torch.daemon as port_daemon
import cilium_tpu_torch.identity as port_identity
import cilium_tpu_torch.ipcache.ipcache as port_ipcache
import cilium_tpu_torch.ipcache.kvstore_sync as port_kvstore_sync
import cilium_tpu_torch.kvstore.allocator as port_allocator
import cilium_tpu_torch.kvstore.etcd as port_etcd
import cilium_tpu_torch.kvstore.identity_allocator as port_identity_allocator
import cilium_tpu_torch.kvstore.journal as port_journal
import cilium_tpu_torch.kvstore.memory as port_memory
import cilium_tpu_torch.kvstore.outage as port_outage
import cilium_tpu_torch.labels as port_labels
import cilium_tpu_torch.node.registry as port_registry
import cilium_tpu_torch.observability.events as port_events
import cilium_tpu_torch.policy.jsonio as port_jsonio
import cilium_tpu_torch.policy.mapstate as port_mapstate
import cilium_tpu_torch.utils.faultinject as port_faultinject
import cilium_tpu_torch.utils.option as port_option
import cilium_tpu_torch.utils.resilience as port_resilience
from cilium_tpu_torch.kvstore.mini_etcd import MiniEtcd


def _pkg(daemon, identity, ipcache, kvstore_sync, allocator, etcd,
         identity_allocator, journal, memory, outage, labels, registry,
         events, jsonio, mapstate, faultinject, option, resilience):
    return SimpleNamespace(
        Daemon=daemon.Daemon, DaemonConfig=option.DaemonConfig,
        is_local=identity.is_local_scope_identity,
        LOCAL_BASE=identity.LOCAL_SCOPE_IDENTITY_BASE,
        IPCache=ipcache.IPCache,
        IPIdentityWatcher=kvstore_sync.IPIdentityWatcher,
        IP_PATH=kvstore_sync.IP_IDENTITIES_PATH,
        Allocator=allocator.Allocator, EtcdBackend=etcd.EtcdBackend,
        Distributed=identity_allocator.DistributedIdentityAllocator,
        Fallback=identity_allocator.FallbackIdentityAllocator,
        WriteJournal=journal.WriteJournal,
        InMemoryBackend=memory.InMemoryBackend,
        OutageGuard=outage.OutageGuard, Labels=labels.Labels,
        parse_label=labels.parse_label,
        NodeRegistry=registry.NodeRegistry, NODES_PATH=registry.NODES_PATH,
        recorder=events.recorder, rules_from_json=jsonio.rules_from_json,
        PolicyMapState=mapstate.PolicyMapState,
        FaultProxy=faultinject.FaultProxy,
        Injector=faultinject.ControlPlaneFaultInjector,
        WATCH_RELISTS=resilience.WATCH_RELISTS,
        TRANSPORT_VERIFIES=resilience.TRANSPORT_VERIFIES)


PKGS = {
    "ref": _pkg(ref_daemon, ref_identity, ref_ipcache, ref_kvstore_sync,
                ref_allocator, ref_etcd, ref_identity_allocator,
                ref_journal, ref_memory, ref_outage, ref_labels,
                ref_registry, ref_events, ref_jsonio, ref_mapstate,
                ref_faultinject, ref_option, ref_resilience),
    "port": _pkg(port_daemon, port_identity, port_ipcache,
                 port_kvstore_sync, port_allocator, port_etcd,
                 port_identity_allocator, port_journal, port_memory,
                 port_outage, port_labels, port_registry, port_events,
                 port_jsonio, port_mapstate, port_faultinject,
                 port_option, port_resilience),
}
SIDES = ("ref", "port")
WAIT_S = 60.0


def _wait_for(cond, msg, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _labels(m, *items):
    return m.Labels.from_labels(m.parse_label(i) for i in items)


def _attempt(fn):
    """("ok", result) or ("raise", exception class name)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class is the result
        return ("raise", type(e).__name__)


@pytest.fixture()
def etcd_server():
    srv = MiniEtcd(reap_interval=0.1).start()
    yield srv
    srv.shutdown()


# ------------------------------------------------------------ journal

def _journal_run(m, seed):
    """A seeded random mutation sequence; after each step the depth,
    the counters and the pending entries in replay order."""
    rng = np.random.RandomState(seed)
    keys = ["a", "b", "p/x", "p/y", "p/", "q/z", "q/"]
    ops = ["set", "delete", "delete_prefix", "create_only",
           "create_if_exists", "discard_key", "discard"]
    j = m.WriteJournal(max_entries=4)
    trace = []
    for step in range(300):
        op = ops[rng.randint(len(ops))]
        key = keys[rng.randint(len(keys))]
        if op == "discard_key":
            j.discard_key(key)
        elif op == "discard":
            pending = j.snapshot()
            if pending:
                j.discard(pending[rng.randint(len(pending))])
        else:
            j.record(op, key, value=str(step).encode(),
                     lease=bool(rng.randint(2)),
                     cond_key="c" if op == "create_if_exists" else "")
        trace.append((op, key, j.depth(), j.stats(),
                      [(e.seq, e.op, e.key, e.value, e.lease, e.cond_key)
                       for e in j.snapshot()]))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_journal_matches_reference(seed):
    runs = {side: _journal_run(PKGS[side], seed) for side in SIDES}
    assert runs["port"] == runs["ref"]
    # the sequence exercised coalescing, the prefix delete and the bound
    last = runs["port"][-1][3]
    assert last["coalesced"] > 0 and last["dropped"] > 0


# ------------------------------------------------------- outage guard

def _flaky(m):
    """``m``'s in-memory backend with a failure switch."""

    class Flaky(m.InMemoryBackend):
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

    return Flaky()


def _stable_report(rep):
    """A guard report with its clock readings reduced to what they
    must show."""
    out = dict(rep)
    out["staleness-seconds"] = out["staleness-seconds"] > 0
    out["breaker"] = out["breaker"] == "closed"
    out["consecutive-failures"] = out["consecutive-failures"] > 0
    if out.get("last-reconcile"):
        rec = dict(out["last-reconcile"])
        rec.pop("duration-s")
        rec["outage-s"] = rec["outage-s"] > 0
        out["last-reconcile"] = rec
    return out


def _guard_run(m, degrade):
    """The guard's script of ``test_kvstore``'s outage cases: a healthy
    write, a failing window (journaled or raised), fast-failing reads,
    locks and CAS creates, a lease the server reaps behind the guard,
    the reconnect and its reconcile."""
    inner = _flaky(m)
    guard = m.OutageGuard(inner, degrade=degrade, failure_threshold=2,
                          probe_interval=0.05)
    trace = []

    def note(step, result=None):
        trace.append((step, result, guard.mode, guard.journal.depth(),
                      _stable_report(guard.report())))

    try:
        guard.track_prefix("t/")
        note("set-pre", _attempt(lambda: guard.set("t/pre", b"v0",
                                                   lease=True)))
        inner.fail = True
        note("set-1", _attempt(lambda: guard.set("t/k", b"v1",
                                                 lease=True)))
        note("set-2", _attempt(lambda: guard.set("t/k", b"v2",
                                                 lease=True)))
        note("delete", _attempt(lambda: guard.delete("t/gone")))
        t0 = time.monotonic()
        note("get", _attempt(lambda: guard.get("t/pre")))
        fast = time.monotonic() - t0 < 0.5
        note("lock", _attempt(lambda: guard.lock_path("t/lock", 0.2)
                              and None))
        note("create-only", _attempt(lambda: guard.create_only(
            "t/master", b"x")))
        # the server reaps a lease-backed key during the outage
        m.InMemoryBackend.delete(inner, "t/pre")
        inner.fail = False
        time.sleep(0.1)
        event = guard.tick()
        if event.get("report"):
            event = dict(event, report=_stable_report(
                {"staleness-seconds": 0, "breaker": "closed",
                 "consecutive-failures": 0,
                 "last-reconcile": event["report"]})["last-reconcile"])
        note("tick", event)
        note("after", [m.InMemoryBackend.get(inner, k)
                       for k in ("t/k", "t/pre", "t/gone")])
        note("get-again", _attempt(lambda: guard.get("t/k")))
        return trace, fast
    finally:
        guard.close()


@pytest.mark.parametrize("degrade", [True, False])
def test_outage_guard_matches_reference(degrade):
    runs = {side: _guard_run(PKGS[side], degrade) for side in SIDES}
    assert runs["port"][0] == runs["ref"][0]
    trace, fast = runs["port"]
    steps = {step: rest for step, *rest in trace}
    if degrade:
        assert fast
        assert steps["set-1"][0] == ("ok", None)
        assert steps["tick"][0]["reconciled"] is True
        assert steps["after"][0] == [b"v2", b"v0", None]
    else:
        assert steps["set-1"][0] == ("raise", "OSError")
        assert steps["tick"][0] == {}


# ---------------------------------------------------- identity fallback

def _fallback_run(m, seed):
    backend = m.InMemoryBackend()
    guard = m.OutageGuard(backend, degrade=True, failure_threshold=1,
                          probe_interval=0.05)
    dist = m.Distributed(guard, node="n1", cluster_id=2, seed=seed)
    fb = m.Fallback(dist, guard=guard)
    trace = []

    def alloc(*labels):
        ident, is_new = fb.allocate(_labels(m, *labels))
        trace.append(("allocate", labels, ident.id, is_new,
                      m.is_local(ident.id), fb.local_count()))
        return ident

    try:
        web = alloc("k8s:id=web")
        alloc("k8s:id=db")
        guard._note_failure()
        trace.append(("mode", guard.mode))
        again = alloc("k8s:id=web")         # adopted from the cache
        trace.append(("release", fb.release(again)))
        tmp = alloc("k8s:id=tmp")           # node-local
        tmp2 = alloc("k8s:id=tmp")          # refcounted
        other = alloc("k8s:id=other", "k8s:x=1")
        trace.append(("lookup", fb.lookup_by_id(tmp.id).id,
                      fb.lookup_by_labels(_labels(m, "k8s:id=tmp")).id,
                      sorted(i.id for i in fb.snapshot_identities()),
                      len(fb)))
        trace.append(("release", fb.release(tmp2), fb.release(tmp),
                      fb.release(other), fb.local_count()))
        trace.append(("counts", fb.fallback_allocations, fb.adoptions,
                      web.id >> 16))
        return trace
    finally:
        fb.close()
        backend.close()


@pytest.mark.parametrize("seed", [3, 11])
def test_fallback_allocator_matches_reference(seed):
    runs = {side: _fallback_run(PKGS[side], seed) for side in SIDES}
    assert runs["port"] == runs["ref"]
    local = [t for t in runs["port"] if t[0] == "allocate" and t[4]]
    assert [t[2] for t in local] == [PKGS["port"].LOCAL_BASE + 1,
                                     PKGS["port"].LOCAL_BASE + 1,
                                     PKGS["port"].LOCAL_BASE + 2]


# ---------------------------------------------------- transport faults

def _ip_key(m, ip):
    return f"{m.IP_PATH}/{ip}"


def _ip_val(ip, ident):
    return json.dumps({"IP": ip, "ID": ident, "HostIP": None,
                       "Metadata": ""}).encode()


def _node_val(name):
    return json.dumps({"Name": name, "Cluster": "default",
                       "ClusterID": 0, "IPAddresses": [],
                       "IPv4AllocCIDR": None,
                       "IPv6AllocCIDR": None}).encode()


ALLOC_PREFIX = "cilium/test-chaos-alloc"
PROBE_IPS = ("10.1.0.1/32", "10.1.0.2/32", "10.1.0.3/32")
PROBE_NODES = ("default/n1", "default/n2")


def test_compaction_relist_matches_reference(etcd_server):
    """Both packages' ipcache watcher, node registry and allocator watch
    one store through their own proxy; the streams die, the world
    changes, the history is compacted, and both relist to the same
    view."""
    m0 = PKGS["port"]
    writer = m0.EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    made = {side: [] for side in SIDES}
    consumers = {}

    def view(side):
        cache, registry, alloc = consumers[side]
        return ([cache.lookup_by_ip(ip) for ip in PROBE_IPS],
                [registry.get(n) is not None for n in PROBE_NODES],
                [alloc.get_by_id(i) for i in (100, 101)])

    try:
        writer.set(_ip_key(m0, "10.1.0.1"), _ip_val("10.1.0.1", 1001))
        writer.set(_ip_key(m0, "10.1.0.2"), _ip_val("10.1.0.2", 1002))
        writer.set(f"{m0.NODES_PATH}/default/n1", _node_val("n1"))
        writer.set(f"{m0.NODES_PATH}/default/n2", _node_val("n2"))
        writer.set(f"{ALLOC_PREFIX}/id/100", b"keyA")
        writer.set(f"{ALLOC_PREFIX}/id/101", b"keyB")
        relists = {}
        for side in SIDES:
            m = PKGS[side]
            relists[side] = m.WATCH_RELISTS.value(
                labels={"transport": "etcd"})
            proxy = m.FaultProxy("127.0.0.1", etcd_server.port).start()
            made[side].append(proxy)
            victim = m.EtcdBackend(host="127.0.0.1", port=proxy.port,
                                   lease_ttl=30.0)
            made[side].append(victim)
            cache = m.IPCache()
            watch = m.IPIdentityWatcher(victim, cache)
            watch.start()
            made[side].append(watch)
            registry = m.NodeRegistry(victim)
            made[side].append(registry)
            alloc = m.Allocator(victim, ALLOC_PREFIX, node="victim",
                                min_id=100, max_id=200)
            consumers[side] = (cache, registry, alloc)
            assert watch.wait_synced(10) and registry.wait_synced(10)
        seeded = ([1001, 1002, None], [True, True], ["keyA", "keyB"])
        for side in SIDES:
            _wait_for(lambda side=side: view(side) == seeded,
                      f"{side} seeded")

        for side in SIDES:
            made[side][0].pause()
            made[side][0].reset_all()
        writer.delete(_ip_key(m0, "10.1.0.2"))
        writer.delete(f"{m0.NODES_PATH}/default/n2")
        writer.delete(f"{ALLOC_PREFIX}/id/101")
        writer.set(_ip_key(m0, "10.1.0.3"), _ip_val("10.1.0.3", 1003))
        etcd_server.compact()
        for side in SIDES:
            made[side][0].resume()

        relisted = ([1001, None, 1003], [True, False], ["keyA", None])
        for side in SIDES:
            _wait_for(lambda side=side: view(side) == relisted,
                      f"{side} relisted")
        assert view("port") == view("ref")
        grew = [PKGS[side].WATCH_RELISTS.value(
            labels={"transport": "etcd"}) > relists[side]
            for side in SIDES]
        assert grew == [True, True]
    finally:
        for side in SIDES:
            for obj in reversed(made[side]):
                for name in ("stop", "close"):
                    if hasattr(obj, name):
                        getattr(obj, name)()
                        break
        writer.close()


def test_ambiguous_lock_txn_matches_reference(etcd_server):
    """The lock txn is applied but its reply is lost and the connection
    reset: both packages read the key back and hold the lock, neither
    re-creates nor orphans it."""
    m0 = PKGS["port"]
    observer = m0.EtcdBackend(port=etcd_server.port, lease_ttl=30.0)
    outcome = {}
    try:
        for side in SIDES:
            m = PKGS[side]
            proxy = m.FaultProxy("127.0.0.1", etcd_server.port).start()
            client = m.EtcdBackend(host="127.0.0.1", port=proxy.port,
                                   lease_ttl=10.0)
            try:
                verifies = m.TRANSPORT_VERIFIES.total()
                proxy.drop_response_once(b"/v3/kv/txn")
                path = f"chaos/{side}"
                lock = client.lock_path(path, timeout=10.0)
                held = observer.get(f"{path}.lock") == lock.token.encode()
                lock.unlock()
                freed = observer.get(f"{path}.lock") is None
                client.lock_path(path, timeout=5.0).unlock()
                outcome[side] = (proxy.resets_injected, held, freed,
                                 m.TRANSPORT_VERIFIES.total() > verifies)
            finally:
                client.close()
                proxy.close()
    finally:
        observer.close()
    assert outcome["port"] == outcome["ref"] == (1, True, True, True)


# ------------------------------------------------- the outage journey

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
# each node's addresses: 10.<net>.0.x for web / db / tmp, 10.<net>.1.x
# for the bystanders the promotion must not regenerate
NET = {"ref": 1, "port": 2}
NODE = {"ref": "node-j", "port": "node-p"}
WEB, DB, TMP = 10, 11, 12
BYSTANDERS = 4


def _ip(side, octet, sub=0):
    return f"10.{NET[side]}.{sub}.{octet}"


def _ip_u32(dotted):
    a, b, c, d = (int(x) for x in dotted.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def _recs(side, slot, dport, src, sport0, flags=0x02, n=4):
    return {"endpoint": np.full(n, slot, np.int32),
            "saddr": np.full(n, _ip_u32(_ip(side, src)),
                             np.uint32).view(np.int32),
            "daddr": np.full(n, _ip_u32(_ip(side, DB)),
                             np.uint32).view(np.int32),
            "sport": (sport0 + np.arange(n)).astype(np.int32),
            "dport": np.full(n, dport, np.int32),
            "proto": np.full(n, 6, np.int32),
            "direction": np.zeros(n, np.int32),   # ingress to db
            "tcp_flags": np.full(n, flags, np.int32),
            "is_fragment": np.zeros(n, np.int32),
            "length": np.full(n, 256, np.int32)}


def _verdicts(d, side, *args, **kw):
    """(verdicts, identities) of one batch to ``d``'s db endpoint."""
    recs = _recs(side, d.endpoints.lookup(2).table_slot, *args, **kw)
    t = d.datapath.serving().submit_records(recs, len(recs["sport"]))
    v, i = t.result(timeout=120)
    assert t.error is None
    return np.asarray(v).tolist(), np.asarray(i).tolist()


def _both(agents, fn):
    """``fn(daemon, side)`` on both agents; asserts the results are
    equal and returns the port's."""
    out = {side: fn(agents[side], side) for side in SIDES}
    assert out["port"] == out["ref"], out
    return out["port"]


def _kv_status(d, _side):
    st = dict(d.status()["kvstore"])
    # "etcd: ok (host:port, lease N)" / "etcd: DEGRADED (outage 1.2s,
    # ...)": the words, not the addresses, leases or seconds
    st["state"] = re.sub(r"\(.*", "", st["state"]).strip() + \
        (" DEGRADED" if "DEGRADED" in st["state"] else "")
    return _stable_report(st)


def _kv_events(m, seq0):
    """The kvstore events the package's flight recorder holds since
    ``seq0``, without their clocks."""
    out = []
    for e in m.recorder.events(seq0, 1000, None, None):
        e = e.to_dict()
        if not e["type"].startswith("kvstore-"):
            continue
        attrs = {k: (v > 0 if k == "outage_s" else v)
                 for k, v in e["attrs"].items()}
        out.append((e["type"], re.sub(r"\d+ consecutive", "N consecutive",
                                      e["detail"]), attrs))
    return out


def _promotions(d, _side):
    return [e.note for e in d.monitor.tail(1000, kind="agent")
            if e.note.startswith("identity-promotion")]


@pytest.fixture()
def outage_pair(etcd_server):
    """{side: (agent, injector)}: the JAX agent and the port agent, each
    through its own fault proxy to ``etcd_server``, with the outage
    guard's degrade on at the chaos tests' cadence."""
    made, agents = [], {}
    try:
        for side in SIDES:
            m = PKGS[side]
            proxy = m.FaultProxy("127.0.0.1", etcd_server.port).start()
            made.append(proxy)
            inj = m.Injector(etcd=proxy)
            made.append(inj)
            kv = m.EtcdBackend(host="127.0.0.1", port=proxy.port,
                               lease_ttl=30.0, timeout=1.0)
            cfg = m.DaemonConfig(state_dir="", drift_audit_interval_s=0,
                                 ct_checkpoint_interval_s=0,
                                 enable_kvstore_survival=True,
                                 kvstore_probe_interval_s=0.1,
                                 kvstore_failure_threshold=2,
                                 enable_hubble=False)
            kw = {} if side == "ref" else {"device": "cpu"}
            try:
                d = m.Daemon(config=cfg, kvstore_backend=kv,
                             node_name=NODE[side], **kw)
            except BaseException:
                kv.close()
                raise
            agents[side] = (d, inj, kv)
        yield agents
    finally:
        for side, (d, _inj, kv) in agents.items():
            d.shutdown()
            if side == "ref":
                # the reference's shutdown leaves its backend to the
                # caller; the port's closes the backend it was given
                kv.close()
        for obj in reversed(made):
            obj.close()


def test_outage_journey_matches_reference(outage_pair):
    """Blackhole both agents' store mid-run, add an endpoint on each
    while degraded, heal, promote: the two packages go through the same
    states, record the same events, promote alike and give the same
    verdicts at every step."""
    agents = {side: d for side, (d, _i, _k) in outage_pair.items()}
    injectors = {side: inj for side, (_d, inj, _k) in outage_pair.items()}
    m = PKGS["port"]
    for side, d in agents.items():
        M = PKGS[side]
        d.endpoint_create(1, ipv4=_ip(side, WEB), labels=["k8s:id=web"])
        d.endpoint_create(2, ipv4=_ip(side, DB), labels=["k8s:id=db"])
        for k in range(BYSTANDERS):
            d.endpoint_create(10 + k, ipv4=_ip(side, 10 + k, sub=1),
                              labels=[f"k8s:id=bystander{k}"])
        rev = d.policy_add(M.rules_from_json(RULES_JSON))
        assert d.wait_for_policy_revision(rev, timeout=WAIT_S)
    st = _both(agents, _kv_status)
    assert st["mode"] == "ok" and st["backend"] == "EtcdBackend"
    ids = _both(agents, lambda d, _s: [
        d.endpoints.lookup(e).security_identity for e in (1, 2, 10)])
    assert not any(m.is_local(i) for i in ids)

    # a long-lived flow web -> db:5432, SYN then ACK
    v, _ = _both(agents, lambda d, s: _verdicts(d, s, 5432, WEB, 40000))
    assert v == [0] * 4
    v, _ = _both(agents, lambda d, s: _verdicts(d, s, 5432, WEB, 40000,
                                                flags=0x10))
    assert v == [0] * 4

    # ---- blackhole both ----
    seq0 = {side: PKGS[side].recorder.last_seq for side in SIDES}
    for side in SIDES:
        injectors[side].blackhole("etcd")
    for side, d in agents.items():
        _wait_for(lambda d=d: d.status()["kvstore"]["mode"] ==
                  "degraded", f"{side} degraded")
    st = _both(agents, _kv_status)
    assert st["mode"] == "degraded" and st["outages"] == 1
    assert st["staleness-seconds"] and not st["breaker"]
    assert st["state"].endswith("DEGRADED")
    assert _both(agents, lambda d, _s: d.run_drift_audit()["status"]) \
        in ("ok", "idle")
    v, _ = _both(agents, lambda d, s: _verdicts(d, s, 5432, WEB, 40000,
                                                flags=0x10))
    assert v == [0] * 4
    v, _ = _both(agents, lambda d, s: _verdicts(d, s, 9999, WEB, 41000))
    assert all(x < 0 for x in v)

    # ---- an endpoint created during the outage ----
    local_id = _both(agents, lambda d, s: d.endpoint_create(
        3, ipv4=_ip(s, TMP), labels=["k8s:id=tmp"]).security_identity)
    assert m.is_local(local_id)
    for d in agents.values():
        assert d.wait_for_policy_revision(None, timeout=WAIT_S)
    st = _both(agents, _kv_status)
    assert st["local-identities"] == 1 and st["fallback-allocations"] == 1
    assert st["journal-depth"] >= 1
    v, ident = _both(agents, lambda d, s: _verdicts(d, s, 7000, TMP,
                                                    42000))
    assert v == [0] * 4 and ident == [local_id] * 4
    v, _ = _both(agents, lambda d, s: _verdicts(d, s, 9999, TMP, 43000))
    assert all(x < 0 for x in v)

    # ---- heal both ----
    for side in SIDES:
        injectors[side].heal()
    for side, d in agents.items():
        _wait_for(lambda d=d: d.status()["kvstore"]["mode"] == "ok" and
                  d.status()["kvstore"]["local-identities"] == 0,
                  f"{side} recovered and promoted")
    new_id = _both(agents, lambda d, _s:
                   d.endpoints.lookup(3).security_identity)
    assert not m.is_local(new_id)

    def db_promoted(d, side):
        state = PKGS[side].PolicyMapState(d.endpoints.lookup(2).realized)
        keys = [k for k in state.keys() if k.dest_port == 7000]
        return bool(keys) and all(k.identity == new_id for k in keys)
    for side, d in agents.items():
        _wait_for(lambda d=d, side=side: db_promoted(d, side) and
                  d.wait_for_quiesce(0.1), f"{side} re-keyed db")

    st = _both(agents, _kv_status)
    assert st["mode"] == "ok" and st["journal-depth"] == 0
    assert st["last-reconcile"]["replayed"] >= 1
    notes = _both(agents, _promotions)
    assert notes == ["identity-promotion promoted=1 rekeyed=1 "
                     "regenerated=2"]
    events = {side: _kv_events(PKGS[side], seq0[side]) for side in SIDES}
    assert events["port"] == events["ref"]
    assert [t for t, _d, _a in events["port"]] == [
        "kvstore-degraded", "kvstore-reconciling", "kvstore-recovered"]

    # identities by labels, the established flow, the promoted verdicts
    _both(agents, lambda d, _s: sorted(
        (tuple(sorted(str(x) for x in i.labels.to_array())), i.id)
        for i in d.identity_allocator.snapshot_identities()))
    v, _ = _both(agents, lambda d, s: _verdicts(d, s, 5432, WEB, 40000,
                                                flags=0x10))
    assert v == [0] * 4
    v, ident = _both(agents, lambda d, s: _verdicts(d, s, 7000, TMP,
                                                    44000))
    assert v == [0] * 4 and ident == [new_id] * 4
    assert _both(agents, lambda d, _s: d.run_drift_audit()["status"]) \
        in ("ok", "idle")
