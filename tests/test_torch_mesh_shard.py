"""The port's sharded dataplane (``cilium_tpu_torch/parallel/``) against
the JAX package's, on the CPU.

Both planes have four ep-shards over a (dp=2, ep=4) grid: the JAX plane
over the eight virtual CPU devices that ``tests/conftest.py`` forces,
the port's over ``devices=[cpu] * 8``.  Both get the same config-1
policy, flows and provenance on, and the same numpy-seeded record
chunks through ``classify_records``; with the engines' clocks frozen to
one second, every verdict, identity and provenance tier, every shard's
CT fields (``snapshot_ct``), counters by global slot and flow table,
``policy_replay``, ``ct_entries``, ``gc``, ``map_inventory`` and
``map_pressure`` must be equal (tolerance 0).  Also: CT snapshots
written by either plane restore in the other, the shard-kill journey on
the port's plane, the sharded table manager, and the sharded agent on
the CPU (its status naming a faulted shard, and a JAX sharded agent's
state directory restoring in the port's).
"""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from cilium_tpu.daemon import Daemon as RefDaemon
from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.datapath import supervisor as ref_supervisor
from cilium_tpu.parallel import ShardedDatapath as RefSharded
from cilium_tpu.parallel import ShardedTableManager as RefTableManager
from cilium_tpu.policy import mapstate as ref_ms
from cilium_tpu.policy.jsonio import rules_from_json as ref_rules_from_json
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig

from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.datapath import engine, supervisor
from cilium_tpu_torch.datapath.engine import Datapath, make_full_batch
from cilium_tpu_torch.datapath.pipeline import PACKED_FIELDS
from cilium_tpu_torch.parallel import (ShardedDatapath, ShardedTableManager,
                                       make_mesh)
from cilium_tpu_torch.policy.jsonio import rules_from_json
from cilium_tpu_torch.policy.mapstate import (INGRESS, PolicyKey,
                                              PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.utils.faultinject import DeviceFaultInjector
from cilium_tpu_torch.utils.metrics import (DATAPLANE_RECOVERIES,
                                            DATAPLANE_SHARD_FAULTS,
                                            DATAPLANE_SHARD_MODE)
from cilium_tpu_torch.utils.option import DaemonConfig
from cilium_tpu_torch.workloads import (build_config1, policy_packets,
                                        policy_remotes, policy_state)

from test_torch_serving import ref_states

N_ENDPOINTS = 8
N_SHARDS = 4
CT_SLOTS = 1 << 10
FLOW_SLOTS = 1 << 10
CPU8 = [torch.device("cpu")] * 8
# the engines' and supervisors' wall clock, frozen for the module: the
# two planes stamp CT expiries from it, so they must read one second
T0 = 1_700_000_000
WAIT_S = 60.0

_STATES, _PREFIXES = build_config1(n_rules=30, n_endpoints=N_ENDPOINTS)
_SPORT = [30000]


class FrozenClock:
    """The ``time`` module with ``time()`` held at ``T0``."""

    def time(self):
        return float(T0)

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(autouse=True, scope="module")
def _frozen_clock():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_engine, engine, ref_supervisor, supervisor):
            mp.setattr(mod, "time", FrozenClock())
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def chunk(rng, n, hit_frac=0.5):
    """SoA record chunk over every endpoint, source ports unique across
    the module; ``hit_frac`` of the destinations fall in installed
    prefixes, so a share is allowed and creates CT entries."""
    base = _SPORT[0]
    _SPORT[0] += n
    daddr = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    cidrs = list(_PREFIXES)
    for j in range(int(n * hit_frac)):
        a = cidrs[j % len(cidrs)].split("/")[0].split(".")
        daddr[j] = (int(a[0]) << 24) | (int(a[1]) << 16) | \
            (int(a[2]) << 8) | 7
    return {
        "endpoint": rng.integers(0, N_ENDPOINTS, n).astype(np.int32),
        "saddr": rng.integers(0, 1 << 32, n, dtype=np.uint32).view(np.int32),
        "daddr": daddr.view(np.int32),
        "sport": ((base + np.arange(n)) % 64000 + 1024).astype(np.int32),
        "dport": rng.integers(1, 65536, n).astype(np.int32),
        "proto": np.full(n, 6, np.int32),
        "direction": np.ones(n, np.int32),
        "tcp_flags": np.full(n, 0x02, np.int32),
        "is_fragment": np.zeros(n, np.int32),
        "length": np.full(n, 256, np.int32),
    }


def cp(c):
    return {k: v.copy() for k, v in c.items()}


def configure(p):
    p.telemetry_enabled = False
    p.configure_supervision(enabled=True, watchdog_s=5.0,
                            failure_threshold=1, reset_s=0.05)
    p.enable_flow_aggregation(slots=FLOW_SLOTS)
    p.enable_provenance()
    return p


@pytest.fixture(scope="module")
def planes():
    """(JAX plane, port plane): (dp=2, ep=4), flows and provenance on,
    the same policy; source ports never repeat across the module."""
    ref = configure(RefSharded(n_shards=N_SHARDS, ct_slots=CT_SLOTS))
    port = configure(ShardedDatapath(n_shards=N_SHARDS, devices=CPU8,
                                     ct_slots=CT_SLOTS))
    ref.load_policy(ref_states(_STATES), revision=1,
                    ipcache_prefixes=_PREFIXES)
    port.load_policy(_STATES, revision=1, ipcache_prefixes=_PREFIXES)
    try:
        yield ref, port
    finally:
        for p in (ref, port):
            p.serving().close()


def both(planes, c):
    """Classify one chunk on both planes; assert verdicts and identities
    equal and return the port's."""
    ref, port = planes
    n = len(c["sport"])
    rv, ri = ref.classify_records(cp(c), n)
    pv, pi = port.classify_records(cp(c), n)
    np.testing.assert_array_equal(pv, np.asarray(rv))
    np.testing.assert_array_equal(pi, np.asarray(ri))
    return pv, pi


def assert_ct_equal(ref, port):
    r4, r6 = ref.snapshot_ct()
    p4, p6 = port.snapshot_ct()
    for r, p in ((r4, p4), (r6, p6)):
        assert sorted(r) == sorted(p)
        for key in r:
            np.testing.assert_array_equal(np.asarray(p[key]),
                                          np.asarray(r[key]), err_msg=key)


def counters_by_global_slot(plane):
    """{(global endpoint slot, entry slot): (packets, bytes)} of every
    nonzero per-entry counter."""
    out = {}
    n = plane.n_shards
    for k, eng in enumerate(plane.shards):
        pk = np.asarray(eng.counters.packets)
        by = np.asarray(eng.counters.bytes)
        slots = pk.shape[0] // max(1, len(_STATES[k::n]))
        for i in np.flatnonzero(pk).tolist():
            out[((i // slots) * n + k, i % slots)] = (int(pk[i]),
                                                      int(by[i]))
    return out


def flow_key(row):
    return tuple(sorted(row.items()))


# ---------------------------------------------------------------- geometry

def test_geometry_and_shard_placement(planes):
    ref, port = planes
    assert port.geometry() == ref.geometry() == {
        "dp": 2, "ep": 4, "devices": 8, "shards": 4}
    for k, eng in enumerate(port.shards):
        assert eng.shard_index == k
        assert eng._serving_lane_name == f"verdict-s{k}"
        assert eng._tables.datapath.key_id.device.type == "cpu"
        assert eng.ct.state.device.type == "cpu"


def test_set_mesh_placement_moves_every_table():
    """An engine placed on a column whose first device is not its own
    moves its CT, counters, flow and analytics state and rebuilds its
    tables there (the LB registry's included); its lane takes the shard's
    name, as the reference's does.  ``meta`` stands in for a second
    device."""
    from cilium_tpu.parallel.mesh import ep_submesh as ref_ep_submesh
    from cilium_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from cilium_tpu_torch.parallel.mesh import ep_submesh
    dp = Datapath(ct_slots=1 << 8, device="cpu")
    dp.enable_flow_aggregation(slots=1 << 6)
    dp.enable_analytics(width=1 << 6)
    dp.load_policy(_STATES[:4], revision=1, ipcache_prefixes=_PREFIXES)
    dp.set_mesh_placement(ep_submesh(make_mesh(devices=["meta"] * 4,
                                               ep_parallel=2), 1), shard=1)
    ref = ref_engine.Datapath(ct_slots=1 << 8)
    ref.set_mesh_placement(ref_ep_submesh(ref_make_mesh(ep_parallel=2), 1),
                           shard=1)
    assert (dp.shard_index, dp._serving_lane_name) == \
        (ref.shard_index, ref._serving_lane_name) == (1, "verdict-s1")
    meta = torch.device("meta")
    tensors = [dp.ct.state, dp.ct6.state, dp._counters,
               dp.analytics_state.state, *dp.flows.state,
               dp._tables.datapath.key_id, dp._tables.lb.svc_key_a,
               dp._tables.pf_masks, dp._tables6.ipcache6.k0]
    assert all(t.device == meta for t in tensors)
    assert dp.device == dp.ct.device == dp.flows.device == meta


# ------------------------------------------------------------ plane parity

@pytest.mark.parametrize("seed", [3, 5])
def test_plane_parity_against_jax(planes, seed):
    """Verdicts, identities, provenance tiers and matched slots per
    shard, every shard's CT fields, counters by global slot and flow
    tables, equal to the JAX plane's after each chunk."""
    ref, port = planes
    rng = np.random.default_rng(seed)
    for n in (96, 40):
        c = chunk(rng, n)
        both(planes, c)
        owner = c["endpoint"] % N_SHARDS
        for k in range(N_SHARDS):
            rows = int((owner == k).sum())
            if not rows:
                continue
            rp, pp = ref.shards[k].last_provenance, \
                port.shards[k].last_provenance
            np.testing.assert_array_equal(
                pp.tier.numpy()[:rows], np.asarray(rp.tier)[:rows])
            np.testing.assert_array_equal(
                pp.match_slot.numpy()[:rows],
                np.asarray(rp.match_slot)[:rows])
        assert_ct_equal(ref, port)
        assert counters_by_global_slot(port) == counters_by_global_slot(ref)
        for k in range(N_SHARDS):
            assert sorted(map(flow_key, port.shard_flow_snapshot(k))) == \
                sorted(map(flow_key, ref.shard_flow_snapshot(k)))
    assert port.ct_entries() == ref.ct_entries()
    assert port.ct_entries()[0] > 0


def test_policy_replay_with_global_slots(planes):
    ref, port = planes
    eps = list(range(N_ENDPOINTS))
    args = (eps, [300 + e for e in eps], [80] * len(eps),
            [6] * len(eps), [1] * len(eps))
    rows, want = port.policy_replay(*args), ref.policy_replay(*args)
    assert rows == want
    assert [r["shard"] for r in rows] == [e % N_SHARDS for e in eps]


def test_inventory_and_pressure(planes):
    ref, port = planes
    inv, want = port.map_inventory(), ref.map_inventory()
    assert set(inv) == set(want)
    for name in ("ct", "ct6", "hubble-flows", "policy", "ipcache"):
        assert inv[name] == want[name], name
    for k in range(N_SHARDS):
        for name in ("ct", "ct6", "hubble-flows"):
            assert inv["shards"][str(k)][name] == \
                want["shards"][str(k)][name]
    pr, pw = port.map_pressure(0.5), ref.map_pressure(0.5)
    assert pr["maps"] == pw["maps"]
    assert pr["warnings"] == pw["warnings"]
    for k in range(N_SHARDS):
        assert pr["shards"][str(k)]["maps"]["ct"] == \
            pw["shards"][str(k)]["maps"]["ct"]
        assert pr["shards"][str(k)]["shard"] == k


def test_pack_stats_keys(planes):
    ref, port = planes
    got, want = port.pack_stats(), ref.pack_stats()
    assert set(got) == set(want)
    assert set(got["per-shard"]) == set(want["per-shard"])
    assert all(got[k] >= 0 for k in ("full-packs", "row-writes",
                                      "leaf-writes"))
    counts = port.shards[0].dispatch_leaf_counts()
    assert set(counts) == set(ref.shards[0].dispatch_leaf_counts())
    assert counts["legacy-step"] > counts["packed-step"]


# ------------------------------------------------- CT across the packages

def test_ct_snapshots_cross_packages(planes):
    """A CT snapshot of either plane restores in a fresh plane of the
    other package, field for field."""
    ref, port = planes
    both(planes, chunk(np.random.default_rng(7), 64))
    fresh_port = ShardedDatapath(n_shards=N_SHARDS, devices=CPU8,
                                 ct_slots=CT_SLOTS)
    fresh_ref = RefSharded(n_shards=N_SHARDS, ct_slots=CT_SLOTS)
    n = fresh_port.restore_ct_snapshots(*ref.snapshot_ct())
    assert n == sum(ref.ct_entries()) > 0
    assert_ct_equal(ref, fresh_port)
    assert fresh_ref.restore_ct_snapshots(*port.snapshot_ct()) == n
    assert_ct_equal(fresh_ref, port)
    # a snapshot of another shard count is refused whole
    v4, v6 = port.snapshot_ct()
    bad = dict(v4)
    bad["shards"] = np.array([N_SHARDS + 1], np.int64)
    with pytest.raises(ValueError):
        fresh_port.restore_ct_snapshots(bad, v6)


# ------------------------------------------------------ shard-kill journey

@pytest.fixture(scope="module")
def oracle():
    """The port's single engine over the same states, flows and
    provenance on."""
    dp = Datapath(ct_slots=CT_SLOTS, device="cpu")
    dp.telemetry_enabled = False
    dp.enable_flow_aggregation(slots=FLOW_SLOTS)
    dp.enable_provenance()
    dp.load_policy(_STATES, revision=1, ipcache_prefixes=_PREFIXES)
    return dp


def single(oracle, c):
    v, _e, i, _n = oracle.process(make_full_batch(**c, device="cpu"),
                                  now=T0)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("seed,victim", [(11, 1), (13, 2)])
def test_shard_kill_journey(planes, oracle, seed, victim):
    """A fatal fault on one shard: the siblings stay bit-exact against
    the single engine with their breakers closed, the victim serves
    fail-static with its established flows kept, and gated recovery on
    the victim alone closes its breaker."""
    _ref, plane = planes
    rng = np.random.default_rng(seed)
    lane = plane.serving()
    sup = lane.lanes[victim].supervisor

    c1 = chunk(rng, 64)
    t = lane.submit_records(cp(c1), 64)
    v1, _i1 = t.result(timeout=120)
    assert t.error is None
    sup.oracle.refresh()
    np.testing.assert_array_equal(v1, single(oracle, c1)[0])

    rec_before = DATAPLANE_RECOVERIES.total()
    faults_before = DATAPLANE_SHARD_FAULTS.value(
        labels={"shard": str(victim), "kind": "fatal"})
    inj = DeviceFaultInjector()
    sup.install_fault_hook(inj)
    assert inj.shard == victim
    inj.fail_launch(times=1, fatal=True)

    kill = chunk(rng, 16)
    kill["endpoint"] = np.full(16, victim, np.int32)
    t = lane.submit_records(cp(kill), 16)
    t.result(timeout=120)
    assert t.error is None                 # fail-static, not denied
    st = plane.supervision_status()
    assert st["mode"] == "degraded"
    assert st["degraded-shards"] == [victim]
    assert DATAPLANE_SHARD_MODE.value(labels={"shard": str(victim)}) == 1.0
    assert DATAPLANE_SHARD_FAULTS.value(
        labels={"shard": str(victim), "kind": "fatal"}) == faults_before + 1

    sibling_batches = {k: lane.lanes[k].batches
                       for k in range(N_SHARDS) if k != victim}
    fresh = chunk(rng, 96)
    t = lane.submit_records(cp(fresh), 96)
    v2, i2 = t.result(timeout=120)
    assert t.error is None
    dv2, di2 = single(oracle, fresh)
    mask = (fresh["endpoint"] % N_SHARDS) != victim
    np.testing.assert_array_equal(v2[mask], dv2[mask])
    np.testing.assert_array_equal(i2[mask], di2[mask])
    # the victim's new flows: the fail-static oracle policy answers
    # as the device would
    np.testing.assert_array_equal(v2[~mask], dv2[~mask])
    for k, before in sibling_batches.items():
        assert lane.lanes[k].supervisor.breaker.state == "closed"
        assert lane.lanes[k].batches > before

    # established flows on the victim keep their verdicts
    t = lane.submit_records(cp(c1), 64)
    vs, _ = t.result(timeout=120)
    assert t.error is None
    vmask = (c1["endpoint"] % N_SHARDS) == victim
    allowed = vmask & (v1 >= 0)
    if allowed.any():
        np.testing.assert_array_equal(vs[allowed],
                                      np.maximum(v1[allowed], 0))
    assert sup.fail_static_records > 0

    inj.heal()
    deadline = time.monotonic() + 20.0
    while sup.mode != "ok" and time.monotonic() < deadline:
        time.sleep(0.05)
        lane.submit_records(cp(kill), 16).result(timeout=120)
    assert sup.mode == "ok"
    assert DATAPLANE_RECOVERIES.total() > rec_before
    assert plane.supervision_status()["mode"] == "ok"
    assert DATAPLANE_SHARD_MODE.value(labels={"shard": str(victim)}) == 0.0


def test_gc_counts_against_jax(planes):
    """Run last on the shared planes: a far-future sweep empties every
    shard's CT, with the JAX plane's count."""
    ref, port = planes
    rng = np.random.default_rng(17)
    both(planes, chunk(rng, 64))
    assert port.gc(now=T0 - 1) == ref.gc(now=T0 - 1) == 0
    before = port.ct_entries()
    swept = port.gc(now=(1 << 31) - 1)
    assert swept >= before[0] > 0
    assert ref.gc(now=(1 << 31) - 1) >= ref.ct_entries()[0]
    assert port.ct_entries() == (0, 0)


# ------------------------------------------------- sharded table manager

def _state(dport):
    st = PolicyMapState()
    st[PolicyKey(identity=300, dest_port=dport, nexthdr=6,
                 direction=INGRESS)] = PolicyMapStateEntry()
    return st


def test_sharded_table_manager_against_jax():
    """Interleaved global slots as in the reference, and a sync writes
    only the owning shard's tensors."""
    mgr = ShardedTableManager(N_SHARDS, devices=CPU8[:N_SHARDS])
    ref = RefTableManager(N_SHARDS)
    slots = {eid: mgr.attach(eid) for eid in range(8)}
    assert slots == {eid: ref.attach(eid) for eid in range(8)}
    for eid, g in slots.items():
        assert g % N_SHARDS == eid % N_SHARDS
        assert mgr.slot_of(eid) == g
    owner = mgr.shard_of_endpoint(5)
    before = {k: (m.generation, m.key_id.clone())
              for k, m in enumerate(mgr.shards)}
    out = mgr.sync_endpoint(5, _state(443), revision=2)
    assert out["shard"] == owner == 5 % N_SHARDS
    for k, m in enumerate(mgr.shards):
        gen, kid = before[k]
        if k != owner:
            assert m.generation == gen
            assert torch.equal(m.key_id, kid)
    assert not torch.equal(mgr.shards[owner].key_id, before[owner][1])
    assert mgr.states_by_slot()[slots[5]].keys() == _state(443).keys()


def test_sharded_manager_drives_plane_refresh():
    mgr = ShardedTableManager(N_SHARDS, devices=CPU8[:N_SHARDS])
    p = ShardedDatapath(n_shards=N_SHARDS, devices=CPU8[:N_SHARDS],
                        ct_slots=1 << 8)
    p.telemetry_enabled = False
    p.use_table_manager(mgr, ipcache_prefixes={"10.0.0.0/8": 300})
    g = mgr.attach(6)
    mgr.sync_endpoint(6, _state(5432), revision=3)
    p.refresh_policy(3)
    assert p.revision == 3
    row = p.policy_replay([g], [300], [5432], [6], [0])[0]
    assert row["verdict"] == 0 and row["shard"] == g % N_SHARDS
    assert p.policy_replay([g], [999999], [5432], [6], [0])[0]["verdict"] < 0
    assert p.pack_stats()["row-writes"] >= 1


def test_shared_lb_compiles_on_each_shard_device(monkeypatch):
    """The shards share one service registry, which compiles on shard
    0's device; a shard on another device takes the compiled tables
    onto its own, once per compiled generation.  (Here every shard is on
    the CPU, so "another device" is simulated.)"""
    from cilium_tpu_torch.datapath.lb import Backend, Service
    p = ShardedDatapath(n_shards=2, devices=["cpu", "cpu"], ct_slots=1 << 8)
    p.telemetry_enabled = False
    assert all(sh.lb is p.lb for sh in p.shards)
    p.lb.upsert_service(Service(vip=(10 << 24) | 9, port=80, backends=[
        Backend(addr=(10 << 24) | 10, port=8080)]))
    monkeypatch.setattr(engine, "same_device", lambda a, b: False)
    p.load_policy(_STATES[:2], revision=1, ipcache_prefixes=_PREFIXES)
    compiled = p.lb.compiled
    for sh in p.shards:
        # each shard's tables are its own copy of this generation
        assert sh._lb_here[0] is compiled
        assert sh._tables.lb is sh._lb_here[1]
        for a, b in zip(sh._tables.lb, compiled.tables):
            assert torch.equal(a, b) and a.device == sh.device
    copies = [sh._lb_here[1] for sh in p.shards]
    p.reload_prefilter()                       # a rebuild, same registry
    assert [sh._tables.lb for sh in p.shards] == copies
    p.lb.upsert_service(Service(vip=(10 << 24) | 11, port=80, backends=[
        Backend(addr=(10 << 24) | 12, port=8080)]))
    p.reload_services()                        # a new compiled generation
    for sh in p.shards:
        assert sh._lb_here[0] is p.lb.compiled
        assert int((sh._tables.lb.svc_count > 0).sum()) == 2


def test_supervision_off_lanes_carry_no_supervisor():
    p = ShardedDatapath(n_shards=2, devices=["cpu", "cpu"], ct_slots=1 << 8)
    p.telemetry_enabled = False
    p.configure_supervision(enabled=False)
    p.load_policy(_STATES[:4], revision=1, ipcache_prefixes=_PREFIXES)
    lane = p.serving()
    try:
        assert all(sv is None for sv in lane.supervisors)
        assert p.supervision_status()["supervised"] is False
    finally:
        lane.close()


# --------------------------------------------------------- sharded agent

def _agent_config(cls, state_dir: str = ""):
    return cls(state_dir=state_dir, drift_audit_interval_s=0,
               ct_checkpoint_interval_s=0, supervisor_reset_s=0.05,
               supervisor_watchdog_s=5.0, supervisor_failure_threshold=2,
               dataplane_shards=4)


def _records(slot, n, dport, sport0):
    web_ip = (10 << 24) | (200 << 16) | 10
    db_ip = (10 << 24) | (200 << 16) | 11
    return {"endpoint": np.full(n, slot, np.int32),
            "saddr": np.full(n, web_ip, np.uint32).view(np.int32),
            "daddr": np.full(n, db_ip, np.uint32).view(np.int32),
            "sport": (sport0 + np.arange(n)).astype(np.int32),
            "dport": np.full(n, dport, np.int32),
            "proto": np.full(n, 6, np.int32),
            "direction": np.zeros(n, np.int32),
            "tcp_flags": np.full(n, 0x02, np.int32),
            "is_fragment": np.zeros(n, np.int32),
            "length": np.full(n, 256, np.int32)}


_DB_RULES = json.dumps([{
    "endpointSelector": {"matchLabels": {"id": "db"}},
    "ingress": [{"fromEndpoints": [{"matchLabels": {"id": "web"}}],
                 "toPorts": [{"ports": [{"port": "5432",
                                         "protocol": "TCP"}]}]}],
    "labels": ["k8s:policy=t"]}])


def test_sharded_agent_journey_status_names_shard():
    """A live agent with ``dataplane_shards=4`` on the CPU: rows land on
    the owning shard, a shard fault degrades exactly that shard and the
    status names it, and gated recovery (the full drift audit over
    global slots) restores ok."""
    d = Daemon(config=_agent_config(DaemonConfig), device="cpu")
    try:
        d.endpoint_create(1, ipv4="10.200.0.10", labels=["k8s:id=web"])
        d.endpoint_create(2, ipv4="10.200.0.11", labels=["k8s:id=db"])
        rev = d.policy_add(rules_from_json(_DB_RULES))
        assert d.wait_for_policy_revision(rev, timeout=WAIT_S)
        st = d.status()["dataplane"]
        assert st["status"] == "ok"
        assert st["geometry"]["ep"] == 4

        slot = d.endpoints.lookup(2).table_slot
        victim = slot % 4
        # the endpoint's rows live on its shard's slice only
        for k, mgr in enumerate(d.table_mgr.shards):
            assert mgr.slot_of(2) == (slot // 4 if k == victim else None)
        assert d.table_mgr.states_by_slot()[slot]
        lane = d.datapath.serving()
        sup = lane.lanes[victim].supervisor
        allowed = _records(slot, 8, 5432, 40000)
        t = lane.submit_records(cp(allowed), 8)
        v, _i = t.result(timeout=120)
        assert t.error is None and (v == 0).all()
        sup.oracle.refresh()

        rec_before = DATAPLANE_RECOVERIES.total()
        inj = DeviceFaultInjector()
        sup.install_fault_hook(inj)
        inj.fail_launch(times=2)
        for _ in range(2):
            lane.submit_records(cp(allowed), 8).result(timeout=120)
        st = d.status()["dataplane"]
        assert st["mode"] == "degraded"
        assert st["degraded-shards"] == [victim]
        assert f"shard(s) [{victim}]" in st["status"]

        t = lane.submit_records(cp(allowed), 8)
        vs, _ = t.result(timeout=120)
        assert t.error is None and (vs == 0).all()
        t = lane.submit_records(_records(slot, 8, 80, 41000), 8)
        vd, _ = t.result(timeout=120)
        assert t.error is None and (vd < 0).all()

        inj.heal()
        time.sleep(0.1)
        t = lane.submit_records(cp(allowed), 8)
        v2, _ = t.result(timeout=120)
        assert t.error is None and (v2 == 0).all()
        assert sup.mode == "ok"
        assert DATAPLANE_RECOVERIES.total() > rec_before
        st = d.status()["dataplane"]
        assert st["mode"] == "ok" and st["status"] == "ok"
        assert d.drift_report()["status"] in ("ok", "idle")
        assert set(d.status()["map-pressure"]["shards"]) == \
            {"0", "1", "2", "3"}
    finally:
        d.shutdown()


def test_jax_sharded_state_dir_restores_in_the_port(tmp_path):
    """A state directory a JAX agent with four shards wrote (endpoint
    checkpoints and the ``s{k}_``-keyed ``ct_state.npz``) restores in
    the port's sharded agent: the same endpoints, the same CT entries,
    and established rows keep their verdicts."""
    st = policy_state(60, 6, 8, 6, seed=8)
    packed, _ = policy_packets(st, policy_remotes(st), 512, seed=9)
    soa = {f: np.ascontiguousarray(packed[i]) for i, f in
           enumerate(PACKED_FIELDS)}
    n = packed.shape[1]
    writer = port = None
    try:
        writer = RefDaemon(config=_agent_config(
            RefDaemonConfig, state_dir=str(tmp_path / "w")))
        for ep_id, ip, labels in st.endpoints:
            writer.endpoint_create(ep_id, ipv4=ip, labels=list(labels))
        from cilium_tpu.ipcache.ipcache import SOURCE_KVSTORE
        from cilium_tpu.labels import Labels as RefLabels
        for ip, labels in st.peers:
            ident, _ = writer.identity_allocator.allocate(
                RefLabels.from_model(list(labels)))
            writer.ipcache.upsert(ip, ident.id, SOURCE_KVSTORE)
        rev = writer.policy_add(ref_rules_from_json(st.rules_json))
        assert writer.wait_for_policy_revision(rev, timeout=WAIT_S)
        deadline = time.monotonic() + WAIT_S
        while writer.datapath.ipcache_prefixes != \
                writer.ipcache.to_lpm_prefix_families()[0] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        v_w, _ = writer.datapath.classify_records(cp(soa), n)
        v_w = np.asarray(v_w)
        entries = writer.datapath.ct_entries()
        assert entries[0] > 0
        assert writer.checkpoint_ct()
        writer.shutdown()
        writer = None
        shutil.copytree(tmp_path / "w", tmp_path / "p")
        port = Daemon(config=_agent_config(
            DaemonConfig, state_dir=str(tmp_path / "p")), device="cpu")
        assert port.restore_endpoints() == len(st.endpoints)
        assert port.datapath.ct_entries() == entries
        assert port.wait_for_quiesce(WAIT_S)
        v_p, _ = port.datapath.classify_records(cp(soa), n)
        # established rows keep the verdicts they had before
        est = v_w >= 0
        np.testing.assert_array_equal(np.maximum(v_p[est], 0),
                                      np.maximum(v_w[est], 0))
    finally:
        for d in (writer, port):
            if d is not None:
                d.shutdown()
