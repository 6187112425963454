"""The single-node agent: the JAX package's ``Daemon`` vs the port's.

The same agent is built in both packages from one seeded rule set
(``workloads.policy_state`` at a small size): endpoints created through
``endpoint_create``, remote workloads entered as the kvstore watchers
enter them (an identity from the allocator and an ipcache entry from the
kvstore source), the rules imported as JSON.  The port's daemon runs on
the CPU (``device="cpu"``).  Everything is compared at tolerance 0:
endpoint states, identities, realized map states, verdicts, CT entries,
counters, the map surface, the drift audit, the policy trace and the
restore of a state directory the JAX daemon wrote.  Proxy ports follow
the builder threads' order, so the reference's are renamed to the port's
by redirect id.  Packets carry the current time, so the ``ct-gc``
controller (wall clock, every 5 s) keeps every entry they create.
"""

import json
import os
import shutil
import socket
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu import migrate as ref_migrate
from cilium_tpu.daemon import Daemon as RefDaemon
from cilium_tpu.endpoint import Endpoint as RefEndpoint
from cilium_tpu.ipcache.ipcache import SOURCE_KVSTORE as REF_SOURCE_KVSTORE
from cilium_tpu.labels import LabelArray as RefLabelArray
from cilium_tpu.labels import Labels as RefLabels
from cilium_tpu.policy.jsonio import rules_from_json as ref_rules_from_json
from cilium_tpu.utils.option import DaemonConfig as RefDaemonConfig

from cilium_tpu_torch import migrate
from cilium_tpu_torch.daemon import Daemon
from cilium_tpu_torch.datapath.pipeline import PACKED_FIELDS
from cilium_tpu_torch.endpoint.endpoint import Endpoint
from cilium_tpu_torch.ipcache.ipcache import SOURCE_KVSTORE
from cilium_tpu_torch.labels import LabelArray, Labels
from cilium_tpu_torch.policy.jsonio import rules_from_json
from cilium_tpu_torch.utils.option import DaemonConfig
from cilium_tpu_torch.workloads import (policy_packets, policy_remotes,
                                        policy_state)

WAIT_S = 60.0

REF = dict(Daemon=RefDaemon, DaemonConfig=RefDaemonConfig,
           Labels=RefLabels, LabelArray=RefLabelArray,
           SOURCE_KVSTORE=REF_SOURCE_KVSTORE,
           rules_from_json=ref_rules_from_json,
           Endpoint=RefEndpoint, migrate=ref_migrate,
           tensor=jnp.asarray)
PORT = dict(Daemon=Daemon, DaemonConfig=DaemonConfig, Labels=Labels,
            LabelArray=LabelArray, SOURCE_KVSTORE=SOURCE_KVSTORE,
            rules_from_json=rules_from_json, Endpoint=Endpoint,
            migrate=migrate, tensor=torch.as_tensor)


def small_state():
    """A few endpoints and peers, tens of rules (HTTP redirects,
    CIDRs and one ``fromRequires`` among them)."""
    return policy_state(120, 6, 8, 6, seed=8)


def start_agent(pkg, state_dir: str, **config):
    cfg = pkg["DaemonConfig"](state_dir=state_dir, **config)
    if pkg is PORT:
        return Daemon(config=cfg, device="cpu")
    return RefDaemon(config=cfg)


def add_peer(pkg, d, ip: str, labels):
    """A remote workload as the kvstore watchers enter it."""
    ident, _ = d.identity_allocator.allocate(
        pkg["Labels"].from_model(list(labels)))
    d.ipcache.upsert(ip, ident.id, pkg["SOURCE_KVSTORE"])
    return ident


def populate(pkg, d, st) -> int:
    for ep_id, ip, labels in st.endpoints:
        d.endpoint_create(ep_id, ipv4=ip, labels=list(labels))
    for ip, labels in st.peers:
        add_peer(pkg, d, ip, labels)
    return d.policy_add(pkg["rules_from_json"](st.rules_json))


def settle(d, revision=None) -> bool:
    """Every endpoint at the revision, the build queue idle, and the
    engine's LPM holding the ipcache's prefixes (the reload trigger is
    asynchronous)."""
    if not d.wait_for_policy_revision(revision, timeout=WAIT_S):
        return False
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if d.datapath.ipcache_prefixes == \
                d.ipcache.to_lpm_prefix_families()[0]:
            return True
        time.sleep(0.01)
    return False


def redirect_renames(ref, port):
    """{reference proxy port: the port's proxy port} by redirect id."""
    ports = {r.id: r.proxy_port for r in port.proxy.redirects()}
    assert sorted(ports) == sorted(r.id for r in ref.proxy.redirects())
    return {r.proxy_port: ports[r.id] for r in ref.proxy.redirects()}


def _key(k):
    return (k.identity, k.dest_port, k.nexthdr, k.direction)


def realized(d, rename=None):
    rename = rename or {}
    return {ep.id: {_key(k): rename.get(v.proxy_port, v.proxy_port)
                    for k, v in ep.realized.items()}
            for ep in d.endpoints.endpoints()}


def endpoint_models(d):
    return sorted((ep.id, ep.ipv4, ep.state, ep.policy_revision,
                   ep.security_identity,
                   tuple(str(l) for l in ep.labels.to_array()))
                  for ep in d.endpoints.endpoints())


def rename_verdicts(v: np.ndarray, rename) -> np.ndarray:
    return np.array([rename.get(int(x), int(x)) if x > 0 else int(x)
                     for x in v], np.int32)


def ct_dump(d, name="ct", rename=None):
    rename = rename or {}
    return sorted(tuple(sorted({**e, "proxy-port": rename.get(
        e["proxy-port"], e["proxy-port"])}.items()))
        for e in d.datapath.map_dump(name, max_entries=1 << 20))


def run_batch(pkg, d, packed: np.ndarray, now: int):
    out = d.datapath.process_packed(pkg["tensor"](packed), now=now)
    return [np.asarray(o) for o in out]


def shutdown_all(*agents):
    for d in agents:
        if d is not None:
            d.shutdown()


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    """(state, reference daemon, port daemon), both populated and
    settled; the module's tests run in order against the pair."""
    st = small_state()
    base = tmp_path_factory.mktemp("agents")
    ref = port = None
    try:
        ref = start_agent(REF, str(base / "ref"))
        port = start_agent(PORT, str(base / "port"))
        revs = [populate(pkg, d, st) for pkg, d in ((REF, ref),
                                                    (PORT, port))]
        assert revs[0] == revs[1]
        assert settle(ref) and settle(port)
        yield st, ref, port
    finally:
        shutdown_all(ref, port)


# ------------------------------------------------------------- rules to maps

def test_endpoints_identities_and_map_states_match(agents):
    st, ref, port = agents
    assert endpoint_models(port) == endpoint_models(ref)
    assert {m[2] for m in endpoint_models(port)} == {"ready"}
    assert port.identity_list() == ref.identity_list()
    rename = redirect_renames(ref, port)
    assert rename, "the rule set has HTTP redirects"
    assert realized(port) == realized(ref, rename)
    assert port.policy_get() == ref.policy_get()
    assert port.ipcache.to_lpm_prefix_families() == \
        ref.ipcache.to_lpm_prefix_families()
    assert len(port.proxy) == len(ref.proxy)


def test_status_keys_and_values_match(agents):
    _st, ref, port = agents
    s_ref, s_port = ref.status(), port.status()
    assert sorted(s_port) == sorted(s_ref)
    for key in ("kvstore", "policy", "endpoints", "identities", "ipcache",
                "nodes", "proxy", "clustermesh", "datapath",
                "controller-health", "threat", "analytics"):
        assert s_port[key] == s_ref[key], key
    assert sorted(c["name"] for c in s_port["controllers"]) == \
        sorted(c["name"] for c in s_ref["controllers"]) == \
        ["ct-checkpoint", "ct-gc", "policy-drift-audit"]
    assert s_port["dataplane"]["status"] == s_ref["dataplane"]["status"]
    assert sorted(s_port["map-pressure"]["maps"]) == \
        sorted(s_ref["map-pressure"]["maps"])
    assert s_port["features"]["native_fastpath"] is True


def test_verdicts_ct_counters_and_maps_match(agents):
    st, ref, port = agents
    rename = redirect_renames(ref, port)
    packed, _ = policy_packets(st, policy_remotes(st), 4096, seed=3)
    now = int(time.time())
    v_r, ev_r, id_r, n_r = run_batch(REF, ref, packed, now)
    v_p, ev_p, id_p, n_p = run_batch(PORT, port, packed, now)
    np.testing.assert_array_equal(v_p, rename_verdicts(v_r, rename))
    np.testing.assert_array_equal(ev_p, ev_r)
    np.testing.assert_array_equal(id_p, id_r)
    np.testing.assert_array_equal(n_p, n_r)
    assert (v_p > 0).any() and (v_p == 0).any() and (v_p < 0).any()
    assert ct_dump(port) == ct_dump(ref, rename=rename)
    assert len(ct_dump(port)) > 0
    c_r, c_p = ref.datapath.counters, port.datapath.counters
    np.testing.assert_array_equal(np.asarray(c_p.packets),
                                  np.asarray(c_r.packets))
    np.testing.assert_array_equal(np.asarray(c_p.bytes),
                                  np.asarray(c_r.bytes))
    assert port.datapath.map_inventory() == ref.datapath.map_inventory()
    for name in ("ipcache", "ipcache6", "tunnel", "lb", "lb6",
                 "prefilter"):
        assert port.datapath.map_dump(name) == \
            ref.datapath.map_dump(name), name
    with pytest.raises(KeyError):
        port.datapath.map_dump("nonsense")
    # the established rows keep their verdicts on a second pass
    v2_r, *_ = run_batch(REF, ref, packed, now)
    v2_p, *_ = run_batch(PORT, port, packed, now)
    np.testing.assert_array_equal(v2_p, v_p)
    np.testing.assert_array_equal(v2_p, rename_verdicts(v2_r, rename))
    assert port.datapath.flow_stats() == ref.datapath.flow_stats()


def test_drift_audit_and_trace_replay_match(agents):
    st, ref, port = agents
    a_r, a_p = ref.run_drift_audit(), port.run_drift_audit()
    assert a_p["status"] == a_r["status"] == "ok"
    assert a_p["divergences"] == a_r["divergences"] == []
    assert a_p["checked"] > 0 and a_p["endpoints"] == a_r["endpoints"]
    rename = redirect_renames(ref, port)
    ep_id = st.endpoints[0][0]
    ident = port.endpoints.lookup(st.endpoints[1][0]).security_identity
    for dport, direction in ((0, "ingress"), (80, "egress"),
                             (53, "ingress")):
        t_r = ref.policy_trace_replay(ep_id, identity=ident, dport=dport,
                                      direction=direction)
        t_p = port.policy_trace_replay(ep_id, identity=ident, dport=dport,
                                       direction=direction)
        assert t_p["drift"] is t_r["drift"] is False
        dev_r, dev_p = t_r["device"], t_p["device"]
        assert dev_p["tier"] == dev_r["tier"]
        assert dev_p["verdict"] == rename.get(dev_r["verdict"],
                                              dev_r["verdict"])
    with pytest.raises(KeyError):
        port.policy_trace_replay(999999, identity=ident)


def test_policy_resolve_matches(agents):
    _st, ref, port = agents
    for frm, to, ports in ((["k8s:app=a0"], ["k8s:app=a1"], [80]),
                           (["k8s:tier=t0"], ["k8s:app=a2"], []),
                           (["reserved:world"], ["k8s:tier=t1"], [443])):
        r_ref = ref.policy_resolve(RefLabelArray.parse_select(*frm),
                                   RefLabelArray.parse_select(*to),
                                   dports=ports, verbose=True)
        r_port = port.policy_resolve(LabelArray.parse_select(*frm),
                                     LabelArray.parse_select(*to),
                                     dports=ports, verbose=True)
        assert r_port == r_ref


def test_host_fastpath_matches_device(agents):
    """``HostVerdictPath`` (the C++ verdict caches) against the device
    tables of the same daemon, and against the reference's caches."""
    st, ref, port = agents
    rename = redirect_renames(ref, port)
    assert port.host_path is not None and ref.host_path is not None
    rng = np.random.default_rng(3)
    idents = [i["id"] for i in port.identity_list()]
    for ep in port.endpoints.endpoints():
        n = 64
        ids = rng.choice(idents, n).astype(np.uint32)
        dports = rng.choice([0, 53, 80, 443, 8080], n).astype(np.int32)
        protos = rng.choice([6, 17], n).astype(np.int32)
        dirs = rng.integers(0, 2, n).astype(np.int32)
        host = port.host_path.classify(ep.id, ids, dports, protos, dirs)
        rows = port.datapath.policy_replay([ep.table_slot] * n, ids,
                                           dports, protos, dirs)
        np.testing.assert_array_equal(host, [r["verdict"] for r in rows])
        ref_host = ref.host_path.classify(ep.id, ids, dports, protos, dirs)
        np.testing.assert_array_equal(host,
                                      rename_verdicts(ref_host, rename))


# ------------------------------------------------------ services, prefilter

def test_services_and_prefilter_match(agents):
    _st, ref, port = agents
    for d in (ref, port):
        d.service_upsert("10.96.0.10", 53, [("10.128.0.2", 5353),
                                            ("10.128.0.3", 5353)], proto=17)
        d.service_upsert("10.96.0.11", 80, [("10.128.0.4", 8080)])
        d.service_upsert("fd00::10", 443, [("fd00::2", 8443)])
        d.prefilter_update(["192.0.2.0/24", "2001:db8::/64"])
    for name in ("lb", "lb6", "prefilter"):
        assert port.datapath.map_dump(name) == \
            ref.datapath.map_dump(name), name
    for sid in (1, 2, 1_000_001, 77):
        s_r, s_p = ref.service_find_by_id(sid), port.service_find_by_id(sid)
        assert (s_p is None) == (s_r is None)
        if s_p is not None:
            assert (s_p.port, s_p.proto, s_p.rev_nat_index) == \
                (s_r.port, s_r.proto, s_r.rev_nat_index)
    for d in (ref, port):
        assert d.service_delete_by_id(2)
        assert not d.service_delete_by_id(2)
        assert d.service_delete("fd00::10", 443)
        d.prefilter_delete(["192.0.2.0/24"])
    assert port.datapath.map_inventory() == ref.datapath.map_inventory()
    assert port.datapath.map_dump("prefilter") == \
        ref.datapath.map_dump("prefilter")


# --------------------------------------------------- endpoint and policy churn

def test_endpoint_labels_and_delete_match(agents):
    st, ref, port = agents
    ep_id = st.endpoints[2][0]
    for d in (ref, port):
        assert d.endpoint_update_labels(ep_id, ["k8s:app=a3",
                                                "k8s:tier=t2"])
        assert not d.endpoint_update_labels(ep_id, ["k8s:app=a3",
                                                    "k8s:tier=t2"])
        with pytest.raises(KeyError):
            d.endpoint_update_labels(424242, ["k8s:app=x"])
    assert settle(ref) and settle(port)
    assert endpoint_models(port) == endpoint_models(ref)
    assert realized(port) == realized(ref, redirect_renames(ref, port))
    gone = st.endpoints[3][0]
    for d in (ref, port):
        assert d.endpoint_delete(gone)
        assert not d.endpoint_delete(gone)
    assert settle(ref) and settle(port)
    assert endpoint_models(port) == endpoint_models(ref)
    assert port.identity_list() == ref.identity_list()
    def checkpoints(d):
        return sorted(f for f in os.listdir(d.config.state_dir)
                      if f.startswith("ep_"))
    assert checkpoints(port) == checkpoints(ref)
    assert f"ep_{gone}.json" not in checkpoints(port)


def test_policy_delete_matches(agents):
    _st, ref, port = agents
    out = [d.policy_delete(pkg["LabelArray"].parse("k8s:rule=r1",
                                                   "k8s:rule=r2"))
           for pkg, d in ((REF, ref), (PORT, port))]
    assert out[0] == out[1]
    assert settle(ref) and settle(port)
    out = [d.policy_delete(pkg["LabelArray"].parse("k8s:rule=r3"))
           for pkg, d in ((REF, ref), (PORT, port))]
    assert out[0] == out[1] and out[0][1] == 1
    assert settle(ref) and settle(port)
    assert port.policy_get() == ref.policy_get()
    assert realized(port) == realized(ref, redirect_renames(ref, port))
    assert port.ipcache.to_lpm_prefix_families() == \
        ref.ipcache.to_lpm_prefix_families()


def test_config_patch_regenerates_to_the_same_states(agents):
    """``config_patch`` regenerates without a revision bump, so the wait
    is on the regeneration itself: the realized states."""
    _st, ref, port = agents
    n = [d.config_patch({"Policy": "false"}) for d in (ref, port)]
    assert n[0] == n[1] >= 1

    def unenforced(d) -> bool:
        return d.wait_for_quiesce(0.05) and all(
            ep.state == "ready" and
            not ep.policy_config(d.config.always_allow_localhost())
            .ingress_enforcement for ep in d.endpoints.endpoints())

    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and not (unenforced(ref) and
                                               unenforced(port)):
        time.sleep(0.02)
    time.sleep(0.1)
    assert ref.wait_for_quiesce(WAIT_S) and port.wait_for_quiesce(WAIT_S)
    assert realized(port) == realized(ref, redirect_renames(ref, port))
    assert port.config.opts.dump() == ref.config.opts.dump()


# -------------------------------------------------------------- state restore

def test_jax_state_dir_restores_in_the_port(tmp_path):
    """A state directory the JAX daemon wrote (endpoint checkpoints and
    ``ct_state.npz``) restores in the port's daemon as it restores in a
    fresh JAX daemon: the same endpoints in the same states, the same
    realized map states, the same CT entries, and established rows keep
    their verdicts."""
    st = small_state()
    packed, _ = policy_packets(st, policy_remotes(st), 1024, seed=9)
    now = int(time.time())
    writer = ref2 = port = None
    try:
        writer = start_agent(REF, str(tmp_path / "w"))
        populate(REF, writer, st)
        assert settle(writer)
        v_w, *_ = run_batch(REF, writer, packed, now)
        ct_entries = writer.datapath.ct_entries()
        assert ct_entries[0] > 0
        writer.shutdown()
        writer = None
        shutil.copytree(tmp_path / "w", tmp_path / "p")
        # the reference's ct-checkpoint controller writes the empty
        # table as it starts, racing its own restore: off for the
        # reference here; the port's skips that first run
        ref2 = start_agent(REF, str(tmp_path / "w"),
                           ct_checkpoint_interval_s=0)
        port = start_agent(PORT, str(tmp_path / "p"))
        n = [ref2.restore_endpoints(), port.restore_endpoints()]
        assert n == [len(st.endpoints)] * 2
        assert port.datapath.ct_entries() == ref2.datapath.ct_entries() \
            == ct_entries
        assert ref2.wait_for_quiesce(WAIT_S) and \
            port.wait_for_quiesce(WAIT_S)
        assert endpoint_models(port) == endpoint_models(ref2)
        assert realized(port) == realized(ref2)
        assert ct_dump(port) == ct_dump(ref2)
        # the restored realized states hold no redirect (scrubbed)
        assert all(v == 0 for s in realized(port).values()
                   for v in s.values())
        v_p, ev_p, *_ = run_batch(PORT, port, packed, now + 1)
        v_r, ev_r, *_ = run_batch(REF, ref2, packed, now + 1)
        np.testing.assert_array_equal(v_p, v_r)
        np.testing.assert_array_equal(ev_p, ev_r)
        # established rows keep the verdicts they had before the restart
        np.testing.assert_array_equal(v_p, v_w)
        assert port.run_drift_audit()["divergences"] == []
    finally:
        shutdown_all(writer, ref2, port)


def test_port_checkpoints_are_byte_compatible(tmp_path):
    """An endpoint checkpoint and the CT checkpoint the port writes are
    the reference's, byte for byte (JSON) and field for field (npz)."""
    st = small_state()
    ref = port = None
    try:
        # the reference's controller and this explicit checkpoint share
        # one tmp name unserialized (ROADMAP.md section 3): off for the
        # reference; the port's serializes them
        ref = start_agent(REF, str(tmp_path / "r"),
                          ct_checkpoint_interval_s=0)
        port = start_agent(PORT, str(tmp_path / "p"))
        for pkg, d in ((REF, ref), (PORT, port)):
            populate(pkg, d, st)
        assert settle(ref) and settle(port)
        rename = redirect_renames(ref, port)
        for ep_id, _ip, _l in st.endpoints:
            snap_r = ref.endpoints.lookup(ep_id).checkpoint()
            snap_p = port.endpoints.lookup(ep_id).checkpoint()
            for e in snap_r["realized"]:
                e["proxy_port"] = rename.get(e["proxy_port"],
                                             e["proxy_port"])
            assert json.dumps(snap_p, sort_keys=True) == \
                json.dumps(snap_r, sort_keys=True)
        packed, _ = policy_packets(st, policy_remotes(st), 512, seed=2)
        now = int(time.time())
        for pkg, d in ((REF, ref), (PORT, port)):
            run_batch(pkg, d, packed, now)
            assert d.checkpoint_ct()
        with np.load(tmp_path / "r" / "ct_state.npz") as z_r, \
                np.load(tmp_path / "p" / "ct_state.npz") as z_p:
            assert sorted(z_p.files) == sorted(z_r.files)
            for f in z_r.files:
                a_r, a_p = z_r[f], z_p[f]
                if f.endswith("proxy_port"):
                    a_r = np.array([rename.get(int(x), int(x))
                                    for x in a_r], a_r.dtype)
                np.testing.assert_array_equal(a_p, a_r, err_msg=f)
    finally:
        shutdown_all(ref, port)


def test_concurrent_ct_checkpoints_all_land(tmp_path):
    """``checkpoint_ct`` from eight threads at once (the controller, an
    operator's call and ``shutdown`` share one tmp name): every write
    lands and the checkpoint restores."""
    d = start_agent(PORT, str(tmp_path / "c"))
    try:
        packed, _ = policy_packets(small_state(), policy_remotes(
            small_state()), 256, seed=4)
        d.endpoint_create(1000, ipv4="10.128.0.2", labels=["k8s:app=a0"])
        run_batch(PORT, d, packed, int(time.time()))
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(d.checkpoint_ct()))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert results == [True] * 8
        assert d.restore_ct() == sum(d.datapath.ct_entries())
    finally:
        d.shutdown()


V0 = {"id": 7, "ipv4": "10.9.0.7", "labels": ["k8s:app=old"],
      "state": "ready", "policy_revision": 3, "identity": 1234,
      "realized": {"1234:80:6:0": 0, "1234:443:6:0": 15001}}
V1 = {"id": 8, "ipv4": "10.9.0.8", "labels": ["k8s:app=mid"],
      "state": "ready", "policy_revision": 4, "identity": 1235,
      "realized": [{"identity": 1235, "dest_port": 53, "nexthdr": 17,
                    "direction": 0, "proxy_port": 0}]}
BAD = [{"version": None, "id": 1},
       {"version": 0, "id": 1, "realized": [1, 2]},
       {"id": 1, "realized": {"1234:80:6:0": None}},
       {"version": ref_migrate.CHECKPOINT_VERSION + 1, "id": 1}]


def _migrated(pkg, snap):
    try:
        return pkg["migrate"].migrate_snapshot(json.loads(json.dumps(snap)))
    except pkg["migrate"].MigrationError as exc:
        return ("MigrationError", type(exc).__name__)


@pytest.mark.parametrize("snap", [V0, V1] + BAD,
                         ids=["v0", "v1", "none-version", "bad-realized",
                              "null-proxy", "newer"])
def test_migrate_snapshot_matches(snap):
    out = _migrated(PORT, snap)
    assert out == _migrated(REF, snap)
    if isinstance(out, dict):
        assert _migrated(PORT, out) == out  # current is a no-op
        ep_p, ep_r = Endpoint.restore(out), RefEndpoint.restore(out)
        assert ep_p.checkpoint() == ep_r.checkpoint()


def test_migrate_state_dir_matches(tmp_path):
    outs = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        d = tmp_path / name
        d.mkdir()
        for fname, snap in (("ep_7.json", V0), ("ep_8.json", V1)):
            (d / fname).write_text(json.dumps(snap))
        cur = ref_migrate.migrate_snapshot(dict(V1))
        cur["id"] = 9
        (d / "ep_9.json").write_text(json.dumps(cur))
        (d / "ep_bad.json").write_text("{not json")
        first = pkg["migrate"].migrate_state_dir(str(d))
        second = pkg["migrate"].migrate_state_dir(str(d))
        files = {f: (d / f).read_text() for f in sorted(os.listdir(d))}
        outs.append((first, second, files))
    assert outs[0] == outs[1]
    assert outs[1][0] == (2, 1, ["ep_bad.json"])


def test_old_state_dir_restores_in_both(tmp_path):
    """A state directory of older checkpoint versions, plus one from a
    newer agent that both skip."""
    models = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        state = tmp_path / name
        state.mkdir()
        (state / "ep_7.json").write_text(json.dumps(V0))
        (state / "ep_8.json").write_text(json.dumps(V1))
        (state / "ep_99.json").write_text(json.dumps({"version": 99,
                                                      "id": 99}))
        d = start_agent(pkg, str(state))
        try:
            assert d.restore_endpoints() == 2
            assert d.endpoints.lookup(99) is None
            assert d.wait_for_policy_revision(timeout=WAIT_S)
            models.append((endpoint_models(d), realized(d)))
        finally:
            d.shutdown()
    assert models[0] == models[1]


# -------------------------------------------------------------- refusals

def test_later_slices_are_refused_by_name(tmp_path):
    """Its name is kept from when it checked the refusals of the
    slices not yet ported; it now checks the opposite: the agent refuses
    nothing, no refusal is left in the daemon, and its xDS server starts
    (once) and stops with the agent.
    The host integrations run (``test_torch_daemon_rest_cli.py``'s
    ``test_agent_refuses_later_slices``)."""
    from cilium_tpu_torch.daemon import daemon as daemon_mod
    for name in ("ITEM_XDS", "ITEM_HOST_INTEGRATIONS", "not_ported"):
        assert not hasattr(daemon_mod, name), name
    d = start_agent(PORT, str(tmp_path / "s"))
    try:
        server = d.serve_xds()
        assert server.port > 0 and d.serve_xds() is server
    finally:
        d.shutdown()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", server.port),
                                 timeout=2).close()


def test_wait_for_regenerations_waits_out_a_trigger_round(tmp_path):
    """``Trigger.wait_idle`` holds until a run ends, and
    ``Daemon.wait_for_regenerations`` until the policy trigger's run and
    the builds it queued are done (an identity change makes no new
    revision for ``wait_for_policy_revision`` to see)."""
    from cilium_tpu_torch.utils.trigger import Trigger
    gate, runs = threading.Event(), []
    t = Trigger(lambda r: (gate.wait(5), runs.append(r)), name="test")
    try:
        assert t.wait_idle(0)
        t.trigger("a")
        assert not t.wait_idle(0.1)
        gate.set()
        assert t.wait_idle(5) and runs == [["a"]]
    finally:
        t.shutdown()
    d = start_agent(PORT, str(tmp_path / "s"))
    try:
        for ep_id in (1, 2):
            d.endpoint_create(ep_id, ipv4=f"10.0.0.{ep_id}",
                              labels=[f"k8s:app=a{ep_id}"])
        assert d.wait_for_regenerations(30)
        build, done = d.endpoints._build_one, []

        def slow(ep_id):
            time.sleep(0.2)
            build(ep_id)
            done.append(ep_id)

        d.endpoints._build_one = slow
        d.trigger_policy_updates("identity-change")
        assert d.wait_for_regenerations(30)
        assert sorted(done) == [1, 2]
    finally:
        d.shutdown()


def test_the_agent_serves_xds(tmp_path):
    """A redirect made through the REST policy import reaches an xDS
    client as an NPDS resource (its proxy port, the endpoint as the
    upstream, the rule's HTTP match), the endpoint's address reaches it
    through NPHDS, and a second import's push completes on the client's
    ACK with the rules of both."""
    from cilium_tpu_torch.daemon.rest import APIServer
    from cilium_tpu_torch.l7.xds_wire import XDSWireClient
    from cilium_tpu_torch.xds import (TYPE_NETWORK_POLICY,
                                      TYPE_NETWORK_POLICY_HOSTS)

    def rest(method, path, body):
        req = urllib.request.Request(
            srv.base_url + path, method=method,
            data=body if isinstance(body, bytes) else
            json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return json.loads(resp.read())

    def rule(name, path):
        return {"endpointSelector": {"matchLabels": {"k8s:app": "web"}},
                "labels": [f"k8s:rule={name}"],
                "ingress": [{"toPorts": [{
                    "ports": [{"port": "8080", "protocol": "TCP"}],
                    "rules": {"http": [{"method": "GET", "path": path}]}}]}]}

    d = start_agent(PORT, str(tmp_path / "s"))
    srv = client = None
    try:
        srv = APIServer(d).start()
        server = d.serve_xds()
        got, hosts, versions = {}, {}, []

        def apply(store, v, res):
            store.clear()
            store.update(res)
            versions.append(v)
            return True

        client = XDSWireClient(server.port, client="agent-test")
        client.subscribe(TYPE_NETWORK_POLICY,
                         lambda v, res: apply(got, v, res))
        client.subscribe(TYPE_NETWORK_POLICY_HOSTS,
                         lambda v, res: apply(hosts, v, res))
        rest("PUT", "/endpoint/7", {"ipv4": "10.66.0.7",
                                    "labels": ["k8s:app=web"]})
        rev = rest("PUT", "/policy", json.dumps(
            [rule("xds-v1", "/v1/.*")]).encode())["revision"]
        assert d.wait_for_policy_revision(rev, timeout=WAIT_S)
        deadline = time.time() + WAIT_S
        while time.time() < deadline and not got:
            time.sleep(0.02)
        (rid, res), = got.items()
        redir = d.proxy.get(rid)
        assert rid == "7:ingress:TCP:8080" and redir is not None
        assert res["proxy_port"] == redir.proxy_port
        assert res["upstream"] == ["10.66.0.7", 8080]
        assert res["http_rules"] == [{"method": "GET", "path": "/v1/.*",
                                      "host": ""}]
        assert any("10.66.0.7/32" in h["host_addresses"]
                   for h in hosts.values())
        rev2 = rest("PUT", "/policy", json.dumps(
            [rule("xds-v2", "/v2/.*")]).encode())["revision"]
        assert d.wait_for_policy_revision(rev2, timeout=WAIT_S)
        v = d.xds_cache._version_of(TYPE_NETWORK_POLICY)
        assert d.xds_cache.wait_for_acks(TYPE_NETWORK_POLICY, v).wait(10)
        assert sorted(r["path"] for r in got[rid]["http_rules"]) == \
            ["/v1/.*", "/v2/.*"]
    finally:
        if client is not None:
            client.close()
        if srv is not None:
            srv.shutdown()
        d.shutdown()


def test_a_sharded_agent_starts_and_serves(tmp_path):
    """``dataplane_shards=2`` builds the sharded dataplane (no refusal):
    the agent settles the small state and serves every row through its
    shard lanes with the verdicts of a one-engine agent."""
    st = small_state()
    packed, _ = policy_packets(st, policy_remotes(st), 512, seed=4)
    soa = {f: np.ascontiguousarray(packed[i])
           for i, f in enumerate(PACKED_FIELDS)}
    sharded = single = None
    try:
        sharded = start_agent(PORT, str(tmp_path / "s"), dataplane_shards=2)
        single = start_agent(PORT, str(tmp_path / "o"))
        for d in (sharded, single):
            populate(PORT, d, st)
            assert settle(d)
        assert sharded.status()["dataplane"]["geometry"]["shards"] == 2
        assert sharded.status()["dataplane"]["status"] == "ok"
        rename = redirect_renames(single, sharded)
        v_s, i_s = sharded.datapath.classify_records(
            {k: v.copy() for k, v in soa.items()}, packed.shape[1])
        v_o, i_o = single.datapath.serving().submit_records(
            {k: v.copy() for k, v in soa.items()},
            packed.shape[1]).result(timeout=WAIT_S)
        np.testing.assert_array_equal(v_s, rename_verdicts(v_o, rename))
        np.testing.assert_array_equal(i_s, i_o)
    finally:
        shutdown_all(sharded, single)


def test_a_kvstore_backend_is_taken_as_in_the_reference():
    """``Daemon(kvstore_backend=...)``: the agent wraps the backend in
    the outage guard, allocates identities through the store and
    reports the reference's kvstore status for the same operations."""
    from cilium_tpu.kvstore.memory import InMemoryBackend as RefMemory
    from cilium_tpu_torch.kvstore.identity_allocator import \
        DistributedIdentityAllocator
    from cilium_tpu_torch.kvstore.memory import InMemoryBackend
    statuses, agents = [], []
    try:
        for pkg, backend in ((REF, RefMemory()), (PORT, InMemoryBackend())):
            cfg = pkg["DaemonConfig"](state_dir="",
                                      ct_checkpoint_interval_s=0)
            kw = {"device": "cpu"} if pkg is PORT else {}
            d = pkg["Daemon"](config=cfg, kvstore_backend=backend,
                              node_name="n1", **kw)
            agents.append(d)
            d.endpoint_create(1, ipv4="10.9.0.1", labels=["k8s:app=kv"])
            d.register_node("192.168.9.1", "10.9.0.0/24")
            statuses.append(d.status()["kvstore"])
        assert isinstance(agents[1].identity_allocator,
                          DistributedIdentityAllocator)
        assert agents[1].kv.inner.get(
            "cilium/state/nodes/v1/default/n1") is not None
        assert statuses[1] == statuses[0]
        assert statuses[1]["backend"] == "InMemoryBackend"
    finally:
        shutdown_all(*agents)


def test_features_match_the_reference(agents):
    """``status()["features"]`` keys the reference's ``probe_features``
    does, with ``cuda`` for ``pallas``, and offers the same engines with
    ``dense-cuda`` for ``dense-pallas``."""
    _st, ref, port = agents
    f_ref, f_port = ref.status()["features"], port.status()["features"]
    rename = {"pallas": "cuda"}
    assert sorted(f_port) == sorted(rename.get(k, k) for k in f_ref)
    engines = [{"dense-pallas": "dense-cuda"}.get(e, e)
               for e in f_ref["verdict_engines"]]
    assert f_port["verdict_engines"] == engines
    # the reference counts the test session's virtual JAX devices
    assert f_port["device_count"] == 1
    assert f_port["on_accelerator"] is f_ref["on_accelerator"] is False


def test_daemon_without_a_device_needs_the_card():
    """``device=None`` means ``cuda``; this box has no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Daemon()
