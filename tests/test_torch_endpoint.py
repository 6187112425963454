"""Endpoints and their build queue, the host helpers they use, and the
rules-to-verdicts wiring: the JAX package vs the port.

The endpoint state machine, label updates with their identity
references, policy regeneration (desired map state, its diff, the
redirects it makes and removes), the endpoint manager's coalescing,
follow-up builds and quiesce, the option maps, the trigger and the
span timers give the same results in both packages (tolerance 0).  The
end-to-end case wires each package the same way, rules -> identities
-> ``EndpointManager`` -> ``DeviceTableManager`` -> ``Datapath`` (the
port through ``workloads.PolicyRun`` with ``device="cpu"``), and holds
one batch's verdicts, events and identities equal.  Every test that
starts builder or trigger threads stops them in ``finally``, and every
wait has a timeout.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu import identity as ref_identity
from cilium_tpu import labels as ref_labels
from cilium_tpu import proxy as ref_proxy
from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.endpoint import endpoint as ref_endpoint
from cilium_tpu.endpoint import ids as ref_ids
from cilium_tpu.endpoint import manager as ref_manager
from cilium_tpu.endpoint import tables as ref_tables
from cilium_tpu.ipcache import cidr as ref_cidr
from cilium_tpu.ipcache import ipcache as ref_ipcache
from cilium_tpu.policy import jsonio as ref_jsonio
from cilium_tpu.policy import repository as ref_repository
from cilium_tpu.utils import option as ref_option
from cilium_tpu.utils import spanstat as ref_spanstat
from cilium_tpu.utils import trigger as ref_trigger

from cilium_tpu_torch import identity, labels, proxy
from cilium_tpu_torch.endpoint import endpoint, ids, manager
from cilium_tpu_torch.policy import jsonio, repository
from cilium_tpu_torch.utils import option, spanstat, trigger
from cilium_tpu_torch.workloads import (PolicyRun, rule_cidr_prefixes,
                                        policy_packets, policy_remotes,
                                        policy_state)

WAIT_S = 60.0

PKGS = {"ref": dict(labels=ref_labels, identity=ref_identity,
                    proxy=ref_proxy, endpoint=ref_endpoint,
                    manager=ref_manager, jsonio=ref_jsonio,
                    repository=ref_repository, option=ref_option,
                    spanstat=ref_spanstat, trigger=ref_trigger, ids=ref_ids,
                    proxy_kw={}),
        "port": dict(labels=labels, identity=identity, proxy=proxy,
                     endpoint=endpoint, manager=manager, jsonio=jsonio,
                     repository=repository, option=option,
                     spanstat=spanstat, trigger=trigger, ids=ids,
                     proxy_kw={"device": "cpu"})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _key(k):
    return (k.identity, k.dest_port, k.nexthdr, k.direction)


def _state_machine(pkg):
    m = PKGS[pkg]["endpoint"]
    S = m.EndpointState
    ep = m.Endpoint(5, ipv4="10.0.0.5", container_name="c5")
    out = []
    for s in (S.READY, S.REGENERATING, S.REGENERATING, S.CREATING,
              S.NOT_READY, S.WAITING_TO_REGENERATE, S.READY,
              S.WAITING_TO_REGENERATE, S.REGENERATING, S.READY,
              S.RESTORING, S.DISCONNECTED, S.DISCONNECTING, S.READY,
              S.DISCONNECTED, S.DISCONNECTING):
        out.append((s, ep.set_state(s, f"to {s}"), ep.state))
    try:
        ep.set_state("bogus")
    except m.StateTransitionError as e:
        out.append(("raised", str(e)))
    out.append([(s, r) for _, s, r in ep.status_log])
    return out


def test_endpoint_state_machine_matches_reference():
    assert _state_machine("port") == _state_machine("ref")


def _labels_and_regeneration(pkg):
    m = PKGS[pkg]
    st = policy_state(150, 4, 6, 6, seed=5)
    repo = m["repository"].Repository()
    repo.add_list(m["jsonio"].rules_from_json(st.rules_json))
    alloc = m["identity"].LocalIdentityAllocator()
    for _, lbl in st.peers:
        alloc.allocate(m["labels"].Labels.from_model(list(lbl)))
    mgr = m["proxy"].ProxyManager(**m["proxy_kw"])
    out = []
    eps = []
    for ep_id, ip, lbl in st.endpoints:
        ep = m["endpoint"].Endpoint(ep_id, ipv4=ip)
        changed = ep.update_labels(alloc, m["labels"].Labels.from_model(
            list(lbl)))
        again = ep.update_labels(alloc, m["labels"].Labels.from_model(
            list(lbl)))
        out.append(("labels", changed, again, ep.security_identity,
                    ep.state, ep.model()))
        eps.append(ep)
    eps[1].update_labels(alloc, m["labels"].Labels.from_model(
        ["k8s:app=db", "k8s:tier=ops"]))
    eps[2].opts.apply_validated({"IngressPolicy": 0})
    out.append(("refcounts", sorted(alloc._refcount.items())))
    cache = m["identity"].IdentityCache.snapshot(alloc)

    def regenerate():
        for ep in eps:
            res = ep.regenerate_policy(repo, cache, proxy=mgr,
                                       always_allow_localhost=ep.id % 2)
            out.append(("regen", ep.id, res.revision,
                        sorted((_key(k), v.proxy_port) for k, v in res.adds),
                        sorted(_key(k) for k in res.deletes),
                        res.redirects_added, res.redirects_removed,
                        vars(ep.policy_config(True))))
            ep.apply_regeneration(res)
            out.append(("applied", ep.policy_revision, ep.model(),
                        sorted(ep.proxy_redirects.items())))

    regenerate()
    # drop every HTTP rule: the redirects go, the map states shrink
    repo.delete_by_labels(m["labels"].LabelArray())
    repo.add_list([r for r in m["jsonio"].rules_from_json(st.rules_json)
                   if "http" not in m["jsonio"].rules_to_json([r])])
    regenerate()
    out.append(("redirects", sorted((r.id, r.proxy_port)
                                    for r in mgr.redirects())))
    return out


def test_labels_and_regeneration_match_reference():
    got = _labels_and_regeneration("port")
    assert got == _labels_and_regeneration("ref")
    regens = [row for row in got if row[0] == "regen"]
    assert any(row[5] for row in regens) and any(row[6] for row in regens)
    assert any(row[4] for row in regens)


def _manager_scenario(pkg):
    """Four builder threads all held in a build, then: a fifth endpoint
    queued (no worker free) and queued again (folds), a held endpoint
    queued twice (one follow-up), a failing build; released, every build
    runs once and the follow-up once more."""
    m = PKGS[pkg]
    S = m["endpoint"].EndpointState
    gate = threading.Event()
    started = threading.Semaphore(0)
    builds = []
    outcomes = []

    def regen(ep):
        builds.append(ep.id)
        started.release()
        if not gate.wait(WAIT_S):
            raise RuntimeError("gate never opened")
        if ep.id == 6:
            raise ValueError("build fails")

    mgr = m["manager"].EndpointManager(
        regenerate_fn=regen, builders=1,
        on_outcome=lambda i, ok: outcomes.append((i, ok)))
    try:
        eps = [m["endpoint"].Endpoint(i, container_name=f"c{i}")
               for i in range(1, 7)]
        for ep in eps:
            ep.set_state(S.READY)
            mgr.insert(ep)
        out = [[mgr.queue_regeneration(i) for i in (1, 2, 3, 4)]]
        for _ in range(4):
            assert started.acquire(timeout=WAIT_S)
        out.append([mgr.queue_regeneration(i) for i in (5, 5, 1, 1, 6)])
        out.append(mgr.wait_for_quiesce(timeout=0.05))
        gate.set()
        out.append(mgr.wait_for_quiesce(timeout=WAIT_S))
        out.append((sorted(builds), sorted(outcomes),
                    [ep.state for ep in eps]))
        out.append((mgr.regenerate_all("again"),
                    mgr.wait_for_quiesce(timeout=WAIT_S), len(builds)))
        out.append((len(mgr), mgr.lookup(3).id,
                    mgr.lookup_container("c4").id,
                    mgr.remove(4).id, mgr.remove(4), len(mgr),
                    [ep.id for ep in mgr.endpoints()]))
    finally:
        gate.set()
        mgr.shutdown()
    assert not any(w.is_alive() for w in mgr._workers)
    return out


def test_endpoint_manager_coalesces_and_follows_up_like_reference():
    got = _manager_scenario("port")
    assert got == _manager_scenario("ref")
    assert got[1] == [True, False, False, False, True]
    assert got[2] is False and got[3] is True
    builds, outcomes, states = got[4]
    assert builds.count(1) == 2 and builds.count(5) == 1
    assert (6, False) in outcomes and states[-1] == "not-ready"


def _options(pkg):
    m = PKGS[pkg]["option"]
    seen = []
    lib = dict(m.DAEMON_OPTION_LIBRARY)
    lib["Frozen"] = m.OptionSpec("Frozen", immutable=True)

    def verify(v):
        if v > 3:
            raise ValueError("too big")
    lib["Level"] = m.OptionSpec("Level", verify=verify)
    opts = m.IntOptions(lib, {"Policy": m.OPTION_ENABLED})
    out = [opts.apply_validated({"ConntrackAccounting": 1},
                                changed=lambda n, v: seen.append((n, v))),
           opts.dump(),
           opts.apply_validated({"Conntrack": 0},
                                changed=lambda n, v: seen.append((n, v))),
           opts.dump(), opts.apply_validated({"Level": 2})]
    for bad in ({"Nope": 1}, {"Frozen": 1}, {"Level": 9}):
        try:
            opts.apply_validated(bad)
        except (KeyError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    fork = opts.fork()
    fork.apply_validated({"Debug": 1})
    out += [opts.dump(), fork.dump(), opts.is_enabled("Level"),
            opts.get("Debug"), seen]
    return out


def test_option_maps_match_reference():
    assert _options("port") == _options("ref")


def _trigger_and_spans(pkg):
    m = PKGS[pkg]
    gate = threading.Event()
    runs = []
    done = threading.Semaphore(0)

    def fn(reasons):
        runs.append(list(reasons))
        done.release()
        gate.wait(WAIT_S)

    trig = m["trigger"].Trigger(fn, min_interval=0.0, name="t")
    try:
        trig.trigger("a")
        assert done.acquire(timeout=WAIT_S)
        for r in ("b", "c", "b", ""):
            trig.trigger(r)
        gate.set()
        assert done.acquire(timeout=WAIT_S)
    finally:
        gate.set()
        trig.shutdown()
    span = m["spanstat"].SpanStat()
    with span:
        pass
    try:
        with span:
            raise ValueError
    except ValueError:
        pass
    span.start().end(success=False)
    return (runs, span.num_success, span.num_failure,
            m["ids"].stable_endpoint_id("abc", m["ids"].CNI_ID_BASE),
            m["ids"].stable_endpoint_id("x" * 64, m["ids"].DOCKER_ID_BASE))


def test_trigger_spans_and_ids_match_reference():
    got = _trigger_and_spans("port")
    assert got == _trigger_and_spans("ref")
    assert got[0] == [["a"], ["b", "c"]]


class _RefPolicyRun:
    """The JAX package wired as ``workloads.PolicyRun`` wires the port
    (``cilium_tpu/daemon/daemon.py``'s policy path)."""

    def __init__(self, state, ct_slots):
        self.repo = ref_repository.Repository()
        self.allocator = ref_identity.LocalIdentityAllocator()
        self.ipcache = ref_ipcache.IPCache()
        self.proxy = ref_proxy.ProxyManager()
        self.table_mgr = ref_tables.DeviceTableManager()
        self.datapath = ref_engine.Datapath(ct_slots=ct_slots)
        self.datapath.telemetry_enabled = False
        self.datapath.use_table_manager(self.table_mgr)
        self.cidr_idents = {}
        self.endpoints = ref_manager.EndpointManager(
            regenerate_fn=self._regenerate)
        self._regen = ref_trigger.Trigger(
            lambda r: self.endpoints.regenerate_all(",".join(r)),
            min_interval=0.01, name="ref-policy")
        self._lpm = ref_trigger.Trigger(
            lambda _r: self.datapath.load_ipcache(
                *self.ipcache.to_lpm_prefix_families()),
            min_interval=0.01, name="ref-lpm")
        self.ipcache.add_listener(lambda *_a: self._lpm.trigger("ip"),
                                  replay=False)
        for ep_id, ip, lbl in state.endpoints:
            ep = ref_endpoint.Endpoint(ep_id, ipv4=ip)
            ep.table_slot = self.table_mgr.attach(ep_id)
            self.endpoints.insert(ep)
            ep.update_labels(self.allocator,
                             ref_labels.Labels.from_model(list(lbl)))
            self.datapath.set_endpoint_identity(ep.table_slot,
                                                ep.security_identity)
            self.ipcache.upsert(ip, ep.security_identity,
                                ref_ipcache.SOURCE_AGENT_LOCAL)
            self.endpoints.queue_regeneration(ep_id)
        for ip, lbl in state.peers:
            ident, _ = self.allocator.allocate(
                ref_labels.Labels.from_model(list(lbl)))
            self.ipcache.upsert(ip, ident.id, ref_ipcache.SOURCE_KVSTORE)
        rules = ref_jsonio.rules_from_json(state.rules_json)
        for r in rules:
            r.sanitize()
            for p in rule_cidr_prefixes(r):
                if p not in self.cidr_idents:
                    self.cidr_idents[p] = ref_cidr.allocate_cidr_identities(
                        self.allocator, self.ipcache, [p])[p]
        self.repo.add_list(rules)
        self._regen.trigger("policy-add")

    def _regenerate(self, ep):
        cache = ref_identity.IdentityCache.snapshot(self.allocator)
        res = ep.regenerate_policy(self.repo, cache, proxy=self.proxy)
        ep.apply_regeneration(res)
        self.table_mgr.sync_endpoint(ep.id, ep.realized, res.revision)
        self.datapath.refresh_policy(res.revision)

    def wait(self, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(ep.policy_revision >= self.repo.revision
                   for ep in self.endpoints.endpoints()) and \
                    self.endpoints.wait_for_quiesce(0.05) and \
                    self.datapath.ipcache_prefixes == \
                    self.ipcache.to_lpm_prefix_families()[0]:
                return True
            time.sleep(0.01)
        return False

    def shutdown(self):
        self._regen.shutdown()
        self._lpm.shutdown()
        self.endpoints.shutdown()


def test_rules_to_datapath_end_to_end_matches_reference():
    """Rules as JSON -> identities, repository, endpoints built by the
    manager's threads -> the table manager -> the engine, in both
    packages; one batch of new connections through ``process_packed``.
    Proxy ports follow build order, which the builder threads interleave,
    so the reference's are renamed to the port's by redirect id."""
    st = policy_state(120, 6, 8, 6, seed=8)
    packed, _ = policy_packets(st, policy_remotes(st), 4096, seed=3)
    ref = port = None
    try:
        ref = _RefPolicyRun(st, ct_slots=1 << 14)
        port = PolicyRun.from_state(st, device="cpu", ct_slots=1 << 14)
        port.datapath.telemetry_enabled = False
        assert ref.wait(WAIT_S) and port.wait_for_policy_revision(
            timeout=WAIT_S)
        ready = {ep.id: (ep.state, ep.policy_revision)
                 for ep in ref.endpoints.endpoints()}
        assert port.endpoint_states() == ready
        assert set(ready.values()) == {("ready", port.repo.revision)}
        ports = {r.id: r.proxy_port for r in port.proxy.redirects()}
        rename = {r.proxy_port: ports[r.id] for r in ref.proxy.redirects()}
        assert len(rename) == len(ports) > 0
        for ep_id, _, _ in st.endpoints:
            want = {_key(k): rename.get(v.proxy_port, v.proxy_port)
                    for k, v in ref.endpoints.lookup(ep_id).realized.items()}
            got = {_key(k): v.proxy_port for k, v in
                   port.endpoints.lookup(ep_id).realized.items()}
            assert got == want
        v_r, ev_r, id_r, _ = ref.datapath.process_packed(
            jnp.asarray(packed), now=1000)
        v_p, ev_p, id_p, _ = port.datapath.process_packed(
            torch.as_tensor(packed), now=1000)
        v_r = np.asarray(v_r)
        v_r = np.where(v_r > 0, [rename.get(int(v), int(v)) for v in v_r],
                       v_r)
        np.testing.assert_array_equal(v_p.numpy(), v_r)
        np.testing.assert_array_equal(ev_p.numpy(), np.asarray(ev_r))
        np.testing.assert_array_equal(id_p.numpy(), np.asarray(id_r))
        assert (v_p > 0).any() and (v_p == 0).any() and (v_p < 0).any()
    finally:
        for run in (ref, port):
            if run is not None:
                run.shutdown()
