"""The serving lane of the port (``datapath/serving.py``) against the JAX
package, on the CPU.

Both packages get the same policy (``build_config1`` at 40 rules x 8
endpoints, a 2**12-slot CT) and the same record chunks; every verdict
and identity the port's lane answers must equal the JAX ``Datapath``'s
for the same chunk run alone (tolerance 0).  Also the dispatcher core's
contracts (tickets, fail-closed batches, admission control, watermark
hysteresis, the double buffer and its staging rings), the payload lane
against the JAX lane, ``verdict_explain`` / ``policy_replay`` and
``host_fail_static_step`` against the JAX package's, and
``DeviceTableManager.states_by_slot`` against the JAX manager's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.datapath import serving as ref_serving
from cilium_tpu.datapath import verdict as ref_verdict
from cilium_tpu.endpoint import tables as ref_tables
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch.datapath import engine, pipeline, verdict
from cilium_tpu_torch.datapath.events import DROP_POLICY
from cilium_tpu_torch.datapath.serving import (ContinuousDispatcher,
                                               ShedError,
                                               VerdictDispatcher)
from cilium_tpu_torch.endpoint.tables import DeviceTableManager
from cilium_tpu_torch.policy.mapstate import (EGRESS, INGRESS, PolicyKey,
                                              PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.utils.metrics import DATAPLANE_OVERLOADED
from cilium_tpu_torch.workloads import (build_config1, l7_serving_packets,
                                        l7_serving_state, v4_serving_state)

N_RULES, N_ENDPOINTS, CT_SLOTS = 40, 8, 1 << 12
# chunk sizes of the lane tests: the JAX oracle compiles once per size
SIZES = (5, 40, 200)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ref_states(states):
    out = []
    for st in states:
        r = ref_ms.PolicyMapState()
        for k, v in st.items():
            r[ref_ms.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                               k.direction)] = \
                ref_ms.PolicyMapStateEntry(v.proxy_port)
        out.append(r)
    return out


def load_pair(**supervision):
    """(JAX, port) engines with the same config-1 policy; the port's on
    the CPU, both with telemetry off.  ``supervision`` configures both
    lanes before first use."""
    states, prefixes = build_config1(n_rules=N_RULES,
                                     n_endpoints=N_ENDPOINTS)
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    port.telemetry_enabled = False
    if supervision:
        ref.configure_supervision(**supervision)
        port.configure_supervision(**supervision)
    ref.load_policy(ref_states(states), revision=1,
                    ipcache_prefixes=prefixes)
    port.load_policy(states, revision=1, ipcache_prefixes=prefixes)
    return ref, port, prefixes


@pytest.fixture(scope="module")
def oracle():
    """One JAX engine answers every lane test's chunks alone: source
    ports are unique across the module, so no chunk meets another's CT
    entries."""
    return load_pair()[0]


_SPORT = [20000]


def chunk(rng, n, prefixes=None, hit_frac=0.5):
    """One SoA record chunk (PacketRing pop_batch layout) with source
    ports unique across the module; with ``prefixes`` the first
    ``hit_frac`` of the destinations fall inside installed prefixes, so
    part of the chunk is allowed and creates CT entries."""
    base = _SPORT[0]
    _SPORT[0] += n
    daddr = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if prefixes:
        cidrs = list(prefixes)
        for j in range(int(n * hit_frac)):
            a = cidrs[j % len(cidrs)].split("/")[0].split(".")
            daddr[j] = (int(a[0]) << 24) | (int(a[1]) << 16) | \
                (int(a[2]) << 8) | 7
    return {
        "endpoint": rng.integers(0, N_ENDPOINTS, n).astype(np.int32),
        "saddr": rng.integers(0, 1 << 32, n,
                              dtype=np.uint32).view(np.int32),
        "daddr": daddr.view(np.int32),
        "sport": ((base + np.arange(n)) % 64000 + 1024).astype(np.int32),
        "dport": rng.integers(1, 65536, n).astype(np.int32),
        "proto": np.full(n, 6, np.int32),
        "direction": np.ones(n, np.int32),
        "tcp_flags": np.full(n, 0x02, np.int32),
        "is_fragment": np.zeros(n, np.int32),
        "length": np.full(n, 256, np.int32),
    }


def ref_alone(ref, c):
    """The JAX engine's (verdict, identity) for the chunk alone."""
    v, _e, i, _n = ref.process(ref_engine.make_full_batch(**c))
    return np.asarray(v).astype(np.int32), np.asarray(i).astype(np.int32)


def port_engine():
    return load_pair()[1]


# ------------------------------------------- parity under concurrency

@pytest.mark.parametrize("seed", [3, 5, 7])
def test_concurrent_submitters_equal_reference(oracle, seed):
    dp = port_engine()
    disp = VerdictDispatcher(dp, max_batch=4096, lane=f"par{seed}")
    rng = np.random.default_rng(seed)
    n_threads, chunks_per = 4, 5
    chunks = [[chunk(rng, int(rng.choice(SIZES)))
               for _ in range(chunks_per)] for _ in range(n_threads)]
    results, errors = {}, []

    def submitter(tid):
        try:
            tickets = [disp.submit_records(c, len(c["sport"]))
                       for c in chunks[tid]]
            for ci, t in enumerate(tickets):
                results[(tid, ci)] = t.result(timeout=60)
                assert t.error is None, t.error
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=submitter, args=(tid,))
               for tid in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    try:
        assert not errors, errors
        for tid in range(n_threads):
            for ci, c in enumerate(chunks[tid]):
                n = len(c["sport"])
                v, i = results[(tid, ci)]
                assert v.shape == (n,) and i.shape == (n,)
                rv, ri = ref_alone(oracle, c)
                np.testing.assert_array_equal(v, rv)
                np.testing.assert_array_equal(i, ri)
        st = disp.stats()
        assert st["frames"] == n_threads * chunks_per
        assert st["errors"] == 0 and disp.staging_replaced == 0
    finally:
        disp.close()


# ---------------------------------------------- the dispatcher core

def test_tickets_map_back_to_their_items():
    """200 items from 8 threads through a host-only core: every ticket
    resolves to f(its own item), however the launches grouped them."""
    disp = ContinuousDispatcher(
        launch=lambda items, total: list(items),
        finalize=lambda handle, weights: [x * 2 + 1 for x in handle],
        deny=lambda item: None, max_batch=16,
        lane="map-test")
    out = {}

    def run(base):
        for k in range(25):
            out[base + k] = disp.submit(base + k)

    threads = [threading.Thread(target=run, args=(i * 1000,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    try:
        for item, ticket in out.items():
            assert ticket.result(timeout=30) == item * 2 + 1
            assert ticket.error is None
        assert disp.batches >= 200 / 16
    finally:
        disp.close()


def test_failed_dispatch_denies_exactly_that_batch():
    def launch(items, total):
        if "poison" in items:
            raise RuntimeError("engine down")
        return list(items)

    disp = ContinuousDispatcher(
        launch=launch,
        finalize=lambda handle, weights: [True] * len(handle),
        deny=lambda item: False, max_batch=64,
        lane="fc-test")
    try:
        good1 = [disp.submit(f"a{i}") for i in range(4)]
        assert all(t.result(timeout=30) is True for t in good1)
        bad = [disp.submit("poison" if i == 2 else f"b{i}")
               for i in range(4)]
        for t in bad:
            assert t.result(timeout=30) is False
            assert isinstance(t.error, RuntimeError)
        good2 = [disp.submit(f"c{i}") for i in range(4)]
        for t in good2:
            assert t.result(timeout=30) is True and t.error is None
        assert disp.errors == 1
    finally:
        disp.close()


def test_engine_lane_fails_closed_without_policy():
    """Both packages' lanes deny exactly the submitted records with
    DROP_POLICY (and identity 0) when no policy is loaded."""
    rng = np.random.default_rng(1)
    c = chunk(rng, 9)
    got = []
    for lane in (ref_serving.VerdictDispatcher(
            ref_engine.Datapath(ct_slots=1 << 10), lane="no-policy-ref"),
            VerdictDispatcher(engine.Datapath(ct_slots=1 << 10,
                                              device="cpu"),
                              lane="no-policy")):
        try:
            t = lane.submit_records(c, 9)
            v, i = t.result(timeout=30)
            assert t.error is not None
            got.append((np.asarray(v), np.asarray(i)))
        finally:
            lane.close()
    for v, i in got:
        assert v.shape == (9,) and (v == DROP_POLICY).all()
        assert (i == 0).all()


def test_closed_dispatcher_fails_closed_immediately():
    disp = ContinuousDispatcher(
        launch=lambda items, total: items,
        finalize=lambda handle, weights: [True] * len(handle),
        deny=lambda item: False, lane="closed-test")
    disp.close()
    t = disp.submit("x")
    assert t.result(timeout=5) is False
    assert t.error is not None


def test_bounded_queue_sheds_overflow_fail_closed():
    release = threading.Event()

    def slow_launch(items, total):
        release.wait(5.0)
        return list(items)

    disp = ContinuousDispatcher(
        slow_launch, lambda h, w: [True] * len(h),
        deny=lambda item: False, max_batch=4, max_pending=8,
        lane="shed-ovl")
    try:
        tickets = [disp.submit(i) for i in range(64)]
        shed = [t for t in tickets if isinstance(t.error, ShedError)]
        assert shed and all(t.error.reason == "overflow"
                            and t.value is False for t in shed)
        assert disp.max_pending_seen <= 8
        release.set()
        for t in tickets:
            if not isinstance(t.error, ShedError):
                assert t.result(timeout=30) is True
        assert disp.stats()["shed"]["overflow"] == len(shed)
    finally:
        release.set()
        disp.close()


def test_expired_deadline_sheds_at_drain_time():
    gate = threading.Event()

    def gated_launch(items, total):
        gate.wait(5.0)
        return list(items)

    disp = ContinuousDispatcher(
        gated_launch, lambda h, w: [True] * len(h),
        deny=lambda item: False, max_batch=2, lane="shed-dl")
    try:
        head = disp.submit("head")
        doomed = [disp.submit(i, deadline=0.01) for i in range(8)]
        time.sleep(0.05)
        gate.set()
        assert head.result(timeout=30) is True
        for t in doomed:
            t.result(timeout=30)
        shed = [t for t in doomed if isinstance(t.error, ShedError)
                and t.error.reason == "deadline"]
        assert shed and all(t.value is False for t in shed)
    finally:
        gate.set()
        disp.close()


def test_overload_watermark_hysteresis():
    release = threading.Event()

    def slow_launch(items, total):
        release.wait(10.0)
        return list(items)

    disp = ContinuousDispatcher(
        slow_launch, lambda h, w: [True] * len(h),
        deny=lambda item: False, max_batch=1, max_pending=100,
        lane="hyst")
    try:
        tickets = [disp.submit(i) for i in range(80)]
        assert disp.overloaded
        assert DATAPLANE_OVERLOADED.value(labels={"lane": "hyst"}) == 1.0
        release.set()
        for t in tickets:
            t.result(timeout=60)
        deadline = time.monotonic() + 10
        while disp.overloaded and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not disp.overloaded
        assert DATAPLANE_OVERLOADED.value(labels={"lane": "hyst"}) == 0.0
    finally:
        release.set()
        disp.close()


# ------------------------------------ the double buffer and its staging

@pytest.mark.parametrize("depth", [2, 1])
def test_batches_in_flight_and_staging_reuse(oracle, depth):
    """12 chunks submitted at once: at depth 2 the lane keeps a second
    batch in flight while the first completes; at depth 1 every staging
    slot is refilled only after the batch that used it completed (two
    slots a bucket, reused in turn, never replaced).  Every ticket
    equals the JAX engine's answer for its chunk alone."""
    dp = port_engine()
    disp = VerdictDispatcher(dp, max_batch=SIZES[1], depth=depth,
                             lane=f"overlap{depth}")
    inflight = []
    launch = disp._launch

    def spy(items, total):
        inflight.append(len(disp._inflight))
        return launch(items, total)

    disp._launch = spy
    rng = np.random.default_rng(2 + depth)
    try:
        chunks = [chunk(rng, SIZES[1]) for _ in range(12)]
        tickets = [disp.submit_records(c, SIZES[1]) for c in chunks]
        got = [t.result(timeout=60) for t in tickets]
        assert all(t.error is None for t in tickets)
        for c, (v, i) in zip(chunks, got):
            rv, ri = ref_alone(oracle, c)
            np.testing.assert_array_equal(v, rv)
            np.testing.assert_array_equal(i, ri)
        assert disp.batches == 12
        # a launch happens only with fewer than ``depth`` in flight
        assert max(inflight) == depth - 1
        ring = disp._rings[64]
        assert len(ring) == depth + 1 and disp.staging_replaced == 0
        assert disp._ticks[64] == 12
    finally:
        disp.close()


def test_unfinished_slot_is_replaced_not_reused():
    """A slot whose batch was never waited on (its event not complete)
    gets fresh buffers instead of being refilled."""
    dp = port_engine()
    disp = VerdictDispatcher(dp, depth=1, lane="replace")

    class Pending:
        def query(self):
            return False

    try:
        first = disp._slot_for(16)
        first.done = Pending()
        disp._slot_for(16)
        assert disp._slot_for(16) is not first
        assert disp.staging_replaced == 1
    finally:
        disp.close()


def test_telemetry_stages_and_verdict_counts():
    """With telemetry on, the lane's stages are queue-wait, pack,
    dispatch and complete, and complete is the one blocking boundary;
    the engine records its lock-wait and dispatch, the verdict outcomes
    (read back once finished) and the first dispatch at a new
    revision."""
    from cilium_tpu_torch.observability import stages
    from cilium_tpu_torch.utils.metrics import POLICY_VERDICTS

    stages.reset()
    dp = port_engine()
    dp.telemetry_enabled = True
    served = []
    dp.on_revision_served = served.append
    before = POLICY_VERDICTS.total()
    lane = dp.serving()
    rng = np.random.default_rng(11)
    try:
        for _ in range(3):
            t = lane.submit_records(chunk(rng, SIZES[1]), SIZES[1])
            t.result(timeout=60)
            assert t.error is None
        dp.flush_telemetry()
        rep = stages.pipeline_report()
        assert set(rep[lane.family]) == {"queue-wait", "pack", "dispatch",
                                         "complete"}
        assert [n for n, d in rep[lane.family].items()
                if d["blocking-boundary"]] == ["complete"]
        assert rep["engine-v4"]["dispatch"]["count"] == 3
        # every row of the padded batch is counted, as in the reference
        assert POLICY_VERDICTS.total() - before == 3 * 64
        assert served == [1] and not dp._pending_verdicts
    finally:
        lane.close()


# --------------------------------------- flows, provenance, payloads

def test_serving_with_flows_and_provenance(oracle):
    """The lane's packed step carries the flow table and provenance and
    answers what the JAX engine with both on answers for the chunk
    alone."""
    ref, dp, _ = load_pair()
    for e in (ref, dp):
        e.enable_flow_aggregation(slots=1 << 10)
        e.enable_provenance()
    disp = VerdictDispatcher(dp, lane="fused")
    rng = np.random.default_rng(9)
    try:
        c = chunk(rng, SIZES[1])
        t = disp.submit_records(c, SIZES[1])
        v, i = t.result(timeout=60)
        assert t.error is None
        rv, ri = ref_alone(ref, c)
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(i, ri)
        stats = dp.flow_stats()
        assert stats["occupied"] > 0 or stats["lost"] > 0
        assert dp.last_provenance is not None
    finally:
        disp.close()


def test_payload_lane_equals_reference_lane():
    """Chunks with a payload block, without one, and with one wider than
    the engine's window (poisoned rows) through both packages' lanes,
    one chunk a batch: equal verdicts and identities."""
    from test_torch_full_datapath import _load_ref
    from test_torch_l7_fast import WINDOW, _ref_programs
    from cilium_tpu_torch import convert

    st = l7_serving_state(v4_serving_state(
        n_rules=100, n_endpoints=4, n_services=40, n_prefilter=20,
        n_nodes=8), window=WINDOW)
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    _load_ref(ref, st.v4)
    ref.enable_l7_fast(_ref_programs(WINDOW))
    dp = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    dp.telemetry_enabled = False
    st.v4.load(dp)
    dp.enable_l7_fast(convert.l7_programs_from_jax(_ref_programs(WINDOW)))
    lanes = (ref_serving.VerdictDispatcher(ref, lane="pl-ref"),
             VerdictDispatcher(dp, lane="pl"))
    stream = l7_serving_packets(st, 64, n_flows=64)
    rng = np.random.default_rng(4)
    try:
        for kind in ("payload", "none", "wide"):
            packed, idx = next(stream)
            soa = {f: packed[k].copy()
                   for k, f in enumerate(pipeline.PACKED_FIELDS)}
            pl = st.table[idx].astype(np.int32)
            if kind == "none":
                pl = None
            elif kind == "wide":
                extra = np.full((64, 8), -1, np.int32)
                extra[rng.random(64) < 0.3, 2] = 65
                pl = np.concatenate([pl, extra], axis=1)
            outs = []
            for lane in lanes:
                t = lane.submit_records(soa, 64, payload=pl)
                v, i = t.result(timeout=120)
                assert t.error is None
                outs.append((np.asarray(v), np.asarray(i)))
            np.testing.assert_array_equal(outs[0][0], outs[1][0], kind)
            np.testing.assert_array_equal(outs[0][1], outs[1][1], kind)
            if kind == "payload":
                assert (outs[1][0] == 0).any()
    finally:
        for lane in lanes:
            lane.close()


# ------------------------------------------------ replay and explain

def _random_keys(rng, states, n):
    """Rows of (slot, identity, dport, proto, direction): half installed
    keys of random slots, half random ones."""
    rows = []
    for j in range(n):
        slot = int(rng.integers(0, len(states)))
        keys = list(states[slot])
        if j % 2 == 0 and keys:
            k = keys[int(rng.integers(0, len(keys)))]
            rows.append((slot, k.identity, k.dest_port, k.nexthdr,
                         k.direction))
        else:
            rows.append((slot, int(rng.integers(0, 1 << 31)),
                         int(rng.integers(0, 65536)),
                         int(rng.choice([0, 6, 17])),
                         int(rng.integers(0, 2))))
    return [list(c) for c in zip(*rows)]


def test_verdict_explain_and_policy_replay_equal_reference():
    ref, dp, _ = load_pair()
    states = [dp.host_policy_states()[s] for s in range(N_ENDPOINTS)]
    rng = np.random.default_rng(12)
    cols = _random_keys(rng, states, 256)
    frag = (rng.random(256) < 0.1).astype(np.int32)
    got = verdict.verdict_explain(
        *(t for t in (dp._tables.datapath.key_id,
                      dp._tables.datapath.key_meta,
                      dp._tables.datapath.value)),
        verdict.make_packet_batch(*cols, is_fragment=frag, device="cpu"),
        max_probe=dp._replay_probe)
    want = ref_verdict.verdict_explain(
        ref._tables.datapath.key_id, ref._tables.datapath.key_meta,
        ref._tables.datapath.value,
        ref_verdict.make_packet_batch(*cols, is_fragment=frag),
        max_probe=ref._replay_probe)
    for name in ("verdict", "tier", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), name)
    for stage in ("exact", "l3", "l4_wildcard"):
        for f in ("found", "value", "slot"):
            np.testing.assert_array_equal(got[stage][f].numpy(),
                                          np.asarray(want[stage][f]),
                                          f"{stage}.{f}")
    assert dp.policy_replay(*cols) == ref.policy_replay(*cols)
    assert any(r["verdict"] == 0 for r in dp.policy_replay(*cols))
    decode, ref_decode = dp.rule_decoder(), ref.rule_decoder()
    for s in (-1, 0, 5, 17, N_ENDPOINTS * 64 + 3):
        assert decode(s) == ref_decode(s)


def test_replay_without_policy_raises():
    with pytest.raises(RuntimeError, match="no policy loaded"):
        engine.Datapath(device="cpu").policy_replay([0], [1], [2], [6], [1])


def test_host_fail_static_step_equals_reference():
    """The same random SoA and the same callbacks through both
    packages' host step."""
    rng = np.random.default_rng(21)
    n = 300
    soa = chunk(rng, n)
    soa["direction"] = rng.integers(0, 2, n).astype(np.int32)
    soa["proto"] = rng.choice([6, 17, 1], n).astype(np.int32)

    def established(sa, da, sp, dp_, proto, direction):
        h = (sa * 3 + da * 5 + sp + dp_ + proto + direction) % 7
        return None if h < 4 else int(h - 4)

    def identity_of(addr):
        return 2 if addr % 5 == 0 else 256 + addr % 11

    def policy_verdict(slot, ident, dport, proto, direction):
        return -1 if (ident + dport + slot) % 3 else proto

    kw = dict(established=established, identity_of=identity_of,
              policy_verdict=policy_verdict)
    got = pipeline.host_fail_static_step(soa, n, **kw)
    want = ref_pipeline.host_fail_static_step(soa, n, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ states_by_slot

def test_states_by_slot_equals_reference_manager():
    """The same attaches, syncs (one past the slot budget, so the stack
    grows) and detaches on both managers: equal host-of-record states
    per slot, and the engine serves them as host_policy_states."""
    ref = ref_tables.DeviceTableManager(initial_endpoints=2,
                                        initial_slots=8)
    mgr = DeviceTableManager(initial_endpoints=2, initial_slots=8,
                             device="cpu")
    rng = np.random.default_rng(3)

    def state(n):
        st = PolicyMapState()
        for _ in range(n):
            st[PolicyKey(identity=int(rng.integers(1, 1 << 20)),
                         dest_port=int(rng.integers(0, 65536)),
                         nexthdr=int(rng.choice([0, 6, 17])),
                         direction=int(rng.choice([INGRESS, EGRESS])))] = \
                PolicyMapStateEntry(proxy_port=int(rng.choice([0, 15001])))
        return st

    for ep in (10, 11, 12):
        ref.attach(ep)
        mgr.attach(ep)
    for ep, n in ((10, 3), (11, 40), (12, 1), (10, 5)):
        st = state(n)
        ref.sync_endpoint(ep, ref_states([st])[0], revision=2)
        mgr.sync_endpoint(ep, st, revision=2)
    ref.detach(12)
    mgr.detach(12)
    ref.attach(13)
    mgr.attach(13)

    def plain(states):
        return {slot: {(k.identity, k.dest_port, k.nexthdr, k.direction):
                       v.proxy_port for k, v in st.items()}
                for slot, st in states.items()}

    assert plain(mgr.states_by_slot()) == plain(ref.states_by_slot())
    assert len(mgr.states_by_slot()) == 3
    dp = engine.Datapath(ct_slots=1 << 10, device="cpu")
    dp.use_table_manager(mgr)
    assert plain(dp.host_policy_states()) == plain(ref.states_by_slot())
