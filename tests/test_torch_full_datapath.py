"""The v4 stateful step: the JAX package's ``Datapath`` vs the port's.

Both engines get the same state (``workloads.v4_serving_state`` at a
small size, with proxy ports on some rules) and the same batches
(``workloads.v4_serving_packets``, with fragments, overlay and proxy-mark
rows added), through ``process`` and ``process_packed``, with provenance
on and off.  After every batch the verdicts, events, identities, every
NAT field, the counters, the whole CT snapshot (sentinel included) and
the provenance must be equal bit for bit (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.datapath import lb as ref_lb
from cilium_tpu.endpoint import tables as ref_tables
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch.datapath import engine, events
from cilium_tpu_torch import convert
from cilium_tpu_torch.datapath.pipeline import PACKED_FIELDS, PACKED_INDEX
from cilium_tpu_torch.endpoint.tables import DeviceTableManager
from cilium_tpu_torch.policy.mapstate import (EGRESS, PolicyKey,
                                              PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.workloads import v4_serving_packets, v4_serving_state

CT_SLOTS = 1 << 10
BATCH = 2048
T0 = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_states(states):
    out = []
    for st in states:
        r = ref_ms.PolicyMapState()
        for k, v in st.items():
            r[ref_ms.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                               k.direction)] = \
                ref_ms.PolicyMapStateEntry(v.proxy_port)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def serving():
    """A small v4 serving state whose every seventh rule redirects to a
    proxy port."""
    st = v4_serving_state(n_rules=100, n_endpoints=4, n_services=40,
                          n_prefilter=20, n_nodes=8)
    for state in st.states:
        for k in list(state):
            if k.dest_port and k.identity % 7 == 0:
                state[k] = PolicyMapStateEntry(proxy_port=15000 +
                                               k.identity % 100)
    return st


def _load_ref(dp, st):
    for s in st.services:
        dp.lb.upsert_service(ref_lb.Service(
            vip=s.vip, port=s.port, proto=s.proto,
            backends=[ref_lb.Backend(addr=b.addr, port=b.port)
                      for b in s.backends]))
    dp.prefilter.insert(st.prefilter)
    dp.load_tunnel(st.tunnel)
    for slot, ident in enumerate(st.ep_identity):
        dp.set_endpoint_identity(slot, ident)
    dp.load_policy(_ref_states(st.states), revision=1,
                   ipcache_prefixes=st.prefixes)


def _pair(st, provenance):
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    _load_ref(ref, st)
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    st.load(port)
    if provenance:
        ref.enable_provenance()
        port.enable_provenance()
    return ref, port


def _u32(x):
    return np.asarray(x).view(np.int32)


def assert_same(ref, port, outs_ref, outs_port):
    """Every output, the counters and the whole v4 CT, bit for bit."""
    for name, r, t in zip(("verdict", "event", "identity"), outs_ref[:3],
                          outs_port[:3]):
        np.testing.assert_array_equal(np.asarray(r), t.numpy(), name)
    for f in outs_ref[3]._fields:
        np.testing.assert_array_equal(np.asarray(getattr(outs_ref[3], f)),
                                      getattr(outs_port[3], f).numpy(),
                                      f"nat.{f}")
    for f in ("packets", "bytes"):
        np.testing.assert_array_equal(_u32(getattr(ref.counters, f)),
                                      getattr(port.counters, f).numpy(), f)
    snap_ref, snap_port = ref.snapshot_ct()[0], port.snapshot_ct()[0]
    for f in snap_ref:
        np.testing.assert_array_equal(snap_ref[f], snap_port[f], f"ct.{f}")
    if ref.provenance_enabled:
        for f in ("match_slot", "tier"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref.last_provenance, f)),
                getattr(port.last_provenance, f).numpy(), f)
    else:
        assert port.last_provenance is None


def _extras(rng, packed):
    """Fragment flags on 1% of the rows."""
    packed = packed.copy()
    packed[PACKED_INDEX["is_fragment"]] = \
        (rng.random(packed.shape[1]) < 0.01).astype(np.int32)
    return packed


@pytest.mark.parametrize("provenance", [False, True],
                         ids=["provenance-off", "provenance-on"])
def test_datapath_matches_reference_over_batches(serving, provenance):
    """Six batches alternating ``process`` and ``process_packed``, a GC
    after the fourth; the sequence reaches every CT state, rev-NAT,
    overlay encap, proxy redirects, fragments, the prefilter and the
    backend-less service."""
    ref, port = _pair(serving, provenance)
    rng = np.random.default_rng(3)
    stream = v4_serving_packets(serving, BATCH, n_flows=512)
    seen_events, seen_tiers = set(), set()
    last_vip = serving.services[-1].vip
    hit_last_vip = 0
    for t in range(6):
        packed = _extras(rng, next(stream))
        now = T0 + t * 3
        hit_last_vip += int((packed[PACKED_INDEX["daddr"]]
                             .view(np.uint32) == last_vip).sum())
        if t % 2:
            outs_ref = ref.process_packed(jnp.asarray(packed), now=now)
            outs_port = port.process_packed(torch.as_tensor(packed),
                                            now=now)
        else:
            cols = {f: packed[i] for i, f in enumerate(PACKED_FIELDS)}
            outs_ref = ref.process(ref_engine.make_full_batch(**cols),
                                   now=now)
            outs_port = port.process(
                engine.make_full_batch(**cols, device="cpu"), now=now)
        assert_same(ref, port, outs_ref, outs_port)
        seen_events.update(outs_port[1].tolist())
        if provenance:
            seen_tiers.update(port.last_provenance.tier.tolist())
        if t == 3:
            n = port.gc(now=now + 61)
            assert n == ref.gc(now=now + 61) and n > 0
            assert_same(ref, port, outs_ref, outs_port)
    assert hit_last_vip > 0
    assert {events.TRACE_TO_LXC, events.TRACE_TO_PROXY,
            events.TRACE_TO_OVERLAY, events.DROP_POLICY,
            events.DROP_PREFILTER,
            events.DROP_FRAG_NOSUPPORT} <= seen_events, seen_events
    assert int((outs_port[3].rev_nat != 0).sum()) > 0
    if provenance:
        assert {events.TIER_PREFILTER, events.TIER_CT_ESTABLISHED,
                events.TIER_L3_ALLOW, events.TIER_L4_RULE,
                events.TIER_L7_REDIRECT, events.TIER_DENY} <= seen_tiers
    assert port.ct_entries() == ref.ct_entries()


def test_make_full_batch_with_overlay_and_mark_fields(serving):
    """``make_full_batch`` from dotted quads and uint32 addresses with
    the overlay and proxy-mark fields, then one step through both."""
    ref, port = _pair(serving, provenance=True)
    rng = np.random.default_rng(9)
    n = 64
    cols = dict(
        endpoint=rng.integers(0, 4, n),
        saddr=["10.128.0.%d" % (i % 250) for i in range(n)],
        daddr=rng.integers(0, 2 ** 32, n).astype(np.uint32),
        sport=rng.integers(1, 65536, n), dport=rng.integers(1, 65536, n),
        direction=rng.integers(0, 2, n),
        from_overlay=rng.integers(0, 2, n),
        tunnel_id=rng.choice(list(serving.ident_port), n),
        mark_identity=np.where(rng.random(n) < 0.3,
                               rng.choice(list(serving.ident_port), n), 0))
    jb = ref_engine.make_full_batch(**cols)
    tb = engine.make_full_batch(**cols, device="cpu")
    for f in jb._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      getattr(tb, f).numpy(), f)
    assert_same(ref, port, ref.process(jb, now=T0),
                port.process(tb, now=T0))
    only_overlay = {k: v for k, v in cols.items() if k != "mark_identity"}
    assert engine.make_full_batch(**only_overlay,
                                  device="cpu").mark_identity is None


def test_table_manager_row_sync_and_growth(serving):
    """``use_table_manager``; then ``sync_endpoint`` + ``refresh_policy``
    on the fast path (row writes, no rebuild), a sync that outgrows the
    slots (a rebuild), a detach; both engines agree after each, and a
    synced row shows only after ``refresh_policy``."""
    states = serving.states
    ref_mgr = ref_tables.DeviceTableManager(initial_endpoints=2,
                                            initial_slots=64)
    mgr = DeviceTableManager(initial_endpoints=2, initial_slots=64,
                             device="cpu")
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    small = [PolicyMapState(dict(list(st.items())[:12])) for st in states]
    for ep_id in range(4):
        assert ref_mgr.attach(100 + ep_id) == mgr.attach(100 + ep_id)
        ref_mgr.sync_endpoint(100 + ep_id, _ref_states([small[ep_id]])[0],
                              revision=1)
        mgr.sync_endpoint(100 + ep_id, small[ep_id], revision=1)
    ref.use_table_manager(ref_mgr, ipcache_prefixes=serving.prefixes)
    port.use_table_manager(mgr, ipcache_prefixes=serving.prefixes)
    stream = v4_serving_packets(serving, 512, n_flows=128)

    def step(now):
        packed = next(stream)
        assert_same(ref, port, ref.process_packed(jnp.asarray(packed),
                                                  now=now),
                    port.process_packed(torch.as_tensor(packed), now=now))

    step(T0)
    # fast path: a rule change on one endpoint is a row write
    extra = PolicyMapState(small[1])
    extra[PolicyKey(identity=0, dest_port=443, nexthdr=6,
                    direction=EGRESS)] = PolicyMapStateEntry(proxy_port=9)
    ref_stats = ref_mgr.sync_endpoint(101, _ref_states([extra])[0], 2)
    stats = mgr.sync_endpoint(101, extra, 2)
    assert stats == ref_stats and not stats["full_swap"]
    before = port._tables.datapath.value.clone()
    step(T0 + 1)  # not refreshed yet: both still serve the old rows
    assert torch.equal(port._tables.datapath.value, before)
    assert ref.refresh_policy(2) is False
    assert port.refresh_policy(2) is False
    assert not torch.equal(port._tables.datapath.value, before)
    step(T0 + 2)
    # growth: a full state does not fit 64 slots
    ref_stats = ref_mgr.sync_endpoint(102, _ref_states([states[2]])[0], 3)
    stats = mgr.sync_endpoint(102, states[2], 3)
    assert stats == ref_stats and stats["full_swap"]
    assert ref.refresh_policy(3) is True
    assert port.refresh_policy(3) is True
    step(T0 + 3)
    ref_mgr.detach(103)
    mgr.detach(103)
    assert ref.refresh_policy(4) is False
    assert port.refresh_policy(4) is False
    step(T0 + 4)
    assert mgr.stats() == ref_mgr.stats()
    for r, t in zip(ref_mgr.host_mirror(), mgr.host_mirror()):
        np.testing.assert_array_equal(r, t)
    assert mgr.slot_of(102) == ref_mgr.slot_of(102)
    with pytest.raises(RuntimeError, match="table-manager"):
        engine.Datapath(device="cpu").refresh_policy()


def test_counters_survive_reload_and_ct_restores_across_packages(serving):
    """``load_policy`` keeps the counters and the CT when the shapes
    allow; the reference's counter pack and CT snapshot carry into a
    fresh port engine (and the port's snapshot back), and the next
    batch agrees."""
    ref, port = _pair(serving, provenance=False)
    stream = v4_serving_packets(serving, BATCH, n_flows=512)
    for t in range(2):
        packed = next(stream)
        outs = (ref.process_packed(jnp.asarray(packed), now=T0 + t),
                port.process_packed(torch.as_tensor(packed), now=T0 + t))
    ref.load_policy(_ref_states(serving.states), revision=2)
    port.load_policy(serving.states, revision=2)
    assert port.revision == 2
    assert int(port.counters.packets.sum()) != 0
    assert_same(ref, port, *outs)
    v4, v6 = ref.snapshot_ct()
    fresh = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    serving.load(fresh)
    fresh._counters = convert.counters_from_pack(np.asarray(ref._counters),
                                                 device="cpu")
    assert fresh.restore_ct_snapshots(v4, v6) == sum(ref.ct_entries())
    packed = next(stream)
    assert_same(ref, fresh, ref.process_packed(jnp.asarray(packed),
                                               now=T0 + 5),
                fresh.process_packed(torch.as_tensor(packed), now=T0 + 5))
    back4, back6 = fresh.snapshot_ct()
    assert ref.restore_ct_snapshots(back4, back6) == sum(fresh.ct_entries())
    with pytest.raises(ValueError, match="geometry"):
        engine.Datapath(ct_slots=CT_SLOTS * 2,
                        device="cpu").restore_ct_snapshots(back4, back6)
