"""The packing manifest: the JAX package's ``parallel/packing.py`` vs the
port's.

For the same seeded v4 / v6 serving tables (plain; with the L7 fast
stage and the threat model, whose tables pack into groups of their own),
loaded into one JAX and one port engine (CPU): the manifests (class,
leaves with their groups, offsets, sizes and shapes, groups with their
dtypes and sizes) are equal, the packed group buffers are equal byte for
byte (and equal to the JAX engine's own packs), the port's ``unpacker``
gives views sharing the buffers' memory and equal to the leaves, and the
row and leaf writers leave the buffer the JAX writers give.  A full v4
step on the unpacked views answers as the step on the original tables.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.parallel import packing as ref_packing

from cilium_tpu_torch import convert
from cilium_tpu_torch.datapath import engine
from cilium_tpu_torch.endpoint.tables import DeviceTableManager
from cilium_tpu_torch.parallel import packing, specs
from cilium_tpu_torch.policy.mapstate import (EGRESS, PolicyKey,
                                              PolicyMapState,
                                              PolicyMapStateEntry)
from cilium_tpu_torch.workloads import (l7_serving_state, v4_serving_packets,
                                        v4_serving_state, v6_of)

from test_torch_full_datapath import _pair as _pair4
from test_torch_full_datapath6 import _pair as _pair6
from test_torch_l7_fast import WINDOW, _l7_pair, _ref_programs
from test_torch_threat import DRY_CFG

SMALL = dict(n_rules=100, n_endpoints=4, n_services=40, n_prefilter=20,
             n_nodes=8)


def _plain4():
    return _pair4(v4_serving_state(**SMALL), provenance=False)


def _plain6():
    return _pair6(v6_of(v4_serving_state(**SMALL)), provenance=False,
                  flows=False)


def _stages():
    st = l7_serving_state(v4_serving_state(**SMALL), window=WINDOW)
    st.programs = convert.l7_programs_from_jax(_ref_programs(WINDOW))
    return _l7_pair(st, threat=DRY_CFG, family6=True)


ENGINES = {"v4": _plain4, "v6": _plain6, "l7-threat": _stages}


@pytest.fixture(scope="module", params=sorted(ENGINES))
def engines(request):
    """(reference engine, port engine) over the same tables."""
    return ENGINES[request.param]()


def _tables(dp, family6):
    return dp._tables6 if family6 else dp._tables


FAMILIES = pytest.mark.parametrize("family6", [False, True],
                                   ids=["FullTables", "FullTables6"])


@FAMILIES
def test_manifests_equal_the_reference(engines, family6):
    ref, port = engines
    m_ref = ref_packing.build_manifest(_tables(ref, family6))
    m = packing.build_manifest(_tables(port, family6))
    assert m.cls_name == m_ref.cls_name
    assert [tuple(l) for l in m.leaves] == \
        [tuple(l) for l in m_ref.leaves]
    assert [tuple(g) for g in m.groups] == \
        [tuple(g) for g in m_ref.groups]
    assert m.group_names() == m_ref.group_names()
    assert m.leaf_count() == m_ref.leaf_count()
    # the JAX engine's own manifest of its live tables
    own = ref._manifest6 if family6 else ref._manifest4
    assert [tuple(g) for g in own.groups] == [tuple(g) for g in m.groups]
    assert set(m.group_names()) <= set(specs.PACKED_GROUP_SPECS)
    assert m.leaf("nonsense") is None


@FAMILIES
def test_packed_buffers_equal_the_reference(engines, family6):
    ref, port = engines
    t_ref, t = _tables(ref, family6), _tables(port, family6)
    bufs_ref = ref_packing.pack_groups(
        t_ref, ref_packing.build_manifest(t_ref))
    bufs = packing.pack_groups(t, packing.build_manifest(t))
    own = ref._tbufs6 if family6 else ref._tbufs4
    assert len(bufs) == len(bufs_ref) == len(own)
    for b, r, o in zip(bufs, bufs_ref, own):
        assert b.dtype == torch.int32 and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), np.asarray(r))
        np.testing.assert_array_equal(b.numpy(), np.asarray(o))
        assert b.numpy().tobytes() == np.asarray(r).tobytes()


@FAMILIES
def test_unpacked_views_are_the_leaves(engines, family6):
    """Every leaf of the unpacked tables equals the original, lies
    inside its group buffer's memory, and follows a write to it."""
    _ref, port = engines
    t = _tables(port, family6)
    m = packing.build_manifest(t)
    bufs = packing.pack_groups(t, m)
    views = packing.unpacker(m)(bufs)
    assert type(views) is type(t)
    orig = dict(packing._walk(t))
    got = dict(packing._walk(views))
    assert sorted(got) == sorted(orig)
    by_group = dict(zip(m.group_names(), bufs))
    for leaf in m.leaves:
        v, buf = got[leaf.path], by_group[leaf.group]
        torch.testing.assert_close(v, orig[leaf.path], rtol=0, atol=0)
        assert tuple(v.shape) == leaf.shape
        if leaf.size:
            assert v.data_ptr() == buf.data_ptr() + 4 * leaf.offset
    # the buffers are their own memory: writes leave the tables alone
    for leaf in m.leaves:
        if leaf.size:
            before = orig[leaf.path].clone()
            by_group[leaf.group][leaf.offset] += 1
            assert got[leaf.path].reshape(-1)[0] == \
                before.reshape(-1)[0] + 1
            torch.testing.assert_close(orig[leaf.path], before,
                                       rtol=0, atol=0)
            break


def _rows(rng, n, slots):
    return [rng.integers(-2 ** 31, 2 ** 31, (n, slots), dtype=np.int64)
            .astype(np.int32) for _ in range(3)]


@FAMILIES
def test_policy_row_writer_equals_the_reference(engines, family6):
    ref, port = engines
    t_ref, t = _tables(ref, family6), _tables(port, family6)
    m_ref, m = ref_packing.build_manifest(t_ref), \
        packing.build_manifest(t)
    w_ref, g_ref = ref_packing.make_policy_row_writer(m_ref)
    w, g = packing.make_policy_row_writer(m)
    assert g == g_ref
    bufs_ref = ref_packing.pack_groups(t_ref, m_ref)
    bufs = packing.pack_groups(t, m)
    n_slots = m.leaf("key_id" if family6 else "datapath.key_id").shape[1]
    rng = np.random.default_rng(11)
    slots = np.array([2, 0], np.int32)
    kid, kmeta, kval = _rows(rng, 2, n_slots)
    want = np.asarray(w_ref(bufs_ref[g_ref], jnp.asarray(slots),
                            jnp.asarray(kid), jnp.asarray(kmeta),
                            jnp.asarray(kval)))
    buf = bufs[g]
    out = w(buf, torch.as_tensor(slots), torch.as_tensor(kid),
            torch.as_tensor(kmeta), torch.as_tensor(kval))
    assert out is buf  # in place
    np.testing.assert_array_equal(buf.numpy(), want)
    # the views of the written buffer hold the rows
    views = packing.unpacker(m)(bufs)
    pol = views if family6 else views.datapath
    np.testing.assert_array_equal(pol.key_id[slots].numpy(), kid)
    np.testing.assert_array_equal(pol.value[slots].numpy(), kval)


def test_policy_rows_equal_what_refresh_policy_writes():
    """Rows ``refresh_policy`` writes into the engine's tables in place,
    written by ``make_policy_row_writer`` into the packed buffer: the
    views then equal the engine's tables."""
    st = v4_serving_state(**SMALL)
    mgr = DeviceTableManager(initial_endpoints=2, initial_slots=64,
                             device="cpu")
    dp = engine.Datapath(ct_slots=1 << 10, device="cpu")
    small = [PolicyMapState(dict(list(s.items())[:12])) for s in st.states]
    for ep_id in range(4):
        mgr.attach(100 + ep_id)
        mgr.sync_endpoint(100 + ep_id, small[ep_id], revision=1)
    dp.use_table_manager(mgr, ipcache_prefixes=st.prefixes)
    assert dp.refresh_policy(1) is False  # the first syncs' rows
    m = packing.build_manifest(dp._tables)
    bufs = packing.pack_groups(dp._tables, m)
    w, g = packing.make_policy_row_writer(m)
    for ep_id, extra_port in ((101, 443), (103, 8443)):
        extra = PolicyMapState(small[ep_id - 100])
        extra[PolicyKey(identity=0, dest_port=extra_port, nexthdr=6,
                        direction=EGRESS)] = PolicyMapStateEntry(9)
        assert not mgr.sync_endpoint(ep_id, extra, 2)["full_swap"]
    slots = [mgr.slot_of(101), mgr.slot_of(103)]
    rows = [r[slots] for r in mgr.host_mirror()]
    before = dp.pack_stats()["row-writes"]
    assert dp.refresh_policy(2) is False
    assert dp.pack_stats()["row-writes"] == before + 2
    w(bufs[g], torch.as_tensor(np.array(slots)),
      *(torch.as_tensor(r) for r in rows))
    views = packing.unpacker(m)(bufs)
    for f in ("key_id", "key_meta", "value"):
        torch.testing.assert_close(getattr(views.datapath, f),
                                   getattr(dp._tables.datapath, f),
                                   rtol=0, atol=0)


def test_l7_prog_row_writer_equals_the_reference():
    ref, port = ENGINES["l7-threat"]()
    m_ref = ref_packing.build_manifest(ref._tables)
    m = packing.build_manifest(port._tables)
    w_ref, g_ref = ref_packing.make_l7_prog_row_writer(m_ref)
    w, g = packing.make_l7_prog_row_writer(m)
    assert g == g_ref
    bufs_ref = ref_packing.pack_groups(ref._tables, m_ref)
    bufs = packing.pack_groups(port._tables, m)
    n_slots = m.leaf("l7_prog").shape[1]
    rows = np.random.default_rng(5).integers(
        -1, 3, (3, n_slots)).astype(np.int32)
    slots = np.array([3, 1, 0], np.int32)
    want = w_ref(bufs_ref[g_ref], jnp.asarray(slots), jnp.asarray(rows))
    w(bufs[g], torch.as_tensor(slots), torch.as_tensor(rows))
    np.testing.assert_array_equal(bufs[g].numpy(), np.asarray(want))
    # no L7 stage: no l7_prog leaf, no writer
    _r, plain = _plain4()
    assert packing.make_l7_prog_row_writer(
        packing.build_manifest(plain._tables)) is None


@pytest.mark.parametrize("path,family6", [
    ("ep_identity", False), ("pf_value", False), ("router_ip6", True),
    ("tm_cfg", False), ("l7_accept", True)])
def test_write_leaf_equals_the_reference(path, family6):
    ref, port = ENGINES["l7-threat"]()
    t_ref, t = _tables(ref, family6), _tables(port, family6)
    m_ref, m = ref_packing.build_manifest(t_ref), \
        packing.build_manifest(t)
    bufs_ref = ref_packing.pack_groups(t_ref, m_ref)
    bufs = packing.pack_groups(t, m)
    leaf = m.leaf(path)
    arr = (np.arange(leaf.size, dtype=np.int32) * 7 - 3).reshape(
        leaf.shape)
    want = ref_packing.write_leaf(m_ref, bufs_ref, path, jnp.asarray(arr))
    got = packing.write_leaf(m, bufs, path, arr)
    assert got is not None
    assert all(a is b for a, b in zip(got, bufs))  # in place
    for b, r in zip(got, want):
        np.testing.assert_array_equal(b.numpy(), np.asarray(r))
    # a changed shape or an absent leaf: None, the caller rebuilds
    wider = np.zeros((leaf.size + 1,), np.int32)
    assert packing.write_leaf(m, bufs, path, wider) is None
    assert ref_packing.write_leaf(m_ref, bufs_ref, path,
                                  jnp.asarray(wider)) is None
    assert packing.write_leaf(m, bufs, "nonsense", arr) is None


def test_dtype_names_follow_numpy():
    """One table names every dtype the manifests hold the way the
    reference (numpy) does; an unmapped dtype is refused, never
    guessed."""
    for dt, name in packing.DTYPE_NAMES.items():
        assert str(torch.zeros(1, dtype=dt).numpy().dtype) == name
        assert packing.dtype_name(torch.zeros(1, dtype=dt)) == name
    for which in sorted(ENGINES):
        _r, p = ENGINES[which]()
        for tables in (p._tables, p._tables6):
            if tables is None:
                continue
            for path, leaf in packing._walk(tables):
                assert leaf.dtype in packing.DTYPE_NAMES, (which, path)
    for dt in (torch.int64, torch.uint8, torch.float32, torch.complex64):
        with pytest.raises(KeyError):
            packing.dtype_name(torch.zeros(1, dtype=dt))


def test_group_constants_equal_the_reference():
    for name in ("CT_STATE_GROUP", "COUNTERS_GROUP", "FLOW_STATE_GROUP",
                 "L7_DFA_GROUP", "THREAT_MODEL_GROUP", "THREAT_STATE_GROUP",
                 "ANALYTICS_STATE_GROUP", "_L7_DFA_LEAVES",
                 "_THREAT_MODEL_LEAVES", "_POLICY_ROWS"):
        assert getattr(packing, name) == getattr(ref_packing, name), name


@pytest.mark.parametrize("which", ["v4", "l7-threat"])
def test_step_on_unpacked_views_equals_the_step(which):
    """Two port engines over the same tables, one stepping on the
    unpacked views of the packed buffers: equal outputs, CT and
    counters after the same batches."""
    _r, a = ENGINES[which]()
    _r, b = ENGINES[which]()
    m = packing.build_manifest(b._tables)
    b._tables = packing.unpacker(m)(packing.pack_groups(b._tables, m))
    st = v4_serving_state(**SMALL)
    stream = v4_serving_packets(st, 1024, n_flows=2048)
    for k in range(3):
        packed = torch.as_tensor(next(stream))
        out_a = a.process_packed(packed, now=1_000_000 + k)
        out_b = b.process_packed(packed, now=1_000_000 + k)
        for x, y in zip(out_a[:3], out_b[:3]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        for f in out_a[3]._fields:
            torch.testing.assert_close(getattr(out_a[3], f),
                                       getattr(out_b[3], f),
                                       rtol=0, atol=0)
    # the real slots and the sentinel, as ``snapshot`` keeps them: the
    # discard slot after them takes every dropped write in no set order
    n = a.ct.slots + 1
    torch.testing.assert_close(a.ct.state[:, :n], b.ct.state[:, :n],
                               rtol=0, atol=0)
    torch.testing.assert_close(a.counters.packets, b.counters.packets,
                               rtol=0, atol=0)
    assert (out_a[0] >= 0).any() and (out_a[0] < 0).any()
