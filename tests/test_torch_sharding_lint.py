"""The port's mesh, placement registry and sharded device functions
against the JAX package, on the CPU.

- ``parallel/specs.py``: every leaf of the port's table classes (and of
  its CT state's field rows) has a declared placement, no entry names a
  leaf that does not exist, and where a leaf name is the reference's,
  its spec equals the reference's (as axis tuples).
- ``parallel/mesh.py``: ``make_mesh``'s over-provision and divisibility
  refusals, ``ep_submesh``'s bounds, and ``shard_batch`` splitting only
  [B]-leading tensors.
- ``ops/dfa_parallel.dfa_scan_sharded`` against the JAX function over
  the eight virtual CPU devices, and ``hubble/aggregation.place_sharded``
  with ``flow_update_step`` against ``aggregate_oracle`` and the JAX
  function on a batch-sharded mesh (tolerance 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.compiler.regexc import compile_regex_set as ref_compile
from cilium_tpu.hubble import aggregation as ref_agg
from cilium_tpu.ops import dfa_ops as ref_ops
from cilium_tpu.ops import dfa_parallel as ref_par
from cilium_tpu.parallel import mesh as ref_mesh
from cilium_tpu.parallel import specs as ref_specs

from cilium_tpu_torch.compiler.regexc import compile_regex_set
from cilium_tpu_torch.hubble import aggregation as agg
from cilium_tpu_torch.ops import dfa_ops
from cilium_tpu_torch.ops.dfa_parallel import dfa_scan_sharded
from cilium_tpu_torch.parallel import specs
from cilium_tpu_torch.parallel.mesh import (DP_AXIS, EP_AXIS, BatchShards,
                                            Mesh, PartitionSpec,
                                            batch_sharding, ep_submesh,
                                            make_mesh, packed_batch_sharding,
                                            replicate, shard_batch,
                                            table_sharding)

CPU = torch.device("cpu")


def _nested():
    from cilium_tpu_torch.datapath.lb import LB6Tables, LBTables
    from cilium_tpu_torch.datapath.pipeline import DatapathTables, LPM6Tables
    return {"FullTables": {"datapath": DatapathTables, "lb": LBTables},
            "FullTables6": {"ipcache6": LPM6Tables, "pf6": LPM6Tables,
                            "lb6": LB6Tables}}


# ------------------------------------------------------------- the registry

def test_every_table_leaf_has_a_declared_spec():
    assert specs.missing_specs() == {}


def test_no_stale_spec_entries():
    stale = {}
    for cls, table in specs._table_classes().items():
        paths = set(specs.leaf_paths(cls, _nested().get(cls.__name__, {})))
        extra = sorted(set(table) - paths)
        if extra:
            stale[cls.__name__] = extra
    assert stale == {}


@pytest.mark.parametrize("name", sorted(ref_specs.registry()))
def test_registry_equals_the_reference(name):
    """Same classes, and every leaf the reference names has the
    reference's spec; a leaf the port's class lacks is named."""
    mine = specs.registry()[name]
    theirs = ref_specs.registry()[name]
    assert sorted(mine) == sorted(theirs)
    for leaf, spec in theirs.items():
        assert tuple(mine[leaf]) == tuple(spec), leaf


def test_ct_state_rows_are_the_reference_fields():
    from cilium_tpu.datapath.conntrack import CTState as RefCTState
    from cilium_tpu_torch.datapath.conntrack import FIELDS
    assert tuple(FIELDS) == RefCTState._fields
    assert specs.CT_STATE_SPECS == {f: specs.SHARD_LOCAL for f in FIELDS}


def test_packed_groups_kept_as_data():
    assert {k: tuple(v) for k, v in specs.PACKED_GROUP_SPECS.items()} == \
        {k: tuple(v) for k, v in ref_specs.PACKED_GROUP_SPECS.items()}


def test_specs_are_partition_specs_over_known_axes():
    for name, table in specs.registry().items():
        for leaf, spec in table.items():
            assert isinstance(spec, PartitionSpec), (name, leaf)
            for axis in spec:
                assert axis in (None, DP_AXIS, EP_AXIS), (name, leaf)


def test_policy_tables_shard_endpoint_axis():
    full = specs.FULL_TABLES_SPECS
    for leaf in ("datapath.key_id", "datapath.key_meta", "datapath.value"):
        assert full[leaf] == specs.EP_ROWS
    assert full["ep_identity"] == specs.EP_VEC
    for table in (specs.CT_STATE_SPECS, specs.FLOW_STATE_SPECS,
                  specs.COUNTERS_SPECS, specs.THREAT_STATE_SPECS,
                  specs.ANALYTICS_STATE_SPECS):
        assert set(table.values()) == {specs.SHARD_LOCAL}


# ------------------------------------------------------------------ the mesh

def test_make_mesh_refusals_match_the_reference():
    n = len(jax.devices())
    devices = [CPU] * n
    for kw in ({"n_devices": n + 1},
               {"n_devices": n, "ep_parallel": 3 if n % 3 else n + 1},
               {"ep_parallel": 0}):
        with pytest.raises(ValueError) as mine:
            make_mesh(devices=devices, **kw)
        with pytest.raises(ValueError) as theirs:
            ref_mesh.make_mesh(**kw)
        assert str(mine.value) == str(theirs.value)


def test_make_mesh_finds_no_cuda_devices_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ValueError, match="no devices"):
        make_mesh()


@pytest.mark.parametrize("ep", [1, 2, 4, 8])
def test_mesh_geometry_matches_the_reference(ep):
    mine = make_mesh(devices=[CPU] * 8, ep_parallel=ep)
    theirs = ref_mesh.make_mesh(ep_parallel=ep)
    assert mine.devices.shape == theirs.devices.shape
    assert dict(mine.shape) == dict(theirs.shape)
    for k in range(ep):
        assert ep_submesh(mine, k).devices.shape == \
            ep_submesh(theirs, k).devices.shape
    with pytest.raises(ValueError):
        ep_submesh(mine, ep)


def test_named_shardings_carry_the_reference_specs():
    mine = make_mesh(devices=[CPU] * 8, ep_parallel=4)
    theirs = ref_mesh.make_mesh(ep_parallel=4)
    for fn, ref_fn in ((batch_sharding, ref_mesh.batch_sharding),
                       (packed_batch_sharding,
                        ref_mesh.packed_batch_sharding),
                       (table_sharding, ref_mesh.table_sharding),
                       (replicate, ref_mesh.replicate)):
        assert tuple(fn(mine).spec) == tuple(ref_fn(theirs).spec)
        assert fn(mine).mesh is mine


def test_shard_batch_places_only_batch_leading_leaves():
    mesh = make_mesh(devices=[CPU] * 8)     # all devices on dp
    dp = mesh.devices.shape[0]
    b = dp * 4
    tree = {"pkt": torch.arange(b * 3).reshape(b, 3),
            "vec": torch.arange(b),
            "table": torch.zeros((b + 1, 5)),
            "scalar": torch.tensor(7)}
    placed = shard_batch(mesh, tree, batch=b)
    for leaf in ("pkt", "vec"):
        assert isinstance(placed[leaf], BatchShards)
        assert len(placed[leaf]) == dp
        assert placed[leaf].spec == PartitionSpec(DP_AXIS)
        assert all(c.device == CPU for c in placed[leaf])
        assert torch.equal(torch.cat(placed[leaf]), tree[leaf])
    # not [B]-leading: whole, never sliced along the wrong axis
    assert torch.equal(placed["table"], tree["table"])
    assert torch.equal(placed["scalar"], tree["scalar"])
    # B inferred from the first tensor; a B that does not divide across
    # dp splits nothing
    assert isinstance(shard_batch(mesh, tree)["pkt"], BatchShards)
    odd = shard_batch(mesh, {"v": torch.arange(dp + 1)})
    assert not isinstance(odd["v"], BatchShards)


def test_mesh_rejects_a_flat_device_list():
    with pytest.raises(ValueError):
        Mesh(np.array([CPU, CPU], dtype=object))


# ------------------------------------------------------- dfa_scan_sharded

REGEXES = ["GET", "/public.*", "/api/v[0-9]+/.*", ".*admin.*", "POST|PUT"]
LONG = ["/api/v2/" + "x" * 100, "/public/" + "y" * 40, "no-match" * 12,
        "GET", "", "/admin/" + "z" * 90]


@pytest.mark.parametrize("axis,ep", [("dp", 1), ("dp", 2), ("ep", 4)])
def test_dfa_scan_sharded_against_jax(axis, ep):
    """The payload axis split over 8, 4 or 2 devices: the port's final
    states equal JAX's ``dfa_scan_sharded`` over the virtual devices and
    the serial scan, bit for bit."""
    compiled = compile_regex_set(REGEXES)
    ref_c = ref_compile(REGEXES)
    np.testing.assert_array_equal(compiled.table, ref_c.table)
    mine = make_mesh(devices=[CPU] * 8, ep_parallel=ep)
    theirs = ref_mesh.make_mesh(ep_parallel=ep)
    seq_len = 16 * 8
    data = ref_ops.encode_strings(LONG, seq_len)
    b = data.shape[0]
    states = np.broadcast_to(compiled.starts[None, :],
                             (b, compiled.starts.shape[0])).astype(np.int32)
    want = np.asarray(ref_par.dfa_scan_sharded(
        jnp.asarray(ref_c.table), jnp.asarray(states), jnp.asarray(data),
        theirs, axis))
    got = dfa_scan_sharded(torch.as_tensor(compiled.table),
                           torch.as_tensor(states), torch.as_tensor(data),
                           mine, axis)
    np.testing.assert_array_equal(got.numpy(), want)
    serial = dfa_ops.dfa_scan(torch.as_tensor(compiled.table),
                              torch.as_tensor(states),
                              torch.as_tensor(data))
    np.testing.assert_array_equal(got.numpy(), serial.numpy())


def test_dfa_scan_sharded_refuses_an_indivisible_payload():
    compiled = compile_regex_set(REGEXES)
    mesh = make_mesh(devices=[CPU] * 8)
    data = torch.full((1, 12), -1, dtype=torch.int32)
    states = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        dfa_scan_sharded(torch.as_tensor(compiled.table), states, data,
                         mesh, "dp")


# ------------------------------------------------------------ place_sharded

def test_place_sharded_flow_update_matches_oracle_and_jax():
    """The flow table placed on the mesh and one whole step over the
    batch: the aggregates equal ``aggregate_oracle`` and the JAX step
    over the replicated table with batch-sharded inputs."""
    rng = np.random.default_rng(5)
    b = 1024
    src = rng.integers(256, 270, b).astype(np.int32)
    dst = rng.integers(256, 270, b).astype(np.int32)
    dport = rng.integers(1, 4, b).astype(np.int32) * 100
    proto = np.full(b, 6, np.int32)
    event = np.zeros(b, np.int32)
    length = np.full(b, 64, np.int32)
    slots = 1 << 12
    mesh = make_mesh(devices=[CPU] * 8)
    state = agg.place_sharded(agg.make_flow_state(slots, CPU), mesh)
    assert all(t.device == CPU for t in state)
    args = [torch.as_tensor(a) for a in (src, dst, dport, proto, event,
                                         length)]
    state = agg.flow_update_step(state, *args,
                                 torch.tensor(7, dtype=torch.int32),
                                 slots=slots, max_probe=8, ls_stripe=1)
    ft = agg.FlowTable(slots=slots, max_probe=8, ls_stripe=1, device=CPU)
    ft.state = state
    got = agg.snapshot_to_oracle_form(ft.snapshot())
    assert got == agg.aggregate_oracle(src, dst, dport, proto, event,
                                       length, 7)

    jmesh = ref_mesh.make_mesh()
    jstate = ref_agg.place_sharded(ref_agg.make_flow_state(slots), jmesh)
    sh = ref_mesh.batch_sharding(jmesh)
    jargs = [jax.device_put(jnp.asarray(a), sh)
             for a in (src, dst, dport, proto, event, length)]
    step = jax.jit(functools.partial(ref_agg.flow_update_step, slots=slots,
                                     max_probe=8, ls_stripe=1))
    jstate = step(jstate, *jargs, jnp.int32(7))
    jft = ref_agg.FlowTable(slots=slots, max_probe=8, ls_stripe=1)
    jft.state = jstate
    assert got == ref_agg.snapshot_to_oracle_form(jft.snapshot())
