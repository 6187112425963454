"""Device-resident traffic analytics: the JAX package's stage and engine
vs the port's, on the CPU, at tolerance 0.

The stage alone (``analytics/stage.analytics_stage``) over four batches
with its buffer carried and an epoch swap between them, against the
reference and the port's numpy oracle; the buffer geometry and the
sketch keys; both family steps through ``Datapath`` with the flow table
and provenance on, an epoch swap between steps (two writes, no
rebuild), the buffer carried from the reference mid-stream
(``convert.analytics_state_from_jax``), and the host decode views of the
quiesced section equal across packages.  Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.analytics import decode as ref_decode
from cilium_tpu.analytics import stage as ref_stage

from cilium_tpu_torch import convert
from cilium_tpu_torch.analytics import decode, oracle, stage
from cilium_tpu_torch.datapath import engine

from test_torch_full_datapath6 import _load_ref as _load_ref6
from test_torch_full_datapath6 import assert_same, serving6  # noqa: F401
from test_torch_threat import _serve
from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu_torch.workloads import v4_serving_packets, v6_serving_packets

WIDTH, DEPTH, LANES = 256, 2, 4
CT_SLOTS = 1 << 10
FLOW_SLOTS = 256
BATCH = 512
T0 = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_geometry_and_keys_equal_reference():
    """Row geometry, salts, the fresh buffer and the sketch keys (int32
    edges included) equal the reference's."""
    for depth, lanes in ((1, 1), (2, 4), (3, 8)):
        assert stage.epoch_rows(depth, lanes) == \
            ref_stage.epoch_rows(depth, lanes)
        assert stage.ctrl_row(depth, lanes) == \
            ref_stage.ctrl_row(depth, lanes)
        for k in range(stage.N_KEYSPACES):
            assert stage.keytab_row(k, depth) == \
                ref_stage.keytab_row(k, depth)
            assert stage.keytab_salt(k) == ref_stage.keytab_salt(k)
            for m in range(stage.N_METRICS):
                for d in range(depth):
                    assert stage.sketch_row(k, m, d, depth) == \
                        ref_stage.sketch_row(k, m, d, depth)
                    assert stage.sketch_salt(k, d) == \
                        ref_stage.sketch_salt(k, d)
        for lane in range(lanes):
            assert stage.reg_row(lane, depth) == \
                ref_stage.reg_row(lane, depth)
        assert tuple(stage.make_analytics_state(
            WIDTH, depth, lanes, device="cpu").state.shape) == \
            ref_stage.make_analytics_state(WIDTH, depth, lanes).state.shape
    rng = np.random.default_rng(5)
    cols = [np.r_[rng.integers(-2 ** 31, 2 ** 31, 500),
                  [-2 ** 31, 2 ** 31 - 1, 0, -1]].astype(np.int32)
            for _ in range(3)]
    got = stage.flow_hash_keys(*map(torch.as_tensor, cols))
    want = ref_stage.flow_hash_keys(*map(jnp.asarray, cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="power of 2"):
        stage.make_analytics_state(100, device="cpu")


def _stage_batch(rng, b):
    ident = (rng.integers(0, 24, b) * 977 + 2).astype(np.int32)
    return dict(
        identity=ident,
        dport=np.where(rng.random(b) < 0.3, rng.integers(1, 65536, b),
                       443).astype(np.int32),
        proto=np.where(rng.random(b) < 0.2, 17, 6).astype(np.int32),
        sport=rng.integers(1024, 65536, b).astype(np.int32),
        length=rng.integers(40, 1500, b).astype(np.int32),
        verdict=np.where(rng.random(b) < 0.3, -1,
                         np.where(rng.random(b) < 0.1, -4, 0))
        .astype(np.int32),
        saddr_key=rng.integers(-2 ** 31, 2 ** 31, b).astype(np.int32),
        daddr_key=(rng.integers(0, 64, b) * 256 + (10 << 24) +
                   rng.integers(0, 256, b)).astype(np.int32))


@pytest.mark.parametrize("stripe", [1, 16])
def test_analytics_stage_matches_reference(stripe):
    """``analytics_stage`` alone, four batches of 4,096 rows on one
    carried buffer, an epoch swap (the oracle's) after the second: the
    whole buffer equals the reference's and the port's oracle's after
    every batch, and the second epoch's section received the last two
    batches only."""
    rng = np.random.default_rng(30 + stripe)
    b = 4096
    mirror = np.zeros((stage.total_rows(DEPTH, LANES), WIDTH), np.int32)
    port = stage.AnalyticsState(state=torch.as_tensor(mirror.copy()))
    ref = ref_stage.AnalyticsState(state=jnp.asarray(mirror))
    er = stage.epoch_rows(DEPTH, LANES)
    for t in range(4):
        if t == 2:
            assert oracle.oracle_swap_epoch(mirror, DEPTH, LANES) == 0
            port = stage.AnalyticsState(state=torch.as_tensor(
                mirror.copy()))
            ref = ref_stage.AnalyticsState(state=jnp.asarray(mirror))
            assert not mirror[er:2 * er].any()
        now = T0 + 7 * t
        pk = _stage_batch(rng, b)
        ref = ref_stage.analytics_stage(
            ref, **{k: jnp.asarray(v) for k, v in pk.items()},
            now=jnp.int32(now), depth=DEPTH, lanes=LANES, stripe=stripe)
        got = stage.analytics_stage(
            port, **{k: torch.as_tensor(v) for k, v in pk.items()},
            now=torch.tensor(now, dtype=torch.int32), depth=DEPTH,
            lanes=LANES, stripe=stripe)
        assert got is port
        oracle.oracle_analytics_step(mirror, **pk, now=now, depth=DEPTH,
                                     lanes=LANES, stripe=stripe)
        np.testing.assert_array_equal(np.asarray(ref.state),
                                      port.state.numpy())
        np.testing.assert_array_equal(mirror, port.state.numpy())
    assert mirror[:er].any() and mirror[er:2 * er].any()


def _analytics_pair(st6):
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    _load_ref6(ref, st6)
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    st6.v4.load(port)
    st6.load(port)
    for dp in (ref, port):
        dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=8,
                                   claim_every=1)
        dp.enable_provenance()
        dp.enable_analytics(width=WIDTH, depth=DEPTH, lanes=LANES,
                            stripe=4)
    return ref, port


def _views(mod, snap):
    sec = mod.quiesced_section(snap, DEPTH, LANES)
    return {"talkers": mod.top_talkers(sec, DEPTH, k=8),
            "drops": mod.top_talkers(sec, DEPTH, k=8, metric="drops"),
            "scanners": mod.top_scanners(sec, DEPTH, k=8, min_dports=4),
            "prefixes": mod.top_prefixes(sec, DEPTH, k=8),
            "spreaders": mod.top_spreaders(sec, DEPTH, LANES, k=8)}


@pytest.mark.parametrize("family", ["v4", "v6"])
def test_steps_with_analytics_match_reference(serving6, family):
    """Four steps of one family with flows, provenance and analytics
    on: every output and the whole buffer equal the reference's after
    each.  An epoch swap between the second and third step is two
    writes on the port's buffer (no rebuild, the same storage); the
    port's buffer is carried into the reference after the second step
    and the reference's into the port after the third; the
    decode views of the quiesced section equal the reference's."""
    ref, port = _analytics_pair(serving6)
    kind = "process6" if family == "v6" else "process_packed"
    stream = v6_serving_packets(serving6, BATCH, n_flows=256) \
        if family == "v6" else v4_serving_packets(serving6.v4, BATCH,
                                                  n_flows=256)
    for t in range(4):
        if t == 2:
            rebuilds = port.rebuilds
            ptr = port.analytics_state.state.data_ptr()
            assert port.swap_analytics_epoch() == \
                ref.swap_analytics_epoch() == 0
            assert port.rebuilds == rebuilds
            assert port.analytics_state.state.data_ptr() == ptr
            assert port.analytics_report()["write-epoch"] == \
                ref.analytics_report()["write-epoch"] == 1
        outs = _serve(ref, port, kind, next(stream), T0 + t)
        assert_same(ref, port, *outs)
        np.testing.assert_array_equal(np.asarray(ref.analytics_state.state),
                                      port.analytics_state.state.numpy())
        if t == 2:
            port.restore_analytics_state(convert.analytics_state_from_jax(
                np.asarray(ref.analytics_state.state), device="cpu"))
            assert port.analytics_report()["write-epoch"] == 1
        if t == 1:
            ref.analytics_state = ref_stage.AnalyticsState(
                state=jnp.asarray(convert.analytics_state_to_jax(
                    port.analytics_state)))
    snap, ref_snap = port.analytics_snapshot(), ref.analytics_snapshot()
    np.testing.assert_array_equal(snap, ref_snap)
    views = _views(decode, snap)
    assert views == _views(ref_decode, ref_snap)
    assert views["talkers"] and views["prefixes"] and views["spreaders"]
    merged = decode.merge_sections(
        [decode.quiesced_section(snap, DEPTH, LANES)] * 2, DEPTH, LANES)
    np.testing.assert_array_equal(merged, ref_decode.merge_sections(
        [ref_decode.quiesced_section(ref_snap, DEPTH, LANES)] * 2, DEPTH,
        LANES))
    port.disable_analytics()
    assert port.analytics_state is None and port.analytics_report() is None
    with pytest.raises(RuntimeError, match="not enabled"):
        port.swap_analytics_epoch()
