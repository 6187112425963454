"""Inline threat scoring: the JAX package's stage and engine vs the
port's, on the CPU, at tolerance 0.

The stage alone (``threat/stage.threat_stage``) over four batches with
its state carried, in the cases that reach every part of it; the model,
its config and ``log_bucket`` over its whole clamped range; both family
steps through ``Datapath`` in shadow and enforce mode with the flow
table and provenance on; a config flip and a weight swap without a
rebuild; the trainer.  Inputs come from numpy seeds; both packages get
the same model (``convert.threat_model_from_tables``) and, mid-stream,
the same state (``convert.threat_state_from_jax``).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.hubble.aggregation import FlowTable as RefFlowTable
from cilium_tpu.threat import model as ref_model
from cilium_tpu.threat import stage as ref_stage
from cilium_tpu.threat import trainer as ref_trainer

from cilium_tpu_torch import convert
from cilium_tpu_torch.datapath import engine, events
from cilium_tpu_torch.threat import model, oracle, stage, trainer
from cilium_tpu_torch.workloads import (THREAT, threat_enforce_config,
                                        unpack6, v4_serving_packets,
                                        v6_serving_packets)

from test_torch_full_datapath6 import _cols6
from test_torch_full_datapath6 import _load_ref as _load_ref6
from test_torch_full_datapath6 import assert_same, serving6  # noqa: F401

BUCKETS = 64
FLOW_SLOTS = 256
CT_SLOTS = 1 << 10
BATCH = 1024
T0 = 1_000_000
# the reference's enforce test config: a bucket of 4 tokens at 2/s runs
# dry within a batch, so the rate-limit arm drops
DRY_CFG = dict(mode="enforce", drop_score=235, ratelimit_score=150,
               rate_per_s=2.0, burst=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _models(cfg=None, hidden=0, seed=0):
    """(reference model, port model) with the same tables: the default
    scorer, or a random two-layer one of ``hidden`` units."""
    config = ref_model.ThreatConfig(**(cfg or {}))
    if hidden:
        rng = np.random.default_rng(seed)
        ref = ref_model.ThreatModel(
            w1=rng.integers(-200, 400, (ref_model.NUM_FEATURES, hidden)),
            b1=rng.integers(-50, 50, hidden),
            w2=rng.integers(-100, 300, hidden), b2=7, config=config)
    else:
        ref = ref_model.default_model(config)
    return ref, convert.threat_model_from_tables(ref.tables())


def test_model_tables_and_config_equal_reference():
    """Both packages' model tables, config codec and host scorer agree
    array for array, for the default, a linear and a two-layer model."""
    rng = np.random.default_rng(1)
    feats = rng.integers(0, 256, (512, model.NUM_FEATURES))
    weights = rng.normal(0, 200, model.NUM_FEATURES)
    cfg = dict(mode="enforce", drop_score=240, redirect_score=200,
               ratelimit_score=150, redirect_port=15003,
               rate_per_s=1e5, burst=1 << 16, generation=4)
    pairs = [_models(cfg), _models(cfg, hidden=5, seed=2),
             (ref_model.linear_model(weights, 3.5),
              model.linear_model(weights, 3.5))]
    for ref, port in pairs:
        for name, arr in ref.tables().items():
            np.testing.assert_array_equal(arr, port.tables()[name], name)
        np.testing.assert_array_equal(ref.score(feats), port.score(feats))
        # the port's model carries the config its table encodes
        assert port.describe() == ref.with_config(
            ref_model.ThreatConfig.decode(ref.config.encode())).describe()
    assert model.FEATURES == ref_model.FEATURES
    for buckets in (2, 64, 1024):
        np.testing.assert_array_equal(
            stage.make_threat_state(buckets, device="cpu").state.numpy(),
            np.asarray(ref_stage.make_threat_state(buckets).state))
    with pytest.raises(ValueError, match="power of 2"):
        stage.make_threat_state(100, device="cpu")


def test_log_bucket_matches_reference_over_clamped_range():
    """``log_bucket`` (``torch.frexp``) equals the reference's and the
    oracle's on every int in [-8, LOG_CLAMP + 8] and at the int32 ends."""
    x = np.r_[np.arange(-8, stage.LOG_CLAMP + 9),
              [np.iinfo(np.int32).min, np.iinfo(np.int32).max]] \
        .astype(np.int32)
    got = stage.log_bucket(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_stage.log_bucket(jnp.asarray(x))))
    np.testing.assert_array_equal(got, oracle.log_bucket_np(x))
    assert got.min() == 0 and got.max() == 16


# ---------------------------------------------------------------------------
# The stage alone
# ---------------------------------------------------------------------------

# name: (model config, stripe, identities, flows, exempt share)
STAGE_CASES = {
    "shadow-stripe1": ({}, 1, 40, True, 0.0),
    "armed-zero-thresholds": (dict(mode="enforce"), 4, 40, True, 0.0),
    "enforce-dry-bucket": (DRY_CFG, 4, 6, True, 0.0),
    "redirect-arm": (dict(mode="enforce", redirect_score=120,
                          redirect_port=15003), 4, 6, False, 0.0),
    "duplicate-buckets-stripe16": (DRY_CFG, 16, 2, True, 0.0),
    "icmp6-exempt": (dict(DRY_CFG, redirect_score=140,
                          redirect_port=9), 4, 6, True, 0.3),
}


def _stage_batch(rng, b, n_ident, sport0):
    ident = (rng.integers(0, n_ident, b) * 37 + 2).astype(np.int32)
    dport = np.where(rng.random(b) < 0.5, rng.integers(1, 65536, b),
                     80).astype(np.int32)
    return dict(
        identity=ident, dport=dport,
        proto=np.where(rng.random(b) < 0.2, 17, 6).astype(np.int32),
        tcp_flags=np.where(rng.random(b) < 0.6, 0x02, 0x10)
        .astype(np.int32),
        length=rng.integers(0, 3000, b).astype(np.int32),
        is_fragment=(rng.random(b) < 0.05).astype(np.int32),
        established=rng.random(b) < 0.3,
        saddr_w=rng.integers(-2 ** 31, 2 ** 31, b).astype(np.int32),
        daddr_w=rng.integers(-2 ** 31, 2 ** 31, b).astype(np.int32),
        sport=(sport0 + np.arange(b)).astype(np.int32),
        flow_src=ident, flow_dst=np.full(b, 60000, np.int32))


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_threat_stage_matches_reference(case, monkeypatch):
    """``threat_stage`` alone, four batches of 512 rows with the state
    carried, against the reference (which takes its score-only branch
    where every threshold is 0, while the port always runs the armed
    one) and the numpy oracle: verdicts, threat_out, the three fired
    masks and the whole state.  Every ``set`` scatter's rows that name
    one state row write equal values."""
    cfg, stripe, n_ident, with_flows, exempt_share = STAGE_CASES[case]
    ref_m, port_m = _models(cfg)
    ref_tabs = SimpleNamespace(**{k: jnp.asarray(v) for k, v in
                                  ref_m.tables().items()})
    port_tabs = SimpleNamespace(**{k: torch.as_tensor(v) for k, v in
                                   port_m.tables().items()})
    rng = np.random.default_rng(100 + list(STAGE_CASES).index(case))
    b = 512
    ref_state = ref_stage.make_threat_state(BUCKETS)
    port_state = stage.make_threat_state(BUCKETS, device="cpu")
    mirror = np.zeros((BUCKETS + 1, stage.STATE_COLS), np.int32)
    ref_flows = port_flows = flow_index = None
    if with_flows:
        table = RefFlowTable(slots=FLOW_SLOTS, max_probe=8,
                             claim_budget=b)
        seed_batch = _stage_batch(rng, b, n_ident, 20000)
        table.update(seed_batch["flow_src"], seed_batch["flow_dst"],
                     seed_batch["dport"], seed_batch["proto"],
                     np.zeros(b, np.int32), seed_batch["length"], T0 - 3)
        ref_flows = table.state
        port_flows = convert.flows_from_jax(np.asarray(ref_flows.keys),
                                            np.asarray(ref_flows.counters),
                                            device="cpu")
        flow_index = oracle.flow_snapshot_index(table.snapshot())

    writes = []

    def recording_set(state, rows, cols, values):
        writes.append((rows.clone(), values.clone()))
        state[rows[:, None], cols[None, :]] = values
    monkeypatch.setattr(stage, "_set_rows", recording_set)

    fired = np.zeros(3, int)
    for t in range(4):
        # window_s apart every second batch: the expiry boundary
        now = T0 + THREAT["window_s"] // 2 * t
        pk = _stage_batch(rng, b, n_ident, 20000 + (t % 2) * b)
        verdict = np.where(rng.random(b) < 0.7, 0,
                           np.where(rng.random(b) < 0.5, -1, 15001)
                           ).astype(np.int32)
        exempt = rng.random(b) < exempt_share if exempt_share else None
        ref_out = ref_stage.threat_stage(
            ref_tabs, ref_state, ref_flows, jnp.asarray(verdict),
            **{k: jnp.asarray(v) for k, v in pk.items()},
            now=jnp.int32(now), window_s=THREAT["window_s"],
            flow_slots=FLOW_SLOTS if with_flows else 0, flow_probe=8,
            stripe=stripe,
            exempt=None if exempt is None else jnp.asarray(exempt))
        port_out = stage.threat_stage(
            port_tabs, port_state,
            port_flows,
            torch.as_tensor(verdict),
            **{k: torch.as_tensor(v) for k, v in pk.items()},
            now=torch.tensor(now, dtype=torch.int32),
            window_s=THREAT["window_s"],
            flow_slots=FLOW_SLOTS if with_flows else 0, flow_probe=8,
            stripe=stripe,
            exempt=None if exempt is None else torch.as_tensor(exempt))
        want = oracle.oracle_threat_step(
            mirror, port_m, verdict, **pk, now=now,
            window_s=THREAT["window_s"], flow_index=flow_index,
            stripe=stripe, exempt=exempt)
        ref_state = ref_out[1]
        for name, i in (("verdict", 0), ("threat_out", 2),
                        ("thr_drop", 3), ("thr_redir", 4),
                        ("rl_drop", 5)):
            np.testing.assert_array_equal(np.asarray(ref_out[i]),
                                          port_out[i].numpy(), name)
        np.testing.assert_array_equal(port_out[0].numpy(), want[0])
        np.testing.assert_array_equal(port_out[2].numpy(), want[1])
        np.testing.assert_array_equal(np.asarray(ref_state.state),
                                      port_state.state.numpy(), "state")
        np.testing.assert_array_equal(mirror, port_state.state.numpy())
        fired += [int(port_out[i].sum()) for i in (3, 4, 5)]
        if exempt is not None:
            np.testing.assert_array_equal(port_out[0].numpy()[exempt],
                                          verdict[exempt])
    for rows, values in writes:
        for r in torch.unique(rows).tolist():
            if r == BUCKETS:
                continue
            vals = values[rows == r]
            assert (vals == vals[0]).all(), (case, r, vals)
    assert len(writes) == 8
    if case == "armed-zero-thresholds":
        assert fired.sum() == 0
    if case == "enforce-dry-bucket":
        assert fired[0] > 0 and fired[2] > 0, fired
        scores = port_out[2].numpy() & 0xFF
        assert (scores < DRY_CFG["ratelimit_score"] - 1).any()
    if case == "redirect-arm":
        assert fired[1] > 0, fired
    if case.startswith("duplicate"):
        assert fired[2] > 0, fired


# ---------------------------------------------------------------------------
# Both family steps through Datapath
# ---------------------------------------------------------------------------

def _threat_pair(st6, cfg, threat=True, with_ref=True):
    """(reference engine or None, port engine) over the dual-stack
    state, flows and provenance on, the threat stage with ``cfg``."""
    ref = None
    if with_ref:
        ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
        ref.telemetry_enabled = False
        _load_ref6(ref, st6)
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    st6.v4.load(port)
    st6.load(port)
    ref_m, port_m = _models(cfg)
    for dp, m in ((ref, ref_m), (port, port_m)):
        if dp is None:
            continue
        dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=8,
                                   claim_every=1)
        dp.enable_provenance()
        if threat:
            dp.enable_threat(m, buckets=BUCKETS,
                             window_s=THREAT["window_s"],
                             stripe=THREAT["stripe"])
    return ref, port


def _serve(ref, port, kind, packed, now):
    """One step of ``kind`` on both engines (the reference's may be
    None); returns (reference outputs, port outputs)."""
    if kind == "process6":
        outs_port = port.process6(unpack6(torch.as_tensor(packed)),
                                  now=now)
        outs_ref = None if ref is None else ref.process6(
            ref_engine.make_full_batch6(**_cols6(packed)), now=now)
    else:
        outs_port = port.process_packed(torch.as_tensor(packed), now=now)
        outs_ref = None if ref is None else ref.process_packed(
            jnp.asarray(packed), now=now)
    return outs_ref, outs_port


def assert_same_threat(ref, port):
    np.testing.assert_array_equal(np.asarray(ref.threat_state.state),
                                  port.threat_state.state.numpy(),
                                  "threat state")
    np.testing.assert_array_equal(np.asarray(ref.last_threat),
                                  port.last_threat.numpy(), "threat_out")


@pytest.mark.parametrize("mode", ["shadow", "enforce"])
@pytest.mark.parametrize("family", ["v4", "v6"])
def test_steps_with_threat_match_reference(serving6, family, mode):
    """Four steps of one family with the flow table, provenance and the
    threat stage on: every output, CT, flow lane, provenance tier, the
    threat state and threat_out equal the reference's.  After the second
    step the reference's state is carried into the port through
    ``convert``, after the third the port's into the reference.  Shadow
    verdicts, events and tiers equal a threat-free port engine's;
    enforce drops and tiers the rows it fires on (v6: never an ICMPv6
    row the responder answered)."""
    cfg = {} if mode == "shadow" else dict(DRY_CFG, redirect_score=200,
                                           redirect_port=15003)
    ref, port = _threat_pair(serving6, cfg)
    _none, plain = _threat_pair(serving6, cfg, threat=False,
                                with_ref=False)
    kind = "process6" if family == "v6" else "process_packed"
    stream = v6_serving_packets(serving6, BATCH, n_flows=256) \
        if family == "v6" else v4_serving_packets(serving6.v4, BATCH,
                                                  n_flows=256)
    tiers = set()
    for t in range(4):
        packed = next(stream)
        now = T0 + t
        outs_ref, outs_port = _serve(ref, port, kind, packed, now)
        assert_same(ref, port, outs_ref, outs_port)
        assert_same_threat(ref, port)
        tiers.update(port.last_provenance.tier.tolist())
        plain_outs = _serve(None, plain, kind, packed, now)[1]
        if mode == "shadow":
            for a, b in zip(outs_port[:3], plain_outs[:3]):
                assert torch.equal(a, b)
            assert torch.equal(port.last_provenance.tier,
                               plain.last_provenance.tier)
        else:
            fired = (outs_port[0] == -4) | (outs_port[0] == 15003)
            assert torch.equal(outs_port[0][~fired], plain_outs[0][~fired])
            assert torch.equal(outs_port[1] == events.DROP_THREAT,
                               outs_port[0] == -4)
            tier = port.last_provenance.tier
            assert torch.isin(tier[outs_port[0] == -4], torch.tensor(
                [events.TIER_THREAT_DROP,
                 events.TIER_THREAT_RATELIMIT])).all()
            assert (tier[fired & (outs_port[0] == 15003)] ==
                    events.TIER_THREAT_REDIRECT).all()
            if family == "v6":
                icmp = unpack6(torch.as_tensor(packed)).proto == 58
                assert not fired[icmp].any()
        if t == 1:
            port.restore_threat_state(convert.threat_state_from_jax(
                np.asarray(ref.threat_state.state), device="cpu"))
        if t == 2:
            ref.threat_state = ref_stage.ThreatState(state=jnp.asarray(
                convert.threat_state_to_jax(port.threat_state)))
    if mode == "enforce":
        # v4's stream reaches all three arms; v6's at least the drop
        want = {events.TIER_THREAT_DROP, events.TIER_THREAT_RATELIMIT,
                events.TIER_THREAT_REDIRECT} if family == "v4" \
            else {events.TIER_THREAT_DROP}
        assert want <= tiers, tiers
        score, band, fired_bits = stage.unpack_threat_out(port.last_threat)
        r_score, r_band, r_fired = ref_stage.unpack_threat_out(
            ref.last_threat)
        np.testing.assert_array_equal(score, r_score)
        np.testing.assert_array_equal(band, r_band)
        np.testing.assert_array_equal(fired_bits, r_fired)


def test_config_flip_and_weight_swap_without_rebuild(serving6):
    """``set_threat_config`` and a same-geometry ``apply_threat_weights``
    copy into the live tensors (no rebuild, the same storage) and the
    steps after them still equal the reference's; a weight swap of
    another hidden width rebuilds and says so."""
    ref, port = _threat_pair(serving6, {})
    stream = v4_serving_packets(serving6.v4, BATCH, n_flows=256)
    ptrs = {n: getattr(port._tables, n).data_ptr()
            for n in ("tm_w1", "tm_b1", "tm_w2", "tm_b2", "tm_cfg")}
    rebuilds = port.rebuilds
    cfg = ref_model.ThreatConfig(**DRY_CFG)
    ref.set_threat_config(cfg)
    port.set_threat_config(model.ThreatConfig(**DRY_CFG))
    outs = _serve(ref, port, "process_packed", next(stream), T0)
    assert_same(ref, port, *outs)
    assert_same_threat(ref, port)
    trained_ref = ref_trainer.ThreatTrainer(epochs=40).fit(
        ref.flow_snapshot(1 << 10), now=T0, config=cfg)
    trained = convert.threat_model_from_tables(trained_ref.tables())
    assert ref.apply_threat_weights(trained_ref) is True
    assert port.apply_threat_weights(trained) is True
    assert port.rebuilds == rebuilds
    assert ptrs == {n: getattr(port._tables, n).data_ptr() for n in ptrs}
    assert port._tables6.tm_w1 is port._tables.tm_w1
    outs = _serve(ref, port, "process6", next(v6_serving_packets(
        serving6, BATCH, n_flows=256)), T0 + 1)
    assert_same(ref, port, *outs)
    assert_same_threat(ref, port)
    assert port.threat_report()["config"] == \
        ref.threat_report()["config"]
    _ref2, wide = _models(DRY_CFG, hidden=3)
    assert port.apply_threat_weights(wide) is False
    assert port.rebuilds == rebuilds + 1
    port.disable_threat()
    assert port.threat_state is None and port._tables.tm_w1 is None
    with pytest.raises(RuntimeError, match="not enabled"):
        port.set_threat_config(cfg)


def test_trainer_fits_like_reference():
    """The trainer's features and quantized weights equal the
    reference's on one set of flow records."""
    rng = np.random.default_rng(4)
    flows = [{"packets": int(p), "bytes": int(p * rng.integers(40, 1500)),
              "dport": int(rng.integers(1, 65536)),
              "proto": int(rng.choice([6, 17])),
              "last-seen": int(T0 - rng.integers(0, 300)),
              "src-identity": int(rng.choice([2, 300])),
              "dst-identity": 60000,
              "event": int(rng.choice([0, -130]))}
             for p in rng.integers(1, 5000, 300)]
    got = trainer.ThreatTrainer(epochs=60).fit(flows, now=T0)
    want = ref_trainer.ThreatTrainer(epochs=60).fit(flows, now=T0)
    for name, arr in want.tables().items():
        np.testing.assert_array_equal(arr, got.tables()[name], name)
    np.testing.assert_array_equal(
        trainer.features_from_flow(flows[0], T0),
        ref_trainer.features_from_flow(flows[0], T0))
