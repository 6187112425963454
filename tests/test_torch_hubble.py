"""Hubble flow aggregation: the JAX package's ``flow_update_step`` vs the
port's, on the CPU.

Both start from one empty (or one handed-over) flow table and take the
same batches; after every batch every lane of the keys (src, dst, meta,
last-seen, the sentinel row and the (lost, updates) row) and both
counter lanes must be equal bit for bit (tolerance 0).  The cases reach
same-slot claim races in crowded tables, the per-batch claim budget,
probe-window exhaustion counted in ``lost``, uint32 byte wrap, the
striped last-seen refresh at several phases, an ``active`` mask and
the claim-free variant.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.hubble import aggregation as ref_agg

from cilium_tpu_torch import convert
from cilium_tpu_torch.hubble import aggregation as agg

# name: (slots, max_probe, claim_budget, ls_stripe, batch, batches,
#        distinct sources x destinations, length range, active share)
CASES = {
    "crowded-probe2-races": (16, 2, 64, 4, 256, 5, (6, 6), (40, 1500), 1.0),
    "crowded-probe3-races": (32, 3, 128, 4, 512, 5, (8, 8), (40, 1500), 1.0),
    "crowded-probe4-races": (64, 4, 1024, 4, 1024, 5, (12, 12), (40, 1500),
                             1.0),
    "budget-overflow": (1024, 8, 8, 4, 512, 5, (40, 40), (40, 1500), 1.0),
    "exhaustion-lost": (8, 3, 1024, 4, 300, 4, (10, 10), (40, 1500), 1.0),
    "uint32-byte-wrap": (64, 8, 1024, 1, 400, 4, (2, 2),
                         (2 ** 30, 2 ** 31), 1.0),
    "stripe1": (256, 8, 1024, 1, 500, 5, (6, 6), (40, 1500), 1.0),
    "stripe4-phases": (256, 8, 1024, 4, 512, 8, (6, 6), (40, 1500), 1.0),
    "stripe4-ragged-batch": (256, 8, 1024, 4, 250, 4, (6, 6), (40, 1500),
                             1.0),
    "stripe4-batch-below-stripe": (64, 8, 1024, 4, 3, 6, (2, 2), (40, 1500),
                                   1.0),
    "active-mask": (64, 4, 64, 4, 512, 5, (8, 8), (40, 1500), 0.7),
    "budget0": (64, 8, 0, 4, 256, 3, (4, 4), (40, 1500), 1.0),
}


def _batch(rng, batch, n_src, n_dst, lengths, active_share,
           narrow=False):
    """Flow-key columns over ``n_src`` x ``n_dst`` identities (a tenth
    of the destinations >= 2**31) and mixed ports, protos and events;
    ``narrow`` keeps to TCP, two events and no wide destinations."""
    src = rng.integers(256, 256 + n_src, batch)
    dst = rng.integers(4096, 4096 + n_dst, batch)
    if not narrow:
        dst = np.where(rng.random(batch) < 0.1,
                       rng.integers(2 ** 31, 2 ** 32, batch), dst)
    cols = [src, dst, rng.choice([80, 443, 40000, 65535], batch),
            rng.choice([6] if narrow else [6, 17, 58], batch),
            rng.choice([0, -130] if narrow else [0, 1, 4, 5, -130, -133,
                                                 -136], batch),
            rng.integers(*lengths, batch)]
    cols = [np.asarray(c, np.int64).astype(np.uint32).view(np.int32)
            for c in cols]
    active = None if active_share >= 1.0 else \
        rng.random(batch) < active_share
    return cols, active


@functools.lru_cache(maxsize=None)
def _ref_step(**statics):
    return jax.jit(functools.partial(ref_agg.flow_update_step, **statics))


def _step_both(ref, port, cols, active, now, **statics):
    ref = _ref_step(**statics)(
        ref, *[jnp.asarray(c) for c in cols], jnp.int32(now),
        None if active is None else jnp.asarray(active))
    port = agg.flow_update_step(
        port, *[torch.as_tensor(c) for c in cols],
        torch.tensor(now, dtype=torch.int32),
        None if active is None else torch.as_tensor(active), **statics)
    return ref, port


def assert_same_flows(ref, port):
    np.testing.assert_array_equal(np.asarray(ref.keys), port.keys.numpy(),
                                  "keys")
    np.testing.assert_array_equal(np.asarray(ref.counters).view(np.int32),
                                  port.counters.numpy(), "counters")


@pytest.mark.parametrize("case", list(CASES))
def test_flow_update_step_matches_reference(case):
    slots, probe, budget, stripe, batch, batches, (n_src, n_dst), \
        lengths, active_share = CASES[case]
    statics = dict(slots=slots, max_probe=probe, claim_budget=budget,
                   ls_stripe=stripe)
    rng = np.random.default_rng(sum(map(ord, case)))
    ref = ref_agg.make_flow_state(slots)
    port = agg.make_flow_state(slots, device="cpu")
    for t in range(batches):
        cols, active = _batch(rng, batch, n_src, n_dst, lengths,
                              active_share)
        ref, port = _step_both(ref, port, cols, active, 1001 + 3 * t,
                               **statics)
        assert_same_flows(ref, port)
    keys = port.keys.numpy()
    lost, updates = keys[slots + 1, :2]
    occupied = int((keys[:slots, 2] != 0).sum())
    # each case reaches what it is named for
    if case.startswith(("crowded", "exhaustion")):
        assert occupied >= slots - 2 and lost > 0
    if case == "budget-overflow":
        assert 0 < occupied <= budget * batches and lost > 0
    if case == "budget0":
        assert occupied == 0 and lost == updates
    if case == "uint32-byte-wrap":
        total = int(port.counters.numpy().view(np.uint32)[:slots, 1]
                    .astype(np.int64).sum())
        assert total < batches * batch * 2 ** 30  # wrapped
    if case == "active-mask":
        assert updates < batches * batch
    else:
        assert updates == batches * batch
    assert not keys[slots].any()


def test_flow_table_snapshot_stats_and_oracle():
    """``FlowTable`` update / snapshot / stats / reset equal the
    reference's; at stripe 1 with room for every flow the snapshot
    equals ``aggregate_oracle`` over the batches, merged."""
    ref = ref_agg.FlowTable(slots=4096, max_probe=8, ls_stripe=1)
    port = agg.FlowTable(slots=4096, max_probe=8, ls_stripe=1,
                         device="cpu")
    rng = np.random.default_rng(4)
    want = {}
    for t in range(4):
        cols, _ = _batch(rng, 600, 8, 8, (40, 2 ** 31), 1.0, narrow=True)
        assert ref.update(*cols, now=2000 + t) == \
            port.update(*cols, now=2000 + t)
        assert_same_flows(ref.state, port.state)
        for key, (p, b, ls) in agg.aggregate_oracle(
                *cols, now=2000 + t).items():
            p0, b0, _ = want.get(key, (0, 0, 0))
            want[key] = ((p0 + p) & 0xFFFFFFFF, (b0 + b) & 0xFFFFFFFF, ls)
        assert agg.aggregate_oracle(*cols, now=1) == \
            ref_agg.aggregate_oracle(*cols, now=1)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert agg.snapshot_to_oracle_form(snap) == want
    assert port.stats() == ref.stats() and port.lost == 0
    assert (port.lost, port.updates, port.entry_count()) == \
        (ref.lost, ref.updates, ref.entry_count())
    assert port.snapshot(max_entries=5) == ref.snapshot(max_entries=5)
    port.reset()
    ref.reset()
    assert_same_flows(ref.state, port.state)
    with pytest.raises(ValueError, match="power of two"):
        agg.FlowTable(slots=1000, device="cpu")


def test_flows_from_jax_round_trip():
    """A reference flow table carries into the port and back, and the
    next batch agrees on the carried state."""
    statics = dict(slots=64, max_probe=4, claim_budget=32, ls_stripe=4)
    rng = np.random.default_rng(8)
    ref = ref_agg.make_flow_state(64)
    for t in range(3):
        cols, _ = _batch(rng, 256, 8, 8, (2 ** 30, 2 ** 31), 1.0)
        ref = _ref_step(**statics)(
            ref, *[jnp.asarray(c) for c in cols], jnp.int32(500 + t), None)
    port = convert.flows_from_jax(np.asarray(ref.keys),
                                  np.asarray(ref.counters), device="cpu")
    assert_same_flows(ref, port)
    keys, counters = convert.flows_to_jax(port)
    assert counters.dtype == np.uint32
    np.testing.assert_array_equal(keys, np.asarray(ref.keys))
    np.testing.assert_array_equal(counters, np.asarray(ref.counters))
    cols, active = _batch(rng, 256, 8, 8, (40, 1500), 0.5)
    ref, port = _step_both(ref, port, cols, active, 600, **statics)
    assert_same_flows(ref, port)
    back = ref_agg.FlowState(*map(jnp.asarray, convert.flows_to_jax(port)))
    assert_same_flows(back, port)
    with pytest.raises(ValueError, match="keys"):
        convert.flows_from_jax(np.zeros((8, 4), np.int64),
                               np.zeros((7, 2), np.uint32), device="cpu")
