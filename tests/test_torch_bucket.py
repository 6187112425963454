"""The two-choice bucket engine (BASELINE config 2): JAX package vs port.

The same numpy entry arrays and map states go through
``cilium_tpu.compiler.bucket_tables`` / ``ops.bucket_ops`` and through the
port's copies on the CPU.  Built tables, hashes, lookups, verdicts and
counters must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench_suite import _make_policy_tables
from cilium_tpu.compiler import bucket_tables as ref_bt
from cilium_tpu.ops import bucket_ops as ref_ops
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch import convert
from cilium_tpu_torch.compiler import bucket_tables as bt
from cilium_tpu_torch.compiler.policy_tables import oracle_verdict
from cilium_tpu_torch.ops import bucket_ops as ops
from cilium_tpu_torch.workloads import (CONFIG2_FIELDS, Config2Run,
                                        build_config2, config2_packets,
                                        mixed_bucket_packets,
                                        mixed_bucket_states)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the host's cores among several pytest
    workers; small tensors gain nothing from torch's intra-op threads."""
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


def _flat_entries(seed, n_ep=40, per_ep=30):
    """Flat entry arrays with full-range uint32 key words (unique per
    endpoint) and proxy-port values."""
    rng = np.random.default_rng(seed)
    ep = np.repeat(np.arange(n_ep), per_ep)
    ka = rng.integers(0, 2 ** 32, n_ep * per_ep, dtype=np.uint64) \
        .astype(np.uint32)
    kb = (rng.integers(0, 2 ** 31, n_ep * per_ep) * 2 + 1).astype(np.uint32)
    val = rng.choice([0, 0, 15001, 23000], n_ep * per_ep).astype(np.int32)
    return ep, ka, kb, val, n_ep


def _assert_same_tables(got, want):
    assert got.buckets_per_ep == want.buckets_per_ep
    assert got.width == want.width
    assert got.num_endpoints == want.num_endpoints
    for f in ("key_a", "key_b", "value"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype == np.int32
        assert g.tobytes() == w.tobytes(), f


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "forced-nb8",
                                  "tiny-nb2", "empty-endpoints"])
def test_builder_arrays_equal_reference(case):
    if case.startswith("seed"):
        ep, ka, kb, val, n_ep = _flat_entries(int(case[-1]))
        kw = {}
    elif case == "forced-nb8":
        ep, ka, kb, val, n_ep = _flat_entries(5, n_ep=6, per_ep=60)
        kw = {"buckets_per_ep": 8}   # 60 keys in 64 slots: overflows
    elif case == "tiny-nb2":
        ep, ka, kb, val, n_ep = _flat_entries(6, n_ep=5, per_ep=3)
        kw = {"buckets_per_ep": 1}   # raised to the 2-bucket floor
    else:
        ep, ka, kb, val, _ = _flat_entries(7, n_ep=4, per_ep=20)
        ep = ep * 3                  # endpoints 1, 2, 4, 5, ... are empty
        n_ep = 12
        kw = {}
    got = bt.build_bucket_tables(ep, ka, kb, val, n_ep, revision=3, **kw)
    want = ref_bt.build_bucket_tables(ep, ka, kb, val, n_ep, revision=3,
                                      **kw)
    _assert_same_tables(got, want)
    assert got.revision == 3 and got.entry_count() == len(ep)
    if case == "tiny-nb2":
        assert got.buckets_per_ep == 2
    if case == "forced-nb8":
        assert got.buckets_per_ep > 8


def test_compile_states_bucketed_equals_reference():
    states = mixed_bucket_states(12, 50, seed=3)
    got = bt.compile_states_bucketed(states, revision=2)
    want = ref_bt.compile_states_bucketed(_ref_states(states), revision=2)
    _assert_same_tables(got, want)


def test_hashes_match_reference_over_full_range():
    rng = np.random.default_rng(0)
    ka = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    kb = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ka[:4], kb[:4] = [0, 2 ** 31, 2 ** 32 - 1, 0xA5A5A5A5], \
        [0xA5A5A5A5, 2 ** 32 - 1, 0, 2 ** 31]
    ta = torch.as_tensor(ka.view(np.int32))
    tb = torch.as_tensor(kb.view(np.int32))
    ja, jb = jnp.asarray(ka.view(np.int32)), jnp.asarray(kb.view(np.int32))
    np.testing.assert_array_equal(
        ops.second_hash(ta, tb).numpy(),
        np.asarray(ref_ops.second_hash_jnp(ja, jb)))
    np.testing.assert_array_equal(ops.second_hash(ta, tb).numpy(),
                                  bt.second_hash(ka, kb).view(np.int32))
    for nb in (2, 256, 1 << 16):
        g1, g2 = ops.bucket_pair(ta, tb, nb - 1)
        w1, w2 = ref_ops.bucket_pair_jnp(ja, jb, jnp.int32(nb - 1))
        h1, h2 = bt.bucket_pair(ka, kb, np.uint32(nb - 1))
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))
        np.testing.assert_array_equal(g1.numpy(), h1)
        np.testing.assert_array_equal(g2.numpy(), h2)
        assert (g1 != g2).all()


def test_bucket_lookup_matches_reference():
    ep, ka, kb, val, n_ep = _flat_entries(11)
    tables = bt.build_bucket_tables(ep, ka, kb, val, n_ep)
    rng = np.random.default_rng(12)
    b = 2048
    pick = rng.integers(0, len(ep), b)
    hit = rng.random(b) < 0.6
    row = np.where(hit, ep[pick], rng.integers(0, n_ep, b)).astype(np.int32)
    q_a = np.where(hit, ka[pick], rng.integers(0, 2 ** 32, b)) \
        .astype(np.uint32).view(np.int32)
    q_b = kb[pick].view(np.int32)
    t = [torch.as_tensor(x) for x in (tables.key_a, tables.key_b,
                                      tables.value)]
    j = [jnp.asarray(x) for x in (tables.key_a, tables.key_b, tables.value)]
    got = ops.bucket_lookup(*t, tables.buckets_per_ep, torch.as_tensor(q_a),
                            torch.as_tensor(q_b), torch.as_tensor(row))
    want = ref_ops.bucket_lookup(*j, tables.buckets_per_ep, jnp.asarray(q_a),
                                 jnp.asarray(q_b), jnp.asarray(row))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    found = got[0].numpy()
    assert 0.5 < found.mean() < 0.7
    flat = got[2].numpy()[found]
    np.testing.assert_array_equal(tables.value.reshape(-1)[flat],
                                  got[1].numpy()[found])


def _pkt_args(host, dev=CPU):
    return [torch.as_tensor(host[f], device=dev) for f in CONFIG2_FIELDS]


def test_verdict_step_over_three_calls_matches_reference_and_oracle():
    """All three entry kinds, both directions, fragments, proxy ports and
    lengths up to 2**31 (so byte counters wrap) over 3 calls."""
    states = mixed_bucket_states(16, 60, seed=7)
    tables = bt.compile_states_bucketed(states, revision=4)
    ref_tables = ref_bt.compile_states_bucketed(_ref_states(states),
                                                revision=4)
    eng = ops.BucketVerdictEngine(tables, device="cpu")
    ref = ref_ops.BucketVerdictEngine(ref_tables)
    assert eng.revision == 4 and eng.nbytes() == ref.nbytes()
    seen = set()
    n_hit = hit_bytes = 0
    for call in range(3):
        host = mixed_bucket_packets(states, 4096, seed=20 + call)
        got = eng(*_pkt_args(host)).numpy()
        want = np.asarray(ref(*[host[f] for f in CONFIG2_FIELDS]))
        np.testing.assert_array_equal(got, want)
        seen |= set(np.unique(got).tolist())
        n_hit += int((got >= 0).sum())
        hit_bytes += int(host["length"][got >= 0].astype(np.int64).sum())
        for i in range(0, 4096, 37):
            st = states[host["endpoint"][i]]
            if host["is_fragment"][i]:
                continue
            assert got[i] == oracle_verdict(
                st, int(host["identity"][i]), int(host["dport"][i]),
                int(host["proto"][i]), int(host["direction"][i])), i
    assert {-2, -1, 0, 15001} <= seen
    packets, bytes_ = convert.bucket_counters_to_jax(eng.counters)
    np.testing.assert_array_equal(packets, np.asarray(ref.counters.packets))
    np.testing.assert_array_equal(bytes_, np.asarray(ref.counters.bytes))
    # every decided packet counted once; the byte counters wrapped
    assert int(packets.sum()) == n_hit > 0
    assert int(bytes_.astype(np.int64).sum()) % 2 ** 32 == \
        hit_bytes % 2 ** 32
    assert int(bytes_.astype(np.int64).sum()) < hit_bytes


def test_byte_counters_wrap_like_uint32():
    """One entry hit by packets of 2**31 - 1 bytes: the byte counter
    passes 2**32 and wraps in both packages."""
    states = mixed_bucket_states(1, 30, seed=1)
    key = next(k for k in states[0] if k.identity and k.dest_port)
    tables = bt.compile_states_bucketed(states)
    eng = ops.BucketVerdictEngine(tables, device="cpu")
    ref = ref_ops.BucketVerdictEngine(ref_bt.compile_states_bucketed(
        _ref_states(states)))
    b = 5
    host = {"endpoint": np.zeros(b), "identity": np.full(b, key.identity),
            "dport": np.full(b, key.dest_port), "proto": np.full(b, 6),
            "direction": np.full(b, key.direction),
            "length": np.full(b, 2 ** 31 - 1), "is_fragment": np.zeros(b)}
    host = {k: v.astype(np.int32) for k, v in host.items()}
    for _ in range(2):
        eng(*_pkt_args(host))
        ref(*[host[f] for f in CONFIG2_FIELDS])
    got = convert.bucket_counters_to_jax(eng.counters)
    np.testing.assert_array_equal(got[0], np.asarray(ref.counters.packets))
    np.testing.assert_array_equal(got[1], np.asarray(ref.counters.bytes))
    assert got[0].max() == 10
    assert got[1].max() == (10 * (2 ** 31 - 1)) % 2 ** 32


def test_builders_refuse_zero_key_word_and_duplicates():
    for build in (bt.build_bucket_tables, ref_bt.build_bucket_tables):
        with pytest.raises(ValueError, match="reserved"):
            build(np.array([0]), np.array([1], np.uint32),
                  np.array([0], np.uint32), np.array([0], np.int32),
                  num_endpoints=1)
        with pytest.raises(ValueError, match="1 duplicate"):
            build(np.array([0, 0, 1]), np.array([5, 5, 5], np.uint32),
                  np.array([3, 3, 3], np.uint32),
                  np.array([0, 1, 0], np.int32), num_endpoints=2)


def test_config2_workload_matches_bench_tables_and_oracle():
    """``build_config2`` is the port's copy of ``bench_suite.py``'s table
    construction: the same seed gives the same key words and tables.
    Then a batch of its traffic through both engines and the flat-array
    oracle."""
    state = build_config2(n_endpoints=64, rules_per_ep=50, seed=3)
    ident, meta, ep_col, ref_tables, _ = _make_policy_tables(
        np.random.default_rng(3), 64, 50)
    np.testing.assert_array_equal(state.ident, ident)
    np.testing.assert_array_equal(state.meta, meta)
    np.testing.assert_array_equal(state.ep_col, ep_col)
    _assert_same_tables(state.tables, ref_tables)

    run = Config2Run(4096, device="cpu", state=state)
    ref = ref_ops.BucketVerdictEngine(ref_tables)
    for seed in (4, 5):
        host = config2_packets(state, 4096, seed=seed)
        got = run.step(run.to_device(host)).numpy()
        want = np.asarray(ref(*[host[f] for f in CONFIG2_FIELDS]))
        np.testing.assert_array_equal(got, want)
        assert 0.45 < (got == 0).mean() < 0.55
        for i in range(0, 4096, 16):
            assert got[i] == state.oracle_verdict(
                *(int(host[f][i]) for f in ("endpoint", "identity", "dport",
                                            "proto", "direction",
                                            "is_fragment"))), i
    got = convert.bucket_counters_to_jax(run.engine.counters)
    np.testing.assert_array_equal(got[0], np.asarray(ref.counters.packets))
    np.testing.assert_array_equal(got[1], np.asarray(ref.counters.bytes))


def test_counters_cross_over_and_back():
    rng = np.random.default_rng(2)
    p = rng.integers(0, 2 ** 32, 100, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 100, dtype=np.uint64).astype(np.uint32)
    c = convert.bucket_counters_from_jax(p, b, device="cpu")
    assert c.packets.dtype == torch.int32
    back = convert.bucket_counters_to_jax(c)
    np.testing.assert_array_equal(back[0], p)
    np.testing.assert_array_equal(back[1], b)
    with pytest.raises(ValueError):
        convert.bucket_counters_from_jax(p.astype(np.int64), b,
                                         device="cpu")


def test_entry_points_default_to_the_card():
    tables = bt.compile_states_bucketed(mixed_bucket_states(2, 4, seed=0))
    for call in (lambda: ops.BucketVerdictEngine(tables),
                 lambda: Config2Run(16, state=build_config2(4, 8)),
                 lambda: convert.bucket_counters_from_jax(
                     np.zeros(4, np.uint32), np.zeros(4, np.uint32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
