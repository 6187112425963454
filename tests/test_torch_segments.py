"""Endpoint segments of the dense tables, which the CUDA kernel walks.

``dense_segments`` must give each endpoint's contiguous rows, on tables
from ``compile_dense`` and on the JAX package's own tables carried
across by ``convert.from_jax_arrays``, and must refuse a table whose
endpoints are not contiguous.  A plain compare written here, that
groups the packets by endpoint and compares each group with its own
segment only (the kernel's algorithm), must equal
``dense_verdict_reference`` and the JAX ``dense_verdict_step``
exactly (tolerance 0), out-of-range packet endpoints and empty
segments included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.ops import dense_verdict as ref_dense
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch import convert
from cilium_tpu_torch.compiler.policy_tables import pack_meta
from cilium_tpu_torch.ops import dense_verdict as dense
from cilium_tpu_torch.policy import mapstate as ms
from cilium_tpu_torch.workloads import (build_config1,
                                        config1_allow_heavy_packets,
                                        config1_packets)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the host's cores among several pytest
    workers; small tensors gain nothing from torch's intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _states(mod, rules):
    states = []
    for rows in rules:
        st = mod.PolicyMapState()
        for ident, port, proto, d, proxy in rows:
            st[mod.PolicyKey(identity=ident, dest_port=port, nexthdr=proto,
                             direction=d)] = \
                mod.PolicyMapStateEntry(proxy_port=proxy)
        states.append(st)
    return states


def _wide_rules(n_endpoints, n_rules, seed, empty=()):
    """Random rows with identities >= 2**31 and ports >= 32768 among
    them; the endpoints in ``empty`` get no rows."""
    rng = np.random.default_rng(seed)
    idents = np.r_[rng.integers(256, 400, 12),
                   rng.integers(2 ** 31, 2 ** 32, 6)]
    ports = np.r_[rng.integers(1, 2048, 12), rng.integers(32768, 65536, 6)]
    out = []
    for e in range(n_endpoints):
        rows = [(int(rng.choice(idents)), int(rng.choice(ports)), 6,
                 int(rng.integers(0, 2)), int(rng.integers(0, 3) * 11000))
                for _ in range(n_rules)]
        rows += [(int(rng.choice(idents)), 0, 0, 0, 0), (0, 80, 6, 0, 15001)]
        out.append([] if e in empty else rows)
    return out, idents, ports


def _wide_packets(n_endpoints, idents, ports, batch, seed):
    rng = np.random.default_rng(seed)
    pool = np.r_[idents, rng.integers(0, 2 ** 32, 6)]
    return {"endpoint": rng.integers(-2, n_endpoints + 2, batch),
            "ident": pool.astype(np.uint32).view(np.int32)[
                rng.integers(0, len(pool), batch)],
            "dport": rng.choice(np.r_[ports, 80, 0], batch),
            "proto": rng.choice([6, 6, 0, 17], batch),
            "direction": rng.integers(0, 2, batch),
            "length": rng.integers(40, 65536, batch)}


def _recount(ep):
    """numpy recount of the offsets: real rows per endpoint, summed."""
    real = ep[ep >= 0]
    n_ep = int(real.max()) + 1 if real.size else 0
    return np.r_[0, np.cumsum(np.bincount(real, minlength=n_ep))]


def _segment_compare(tables, segments, q):
    """The kernel's algorithm in numpy: group the packets by endpoint and
    compare each group with its endpoint's segment only; an endpoint
    outside [0, E) drops, uncounted.  Returns (verdict, packets, bytes),
    the counters as uint32."""
    ka, kb, val = (t.numpy() for t in tables[1:])
    off = segments.offsets.numpy()
    pep, pid, dport, proto, pdir, plen = (np.asarray(c, np.int64) for c in q)
    pid = pid.astype(np.uint32).view(np.int32)
    mex = (pack_meta(dport, proto, pdir) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)
    ml3 = (pack_meta(0, 0, pdir) & 0xFFFFFFFF).astype(np.int32)
    verdict = np.full(pep.shape[0], -1, np.int64)
    d_pk = np.zeros(ka.shape[0], np.uint32)
    d_by = np.zeros(ka.shape[0], np.uint32)
    for e in range(segments.n_endpoints):
        rows = np.nonzero(pep == e)[0]
        lo, hi = off[e], off[e + 1]
        a, b_, v = ka[lo:hi][None], kb[lo:hi][None], val[lo:hi].astype(
            np.int64)
        m1 = (a == pid[rows, None]) & (b_ == mex[rows, None])
        m2 = (a == pid[rows, None]) & (b_ == ml3[rows, None])
        m3 = (a == 0) & (b_ == mex[rows, None])
        h1, h2, h3 = m1.any(1), m2.any(1), m3.any(1)
        verdict[rows] = np.where(h1, (m1 * v).sum(1), np.where(
            h2, 0, np.where(h3, (m3 * v).sum(1), -1)))
        eff = m1 | (m2 & ~h1[:, None]) | (m3 & ~(h1 | h2)[:, None])
        d_pk[lo:hi] += eff.sum(0).astype(np.uint32)
        d_by[lo:hi] += (eff * plen[rows, None]).sum(0).astype(np.uint32)
    return verdict.astype(np.uint32).view(np.int32), d_pk, d_by


def _check_all_three(states, ref_states, q):
    """Segment compare == dense_verdict_reference == JAX
    dense_verdict_step, bit for bit."""
    tables = dense.compile_dense(states, device="cpu")
    segments = dense.dense_segments(tables)
    want = _segment_compare(tables, segments, q)
    got = dense.dense_verdict_reference(
        tables, *(torch.as_tensor(np.asarray(c, np.int32)) for c in q))
    rt = ref_dense.compile_dense(ref_states)
    n = rt.ep.shape[0]
    jax_out = ref_dense.dense_verdict_step(
        rt, jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32),
        *(jnp.asarray(np.asarray(c, np.int32)) for c in q))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(np.asarray(jax_out[0]), want[0])
    for g, j, w in zip(got[1:], jax_out[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)
        np.testing.assert_array_equal(np.asarray(j), w)
    return want


def test_segments_of_compiled_and_converted_tables():
    rules, _, _ = _wide_rules(6, 30, 1, empty=(2, 5))
    tables = dense.compile_dense(_states(ms, rules), device="cpu")
    rt = ref_dense.compile_dense(_states(ref_ms, rules))
    port = convert.from_jax_arrays(dense={f: np.asarray(getattr(rt, f))
                                          for f in rt._fields},
                                   device="cpu")
    assert dense.DenseTables._fields == ref_dense.DenseTables._fields
    for t in (tables, port.dense):
        seg = dense.dense_segments(t)
        ep = t.ep.numpy()
        np.testing.assert_array_equal(seg.offsets.numpy(), _recount(ep))
        # endpoint 5 has no rows and is last, so E stops at 5
        assert seg.n_endpoints == 5 and seg.offsets.dtype == torch.int32
        assert seg.offsets[2] == seg.offsets[3]  # endpoint 2: empty
        np.testing.assert_array_equal(
            seg.entries.numpy(), np.stack([c.numpy() for c in t], 1))
    states, _ = build_config1(n_rules=100, n_endpoints=16)
    seg = dense.dense_segments(dense.compile_dense(states, device="cpu"))
    np.testing.assert_array_equal(np.diff(seg.offsets.numpy()),
                                  np.full(16, 120))
    empty = dense.dense_segments(dense.compile_dense([ms.PolicyMapState()],
                                                     device="cpu"))
    assert empty.n_endpoints == 0 and empty.offsets.tolist() == [0]


@pytest.mark.parametrize("ep, what", [
    ([0, 0, 1, 0, -1, -1], "contiguous"),       # endpoint 0 split
    ([1, 1, 0, 0, -1, -1], "contiguous"),       # decreasing
    ([0, 0, -1, 1, 1, -1], "padding"),          # padding in the middle
    ([0, 1, 1, -5, -1, -1], "padding"),         # a negative not -1
    ([-2, 0, 1, 1, -1, -1], "padding"),         # negative first row
])
def test_segments_refuse_non_contiguous_tables(ep, what):
    col = torch.as_tensor(np.array(ep, np.int32))
    tables = dense.DenseTables(ep=col, key_a=col.clone(), key_b=col.clone(),
                               value=col.clone())
    with pytest.raises(ValueError, match=what):
        dense.dense_segments(tables)


def test_segment_compare_matches_reference_on_config1():
    """Config-1 at 100 rules on both streams, with some packets sent to
    endpoints -1, -5 and >= E."""
    states, prefixes = build_config1(n_rules=100, n_endpoints=16)
    ref_states = [ref_ms.PolicyMapState() for _ in states]
    for st, rst in zip(states, ref_states):
        for k, v in st.items():
            rst[ref_ms.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                                 k.direction)] = \
                ref_ms.PolicyMapStateEntry(v.proxy_port)
    rng = np.random.default_rng(4)
    for pk in (config1_packets(2048, 16),
               config1_allow_heavy_packets(2048, 16, prefixes, states)):
        # identities as the LPM gives them: a prefix's or world (2)
        ident = np.where(rng.random(2048) < 0.8,
                         rng.integers(256, 356, 2048), 2)
        ep = pk["endpoint"].copy()
        odd = rng.random(2048) < 0.1
        ep[odd] = rng.choice([-1, -5, 16, 40], int(odd.sum()))
        q = (ep, ident, pk["dport"], pk["proto"], pk["direction"],
             pk["length"])
        v, d_pk, _ = _check_all_three(states, ref_states, q)
        assert (v == -1).any() and (v == 0).any()
        assert int(d_pk.sum()) == int((v != -1).sum())


@pytest.mark.parametrize("seed", [11, 12])
def test_segment_compare_matches_reference_on_wide_keys(seed):
    """Random wide-key states with empty endpoints in the middle and at
    the end, packets to endpoints -2 .. E + 1."""
    rules, idents, ports = _wide_rules(7, 40, seed, empty=(3, 6))
    pk = _wide_packets(7, idents, ports, 3000, seed + 1)
    q = tuple(pk[k] for k in ("endpoint", "ident", "dport", "proto",
                              "direction", "length"))
    v, _, _ = _check_all_three(_states(ms, rules), _states(ref_ms, rules), q)
    ep = pk["endpoint"]
    dropped = (ep < 0) | (ep >= 6) | (ep == 3)
    assert dropped.any() and (v[dropped] == -1).all()
    assert (v > 0).any() and (v == 0).any()


@pytest.mark.parametrize("fault", ["other tables", "changed in place"])
def test_dense_verdict_refuses_segments_not_of_its_tables(fault):
    """Segments copy the entries, so ``dense_verdict`` takes them only
    with the tables they were made from, unchanged since; the check runs
    on either device."""
    rules, idents, ports = _wide_rules(3, 10, 5)
    states = _states(ms, rules)
    tables = dense.compile_dense(states, device="cpu")
    pk = _wide_packets(3, idents, ports, 64, 6)
    q = tuple(torch.as_tensor(np.asarray(pk[k], np.int32))
              for k in ("endpoint", "ident", "dport", "proto", "direction",
                        "length"))
    own = dense.dense_verdict(tables, *q,
                              segments=dense.dense_segments(tables))
    for g, w in zip(own, dense.dense_verdict_reference(tables, *q)):
        assert torch.equal(g, w)
    if fault == "other tables":
        # same N and E, so only the tie to the source tells them apart
        segments = dense.dense_segments(dense.compile_dense(states,
                                                            device="cpu"))
    else:
        segments = dense.dense_segments(tables)
        tables.value.add_(1)
    with pytest.raises(ValueError, match=fault):
        dense.dense_verdict(tables, *q, segments=segments)
