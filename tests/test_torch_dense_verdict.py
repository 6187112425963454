"""The port's dense verdict engine against the JAX package's.

``dense_verdict_reference`` (the plain version of the CUDA kernel) is
held against both JAX forms: the XLA ``dense_verdict_step`` and the
Pallas kernel in interpret mode, as tests/test_dense_verdict.py runs it,
at that file's sizes.  Exact comparisons (tolerance 0); counters as
uint32 bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compiler import lpm as ref_lpm
from cilium_tpu.compiler.policy_tables import oracle_verdict
from cilium_tpu.ops import dense_verdict as ref_dense
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch.ops import dense_verdict as dense
from cilium_tpu_torch.policy import mapstate as ms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the host's cores among several pytest
    workers; small tensors gain nothing from torch's intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rules(n_endpoints, n_rules, seed, wide=False):
    """As tests/test_dense_verdict.py builds states; ``wide`` adds
    identities >= 2**31 and ports >= 32768."""
    rng = np.random.default_rng(seed)
    idents = rng.integers(256, 400, 16)
    ports = rng.integers(1, 2048, 16)
    if wide:
        idents = np.r_[idents, rng.integers(2 ** 31, 2 ** 32, 8)]
        ports = np.r_[ports, rng.integers(32768, 65536, 8)]
    out = []
    for _ in range(n_endpoints):
        rows = [(int(rng.choice(idents)), int(rng.choice(ports)), 6,
                 int(rng.integers(0, 2)), int(rng.integers(0, 2) * 11000))
                for _ in range(n_rules)]
        rows.append((int(rng.choice(idents)), 0, 0, 0, 0))
        rows.append((0, 80, 6, 0, 15001))
        out.append(rows)
    return out, idents, ports


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


def _queries(n_ep, idents, ports, batch, seed):
    rng = np.random.default_rng(seed)
    ident_pool = np.r_[idents, rng.integers(250, 410, 8)]
    return (rng.integers(0, n_ep, batch).astype(np.int32),
            ident_pool.astype(np.uint32).view(np.int32)[
                rng.integers(0, len(ident_pool), batch)],
            rng.choice(np.r_[ports, rng.integers(1, 2048, 16), 80],
                       batch).astype(np.int32),
            rng.choice([6, 6, 6, 0], batch).astype(np.int32),
            rng.integers(0, 2, batch).astype(np.int32),
            rng.integers(40, 9000, batch).astype(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _ref_xla(tables, q):
    n = tables.ep.shape[0]
    v, cpk, cby = ref_dense.dense_verdict_step(
        tables, jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32),
        *map(jnp.asarray, q))
    return np.asarray(v), np.asarray(cpk), np.asarray(cby)


def _port(rules, q):
    tables = dense.compile_dense(_states(ms, rules), device="cpu")
    return dense.dense_verdict_reference(tables, *map(torch.as_tensor, q))


# (n_endpoints, n_rules, state seed, batch, query seed, block_b, tile_n,
#  wide keys): the three sizes of tests/test_dense_verdict.py, and one
#  with identities >= 2**31 and ports >= 32768.
PALLAS_CASES = [(4, 24, 7, 512, 8, 128, ref_dense.TILE_N, False),
                (16, 100, 12, 512, 13, 128, 256, False),
                (3, 50, 14, 256, 15, 256, 384, False),
                (4, 60, 21, 256, 22, 128, 256, True)]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_reference_matches_xla_and_pallas(case):
    n_ep, n_rules, seed, batch, qseed, block_b, tile_n, wide = case
    rules, idents, ports = _rules(n_ep, n_rules, seed, wide)
    q = _queries(n_ep, idents, ports, batch, qseed)
    v, d_pk, d_by = _port(rules, q)
    tables = ref_dense.compile_dense(_states(ref_ms, rules))
    want_v, want_pk, want_by = _ref_xla(tables, q)
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_array_equal(_u32(d_pk), want_pk)
    np.testing.assert_array_equal(_u32(d_by), want_by)
    pv, ppk, pby = ref_dense.dense_verdict_pallas(
        tables, *map(jnp.asarray, q), block_b=block_b, tile_n=tile_n,
        interpret=True)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(d_pk.numpy(), np.asarray(ppk))
    np.testing.assert_array_equal(d_by.numpy(), np.asarray(pby))
    vn = v.numpy()
    assert (vn == -1).any() and (vn == 0).any() and (vn > 0).any()


@pytest.mark.parametrize("batch", [1, 1000, 4097])
def test_reference_ragged_batch_matches_xla(batch):
    """Any B: the Pallas form needs B % block_b == 0, the port does not."""
    rules, idents, ports = _rules(5, 40, 30, wide=True)
    q = _queries(5, idents, ports, batch, 31)
    v, d_pk, d_by = _port(rules, q)
    want_v, want_pk, want_by = _ref_xla(
        ref_dense.compile_dense(_states(ref_ms, rules)), q)
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_array_equal(_u32(d_pk), want_pk)
    np.testing.assert_array_equal(_u32(d_by), want_by)


def test_reference_chunking_is_invisible(monkeypatch):
    """Chunks of packets smaller than B give the one-chunk result."""
    rules, idents, ports = _rules(6, 30, 40, wide=True)
    q = _queries(6, idents, ports, 700, 41)
    whole = _port(rules, q)
    monkeypatch.setattr(dense, "_CHUNK_ELEMS", 97 * 256)
    chunked = _port(rules, q)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    prefixes = {"10.0.0.0/8": 100, "10.1.0.0/16": 200, "0.0.0.0/0": 2}
    lpm_t = dense.compile_dense_lpm(prefixes, device="cpu")
    addrs = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2 ** 32, 1000, dtype=np.uint32).view(np.int32))
    monkeypatch.setattr(dense, "_CHUNK_ELEMS", 1 << 24)
    whole = dense.dense_lpm_lookup(lpm_t, addrs)
    monkeypatch.setattr(dense, "_CHUNK_ELEMS", 3 * 128)
    for a, b in zip(whole, dense.dense_lpm_lookup(lpm_t, addrs)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_runs_plain_version_on_cpu_only():
    rules, idents, ports = _rules(4, 24, 7)
    q = _queries(4, idents, ports, 256, 8)
    tables = dense.compile_dense(_states(ms, rules), device="cpu")
    before = dense.dense_verdict.launches
    got = dense.dense_verdict(tables, *map(torch.as_tensor, q))
    want = dense.dense_verdict_reference(tables, *map(torch.as_tensor, q))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert dense.dense_verdict.launches == before  # no kernel on the CPU
    # a tensor that is not on the CPU never takes the plain version
    meta = dense.DenseTables(*(t.to("meta") for t in tables))
    with pytest.raises(ValueError, match="CUDA"):
        dense.dense_verdict(meta, *(torch.as_tensor(x).to("meta")
                                    for x in q))


def test_engine_matches_reference_engine_and_oracle():
    rules, idents, ports = _rules(4, 24, 9, wide=True)
    eng = dense.DenseVerdictEngine(_states(ms, rules), device="cpu")
    ref_states = _states(ref_ms, rules)
    ref = ref_dense.DenseVerdictEngine(ref_states)
    for it in range(2):
        q = _queries(4, idents, ports, 256, 10 + it)
        v = eng(*q).numpy()
        np.testing.assert_array_equal(v, np.asarray(ref(*q)))
    np.testing.assert_array_equal(_u32(eng.counters_packets),
                                  np.asarray(ref.counters_packets))
    np.testing.assert_array_equal(_u32(eng.counters_bytes),
                                  np.asarray(ref.counters_bytes))
    ep, ident, dport, proto, dirn, _ = q
    for i in range(256):
        assert v[i] == oracle_verdict(
            ref_states[ep[i]], int(np.uint32(ident[i].view(np.uint32))),
            int(dport[i]), int(proto[i]), int(dirn[i]))


def test_empty_state_drops_everything():
    eng = dense.DenseVerdictEngine([ms.PolicyMapState()], device="cpu")
    v = eng(np.zeros(4), np.full(4, 300), np.full(4, 80), np.full(4, 6),
            np.zeros(4), np.full(4, 100))
    assert (v.numpy() == -1).all()
    assert int(eng.counters_packets.sum()) == 0


def test_dense_lpm_matches_reference_and_oracle():
    prefixes = {"10.0.0.0/8": 100, "10.1.0.0/16": 200,
                "10.1.2.0/24": 300, "10.1.2.3/32": 400,
                "0.0.0.0/0": 2, "192.168.0.0/16": 500, "200.1.0.0/16": 600}
    rng = np.random.default_rng(3)
    addrs = np.r_[np.array([ref_lpm.ipv4_to_u32(q) for q in (
        "10.1.2.3", "10.1.2.9", "10.1.9.9", "10.9.9.9", "192.168.1.1",
        "8.8.8.8", "200.1.255.255")], np.uint32),
        rng.integers(0, 2 ** 32, 200, dtype=np.uint32)].view(np.int32)
    for pf in (prefixes, {k: v for k, v in prefixes.items()
                          if k != "0.0.0.0/0"}):
        found, value = dense.dense_lpm_lookup(
            dense.compile_dense_lpm(pf, device="cpu"), torch.as_tensor(addrs))
        want_f, want_v = ref_dense.dense_lpm_lookup(
            ref_dense.compile_dense_lpm(pf), jnp.asarray(addrs))
        np.testing.assert_array_equal(found.numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(value.numpy(), np.asarray(want_v))
        for a, f, v in zip(addrs.view(np.uint32)[:7], found.numpy(),
                           value.numpy()):
            want = ref_lpm.oracle_lpm(pf, str(ref_lpm.ipaddress.IPv4Address(
                int(a))))
            assert (v if f else -1) == want
