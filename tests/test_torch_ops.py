"""The port's hash, LPM and verdict ops against the JAX package's.

Same numpy inputs through both; every comparison is exact (int32
tables, verdicts and counters: tolerance 0).  Counters are compared as
uint32 bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compiler import lpm as ref_lpm
from cilium_tpu.compiler import policy_tables as ref_pt
from cilium_tpu.datapath import verdict as ref_verdict
from cilium_tpu.ops import hashtab_ops as ref_hops
from cilium_tpu.ops import lpm_ops as ref_lops
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch.compiler import hashtab, lpm, policy_tables
from cilium_tpu_torch.datapath import verdict
from cilium_tpu_torch.ops import hashtab_ops, lpm_ops
from cilium_tpu_torch.policy import mapstate as ms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the host's cores among several pytest
    workers; small tensors gain nothing from torch's intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int32))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _u32(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.int32 \
        else np.asarray(x, np.uint32)


def _rules(seed, n_endpoints=5, n_rules=40):
    rng = np.random.default_rng(seed)
    idents = np.r_[rng.integers(256, 300, 6),
                   rng.integers(2 ** 31, 2 ** 32, 3)]
    ports = np.r_[rng.integers(1, 1024, 6), rng.integers(32768, 65536, 4)]
    out = []
    for _ in range(n_endpoints):
        rows = [(int(rng.choice(idents)), int(rng.choice(ports)), 6,
                 int(rng.integers(0, 2)), int(rng.integers(0, 2) * 11000))
                for _ in range(n_rules)]
        rows.append((int(rng.choice(idents)), 0, 0, 1, 0))
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


def _packets(seed, n_endpoints, idents, ports, batch=1024):
    rng = np.random.default_rng(seed)
    idents_i32 = np.r_[idents, rng.integers(0, 2 ** 32, 4)] \
        .astype(np.uint32).view(np.int32)
    return dict(
        endpoint=rng.integers(0, n_endpoints, batch).astype(np.int32),
        identity=rng.choice(idents_i32, batch).astype(np.int32),
        dport=rng.choice(np.r_[ports, 80, 0], batch).astype(np.int32),
        proto=rng.choice([6, 6, 6, 0, 17], batch).astype(np.int32),
        direction=rng.integers(0, 2, batch).astype(np.int32),
        length=rng.integers(40, 65536, batch).astype(np.int32),
        is_fragment=(rng.random(batch) < 0.1).astype(np.int32))


def test_hash_mix_matches_reference_over_full_range():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)
    a[:4] = [0x80000000, 0xFFFFFFFF, 0, 0x7FFFFFFF]
    ai, bi = a.view(np.int32), b.view(np.int32)
    got = hashtab_ops.hash_mix(_t(ai), _t(bi)).numpy()
    _eq(got, ref_hops.hash_mix_jnp(jnp.asarray(ai), jnp.asarray(bi)))
    _eq(got.view(np.uint32), hashtab.hash_mix(a, b))
    assert (got < 0).any()  # the high bit is exercised


@pytest.mark.parametrize("seed", [1, 2])
def test_batched_lookup_matches_reference(seed):
    rules, idents, ports = _rules(seed)
    cp = ref_pt.compile_endpoints(_states(ref_ms, rules), revision=1)
    pk = _packets(seed, len(rules), idents, ports)
    qb = np.array([policy_tables.pack_meta(int(p), int(r), int(d)) for p, r, d
                   in zip(pk["dport"], pk["proto"], pk["direction"])],
                  np.uint32).view(np.int32)
    args = (cp.key_id, cp.key_meta, cp.value, pk["identity"], qb)
    got = hashtab_ops.batched_lookup(*map(_t, args), cp.max_probe,
                                     row=_t(pk["endpoint"]))
    want = ref_hops.batched_lookup(*map(jnp.asarray, args), cp.max_probe,
                                   row=jnp.asarray(pk["endpoint"]))
    for g, w in zip(got, want):
        _eq(g.numpy(), w)
    assert got[0].any() and not got[0].all()
    # flat (unstacked) tables take no row
    got = hashtab_ops.batched_lookup(*map(_t, (cp.key_id[0], cp.key_meta[0],
                                               cp.value[0], args[3], qb)),
                                     cp.max_probe)
    want = ref_hops.batched_lookup(*map(jnp.asarray, (
        cp.key_id[0], cp.key_meta[0], cp.value[0], args[3], qb)),
        cp.max_probe)
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


def _prefixes(seed, n=60):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        plen = int(rng.choice([0, 8, 16, 20, 24, 32])) if i else 8
        addr = int(rng.integers(0, 2 ** 32)) & lpm._mask32(plen)
        out[f"{addr >> 24}.{(addr >> 16) & 255}.{(addr >> 8) & 255}."
            f"{addr & 255}/{plen}"] = 256 + i
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_lpm_lookup_matches_reference(seed):
    prefixes = _prefixes(seed)
    c = ref_lpm.compile_lpm(prefixes)
    rng = np.random.default_rng(seed)
    # half the addresses inside a known prefix, half uniform
    nets = [lpm.parse_prefixes({k: v})[0] for k, v in prefixes.items()]
    inside = [n + int(rng.integers(0, 2 ** (32 - p))) for n, _, p, _ in nets]
    addrs = np.r_[np.array(inside, np.uint32),
                  rng.integers(0, 2 ** 32, 512, dtype=np.uint32)]
    addrs = addrs.view(np.int32)
    args = (c.masks, c.key_a, c.key_b, c.value, c.prefix_lens, addrs)
    found, val = lpm_ops.lpm_lookup(*map(_t, args), c.max_probe)
    want_f, want_v = ref_lops.lpm_lookup(*map(jnp.asarray, args), c.max_probe)
    _eq(found.numpy(), want_f)
    _eq(val.numpy(), want_v)
    parsed = lpm.parse_prefixes(prefixes)
    for a, v in zip(addrs.view(np.uint32)[:64], val.numpy()[:64]):
        assert lpm.oracle_lpm_u32(parsed, int(a)) == v


def test_lpm_lookup_empty_table_misses():
    c = ref_lpm.compile_lpm({})
    addrs = np.arange(5, dtype=np.int32)
    found, val = lpm_ops.lpm_lookup(*map(_t, (c.masks, c.key_a, c.key_b,
                                              c.value, c.prefix_lens, addrs)),
                                    c.max_probe)
    assert not found.any() and (val == lpm_ops.LPM_MISS).all()


def _ref_step(cp, pk, count_mask=None, counters=None):
    pkt = ref_verdict.make_packet_batch(**pk)
    n = cp.num_endpoints * cp.slots
    counters = counters or ref_verdict.Counters(
        packets=jnp.zeros(n, jnp.uint32), bytes=jnp.zeros(n, jnp.uint32))
    cm = None if count_mask is None else jnp.asarray(count_mask)
    return ref_verdict.verdict_step(jnp.asarray(cp.key_id),
                                    jnp.asarray(cp.key_meta),
                                    jnp.asarray(cp.value), counters, pkt,
                                    cp.max_probe, count_mask=cm)


@pytest.mark.parametrize("seed,with_mask", [(5, False), (6, True)])
def test_verdict_step_matches_reference(seed, with_mask):
    rules, idents, ports = _rules(seed)
    cp = policy_tables.compile_endpoints(_states(ms, rules), revision=1)
    rng = np.random.default_rng(seed)
    n = cp.num_endpoints * cp.slots
    counters = verdict.Counters(packets=torch.zeros(n, dtype=torch.int32),
                                bytes=torch.zeros(n, dtype=torch.int32))
    ref_counters = None
    for it in range(2):  # counters accumulate across steps
        pk = _packets(seed * 10 + it, len(rules), idents, ports)
        mask = rng.random(len(pk["endpoint"])) < 0.7 if with_mask else None
        v, counters = verdict.verdict_step(
            *map(_t, (cp.key_id, cp.key_meta, cp.value)), counters,
            verdict.make_packet_batch(**pk, device="cpu"), cp.max_probe,
            count_mask=None if mask is None else torch.as_tensor(mask))
        want_v, ref_counters = _ref_step(cp, pk, mask, ref_counters)
        _eq(v.numpy(), want_v)
        _eq(_u32(counters.packets.numpy()), ref_counters.packets)
        _eq(_u32(counters.bytes.numpy()), ref_counters.bytes)
    v = v.numpy()
    assert (v == verdict.VERDICT_DROP_FRAG).any()
    assert (v > 0).any() and (v == 0).any() and (v == -1).any()


def test_verdict_engine_matches_reference_and_counts():
    rules, idents, ports = _rules(7)
    cp = policy_tables.compile_endpoints(_states(ms, rules), revision=3)
    eng = verdict.VerdictEngine(cp, device="cpu")
    ref = ref_verdict.VerdictEngine(cp)
    pk = _packets(7, len(rules), idents, ports)
    pk["length"][:] = 2 ** 31 - 1  # byte counters wrap at 2**32
    for _ in range(3):
        v = eng(verdict.make_packet_batch(**pk, device="cpu"))
        want = ref(ref_verdict.make_packet_batch(**pk))
    _eq(v.numpy(), want)
    _eq(_u32(eng.counters.bytes.numpy()), ref.counters.bytes)
    flat = int(np.argmax(np.asarray(ref.counters.packets)))
    e, s = divmod(flat, cp.slots)
    assert eng.counter_for(e, s) == ref.counter_for(e, s)
    assert eng.revision == 3


def test_entry_points_raise_without_cuda():
    assert not torch.cuda.is_available()
    cp = policy_tables.compile_endpoints([ms.PolicyMapState()], revision=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verdict.VerdictEngine(cp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verdict.make_packet_batch([0], [1], [80], [6], [0])
