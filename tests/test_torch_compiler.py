"""The port's host compilers and constants against the JAX package's.

Both packages compile the same policy (made from a numpy seed) and must
give the same arrays, bit for bit.
"""

import numpy as np
import pytest
import torch

from bench import build_config1 as ref_build_config1
from cilium_tpu.compiler import hashtab as ref_hashtab
from cilium_tpu.compiler import lpm as ref_lpm
from cilium_tpu.compiler import policy_tables as ref_pt
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.datapath import verdict as ref_verdict
from cilium_tpu.ops import dense_verdict as ref_dense
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch.compiler import hashtab, lpm, policy_tables
from cilium_tpu_torch.datapath import codes
from cilium_tpu_torch.ops import dense_verdict as dense
from cilium_tpu_torch.policy import mapstate as ms
from cilium_tpu_torch.workloads import build_config1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the host's cores among several pytest
    workers; small tensors gain nothing from torch's intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rules(seed, n_endpoints=4, n_rules=30):
    """Per-endpoint rule tuples (identity, dport, proto, dir, proxy),
    with identities >= 2**31, ports >= 32768, L3-only and wildcard
    keys."""
    rng = np.random.default_rng(seed)
    idents = np.r_[rng.integers(256, 400, 6),
                   rng.integers(2 ** 31, 2 ** 32, 3)]
    ports = np.r_[rng.integers(1, 2048, 6), rng.integers(32768, 65536, 4)]
    out = []
    for _ in range(n_endpoints):
        rows = [(int(rng.choice(idents)), int(rng.choice(ports)), 6,
                 int(rng.integers(0, 2)), int(rng.integers(0, 2) * 11000))
                for _ in range(n_rules)]
        rows.append((int(rng.choice(idents)), 0, 0, 0, 0))
        rows.append((0, 80, 6, 0, 15001))
        out.append(rows)
    return out


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


def _prefixes(seed, n=40):
    rng = np.random.default_rng(seed)
    out = {"0.0.0.0/0": 2}
    for i in range(n):
        plen = int(rng.choice([8, 16, 20, 24, 32]))
        addr = int(rng.integers(0, 2 ** 32)) & lpm._mask32(plen)
        out[f"{addr >> 24}.{(addr >> 16) & 255}.{(addr >> 8) & 255}."
            f"{addr & 255}/{plen}"] = 256 + i
    return out


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_codes_match_reference():
    assert codes.VERDICT_DROP == ref_verdict.VERDICT_DROP
    assert codes.VERDICT_DROP_FRAG == ref_verdict.VERDICT_DROP_FRAG
    assert codes.VERDICT_DROP_L7 == ref_verdict.VERDICT_DROP_L7
    assert codes.VERDICT_DROP_THREAT == ref_verdict.VERDICT_DROP_THREAT
    assert codes.VERDICT_ALLOW == ref_verdict.VERDICT_ALLOW
    assert codes.WORLD_IDENTITY == ref_pipeline.WORLD_IDENTITY \
        == ref_dense.WORLD_IDENTITY
    assert (ms.INGRESS, ms.EGRESS) == (ref_ms.INGRESS, ref_ms.EGRESS)
    assert dense.LANE == ref_dense.LANE


def test_policy_key_range_checked():
    with pytest.raises(ValueError):
        ms.PolicyKey(identity=2 ** 32)
    with pytest.raises(ValueError):
        ms.PolicyKey(dest_port=2 ** 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_table_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    ka = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    kb = rng.integers(1, 2 ** 32, n, dtype=np.uint64)
    entries = {(int(a), int(b)): int(v) for a, b, v in
               zip(ka, kb, rng.integers(0, 2 ** 31, n))}
    got = hashtab.build_hash_table(entries)
    want = ref_hashtab.build_hash_table(entries)
    for f in ("key_a", "key_b", "value"):
        _eq(getattr(got, f), getattr(want, f))
    assert (got.max_probe, got.slots) == (want.max_probe, want.slots)
    _eq(hashtab.hash_mix(ka, kb), ref_hashtab.hash_mix(ka, kb))


@pytest.mark.parametrize("seed", [3, 4])
def test_compile_endpoints_matches_reference(seed):
    rules = _rules(seed)
    got = policy_tables.compile_endpoints(_states(ms, rules), revision=5)
    want = ref_pt.compile_endpoints(_states(ref_ms, rules), revision=5)
    for f in ("key_id", "key_meta", "value"):
        _eq(getattr(got, f), getattr(want, f))
    for f in ("revision", "max_probe", "num_endpoints", "slots"):
        assert getattr(got, f) == getattr(want, f)
    for key in _states(ms, rules)[0]:
        ref_key = ref_ms.PolicyKey(key.identity, key.dest_port,
                                   key.nexthdr, key.direction)
        assert policy_tables.pack_key(key) == ref_pt.pack_key(ref_key)


@pytest.mark.parametrize("seed", [5, 6])
def test_compile_lpm_matches_reference(seed):
    prefixes = _prefixes(seed)
    got, want = lpm.compile_lpm(prefixes), ref_lpm.compile_lpm(prefixes)
    for f in ("prefix_lens", "masks", "key_a", "key_b", "value"):
        _eq(getattr(got, f), getattr(want, f))
    assert (got.max_probe, got.slots) == (want.max_probe, want.slots)
    rng = np.random.default_rng(seed)
    for addr in rng.integers(0, 2 ** 32, 64):
        ip = str(ref_lpm.ipaddress.IPv4Address(int(addr)))
        assert lpm.oracle_lpm(prefixes, ip) == ref_lpm.oracle_lpm(prefixes, ip)
    assert lpm.ipv4_to_u32("10.1.2.3") == ref_lpm.ipv4_to_u32("10.1.2.3")


@pytest.mark.parametrize("seed", [7, 8])
def test_compile_dense_matches_reference(seed):
    rules = _rules(seed)
    got = dense.compile_dense(_states(ms, rules), device="cpu")
    want = ref_dense.compile_dense(_states(ref_ms, rules))
    for f in dense.DenseTables._fields:
        _eq(getattr(got, f).numpy(), getattr(want, f))
    prefixes = _prefixes(seed)
    got = dense.compile_dense_lpm(prefixes, device="cpu")
    want = ref_dense.compile_dense_lpm(prefixes)
    for f in dense.DenseLPM._fields:
        _eq(getattr(got, f).numpy(), getattr(want, f))


def test_compile_dense_empty_pads_one_lane():
    got = dense.compile_dense([ms.PolicyMapState()], device="cpu")
    want = ref_dense.compile_dense([ref_ms.PolicyMapState()])
    assert got.ep.shape[0] == dense.LANE
    for f in dense.DenseTables._fields:
        _eq(getattr(got, f).numpy(), getattr(want, f))
    got = dense.compile_dense_lpm({}, device="cpu")
    want = ref_dense.compile_dense_lpm({})
    for f in dense.DenseLPM._fields:
        _eq(getattr(got, f).numpy(), getattr(want, f))


def test_oracle_verdict_matches_reference():
    rules = _rules(9)
    states, ref_states = _states(ms, rules), _states(ref_ms, rules)
    rng = np.random.default_rng(9)
    idents = [r[0] for rows in rules for r in rows]
    ports = [r[1] for rows in rules for r in rows] + [80, 0]
    for _ in range(400):
        e = int(rng.integers(0, len(states)))
        q = (int(rng.choice(idents)), int(rng.choice(ports)),
             int(rng.choice([0, 6])), int(rng.integers(0, 2)))
        assert policy_tables.oracle_verdict(states[e], *q) == \
            ref_pt.oracle_verdict(ref_states[e], *q)


@pytest.mark.parametrize("n_rules,n_endpoints", [(100, 16), (300, 3)])
def test_build_config1_matches_bench(n_rules, n_endpoints):
    states, prefixes = build_config1(n_rules, n_endpoints)
    ref_states, ref_prefixes = ref_build_config1(n_rules, n_endpoints)
    assert prefixes == ref_prefixes
    as_rows = lambda st: sorted(  # noqa: E731
        (k.identity, k.dest_port, k.nexthdr, k.direction, v.proxy_port)
        for k, v in st.items())
    assert [as_rows(s) for s in states] == [as_rows(s) for s in ref_states]
