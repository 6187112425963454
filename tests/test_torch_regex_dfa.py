"""The regex -> DFA compiler and the plain DFA walks: JAX package vs port.

Both compilers must give the same ``table`` / ``accept`` / ``starts`` for
the DFA-engine test patterns and the BASELINE config-3 (HTTP) and
config-5 (FQDN) rule sets, and refuse the same patterns.  The port's
``dfa_match``, ``dfa_match_parallel`` and ``dfa_match_compose`` must give
the reference's bits (tolerance 0) on ragged, row-padded, mid-row
negative and overlong rows.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compiler import regexc as ref_rx
from cilium_tpu.l7 import http as ref_http
from cilium_tpu.ops import dfa_ops as ref_ops
from cilium_tpu.ops import dfa_parallel as ref_par
from cilium_tpu.policy import api as ref_api
from cilium_tpu.utils.bucketing import bucket_size as ref_bucket_size

from cilium_tpu_torch import convert
from cilium_tpu_torch.compiler import regexc as rx
from cilium_tpu_torch.l7 import http
from cilium_tpu_torch.ops import dfa_ops as ops
from cilium_tpu_torch.ops import dfa_parallel as par
from cilium_tpu_torch.policy import api
from cilium_tpu_torch.utils.bucketing import bucket_size

PATTERNS = ["GET", "/public/.*", "/api/v[0-9]+/users/[0-9]+",
            ".*admin.*", "POST|PUT", "a{2,4}b*", "[^/]+/[^/]+"]
TEXTS = ["GET", "POST", "/public/index.html", "/public/",
         "/api/v2/users/42", "/api/vX/users/1", "xadminy", "admin",
         "aab", "aaaaab", "ab", "foo/bar", "a/b/c", "", "x" * 200,
         "GET /", "aa", "aaaa", "\\d\\w\\s", "\xff\x00\x01"]
LENGTH = 64

# BASELINE config 3 (bench_suite.py:138) and config 5 (:206)
HTTP_RULES = [dict(method="GET", path="/public/.*"),
              dict(method="GET", path="/api/v[0-9]+/users/.*"),
              dict(method="POST", path="/api/v[0-9]+/orders"),
              dict(method="PUT", path="/admin/.*",
                   host="admin\\.example\\.com")]
FQDN_SELECTORS = [dict(match_pattern="*.example.com"),
                  dict(match_name="api.internal.svc"),
                  dict(match_pattern="db-*.prod.local")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pattern_sets():
    return {
        "dfa-engine": PATTERNS,
        "config3-http": [http.rule_to_combined_regex(api.PortRuleHTTP(**r))
                         for r in HTTP_RULES],
        "config3-http-headers": [http._header_regex(h) for h in
                                 ("X-Token abc.1", "Content-Type",
                                  "x-req-id 7")],
        "config5-fqdn": [api.FQDNSelector(**s).to_regex()
                         for s in FQDN_SELECTORS],
        "classes-and-repeats": ["\\d{2,3}-\\w+", "[^a-c]?x{3}",
                                "(ab|cd)*e", "\\S+\\s\\D", "a.c"],
    }


@pytest.mark.parametrize("name", sorted(_pattern_sets()))
def test_compiled_tables_equal_reference(name):
    pats = _pattern_sets()[name]
    got = rx.compile_regex_set(pats)
    want = ref_rx.compile_regex_set(pats)
    assert got.num_states == want.num_states
    assert got.patterns == want.patterns
    for f in ("table", "accept", "starts"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
    for g, w in zip(got.byte_classes(), want.byte_classes()):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got.byte_classes() is got.byte_classes()


def test_rule_lowering_equals_reference():
    for r in HTTP_RULES:
        assert http.rule_to_combined_regex(api.PortRuleHTTP(**r)) == \
            ref_http._rule_to_combined_regex(ref_api.PortRuleHTTP(**r))
    for h in ("X-Token abc.1", "Content-Type", "a+b (c)"):
        assert http._header_regex(h) == ref_http._header_regex(h)
    for s in FQDN_SELECTORS + [dict(match_name="Api.Example.COM."),
                               dict(match_pattern="*.a-b_c.io")]:
        assert api.FQDNSelector(**s).to_regex() == \
            ref_api.FQDNSelector(**s).to_regex()
        for name in ("x.example.com", "api.internal.svc", "db-1.prod.local",
                     "api.example.com", "x.a-b_c.io", "EXAMPLE.com"):
            assert api.FQDNSelector(**s).matches(name) == \
                ref_api.FQDNSelector(**s).matches(name)


@pytest.mark.parametrize("pattern", ["(?=a)b", "(?!a)b", "(a)\\1",
                                     "(?<=a)b", "[", "Ā"])
def test_refusals_match_reference(pattern):
    for mod in (rx, ref_rx):
        with pytest.raises(mod.RegexCompileError):
            mod.compile_regex_set([pattern])


def test_state_budget_refusal_matches_reference():
    pats = ["(a|b)*a(a|b){8}", "x"]
    for mod in (rx, ref_rx):
        with pytest.raises(mod.RegexCompileError, match="state budget"):
            mod.compile_regex_set(pats, max_states=64)
    got = rx.compile_regex_set(pats, max_states=rx.MAX_DFA_STATES)
    want = ref_rx.compile_regex_set(pats, max_states=ref_rx.MAX_DFA_STATES)
    assert got.table.tobytes() == want.table.tobytes()
    assert rx.MAX_DFA_STATES == ref_rx.MAX_DFA_STATES


def test_policy_refusals_match_reference():
    bad = [lambda m: m.PortRuleHTTP(path="(").sanitize(),
           lambda m: m.PortRuleKafka(role="produce",
                                     api_key="fetch").sanitize(),
           lambda m: m.PortRuleKafka(api_key="nope").sanitize(),
           lambda m: m.PortRuleKafka(api_version="x").sanitize(),
           lambda m: m.PortRuleKafka(topic="bad topic").sanitize(),
           lambda m: m.FQDNSelector().sanitize(),
           lambda m: m.FQDNSelector(match_name="*.x.com").sanitize(),
           lambda m: m.FQDNSelector(match_pattern="a..b").sanitize()]
    for make in bad:
        for mod in (api, ref_api):
            with pytest.raises(mod.PolicyError):
                make(mod)
    assert api.KAFKA_API_KEY_MAP == ref_api.KAFKA_API_KEY_MAP
    for r in (dict(role="consume"), dict(role="produce"),
              dict(api_key="Metadata")):
        assert api.PortRuleKafka(**r).api_keys_int == \
            ref_api.PortRuleKafka(**r).api_keys_int


def test_host_helpers_equal_reference():
    for n in (0, 1, 15, 16, 17, 1000):
        assert bucket_size(n) == ref_bucket_size(n)
    data = ops.encode_strings(TEXTS, LENGTH)
    np.testing.assert_array_equal(data, ref_ops.encode_strings(TEXTS, LENGTH))
    assert (data[TEXTS.index("x" * 200)] == -2).all()
    for block in (data, data[:5], data[:, :20]):
        np.testing.assert_array_equal(ops.bucket_cols(block),
                                      ref_ops.bucket_cols(block))
        np.testing.assert_array_equal(ops.bucket_rows(block, 8),
                                      ref_ops.bucket_rows(block, 8))
    assert ops.bucket_cols(data).shape == (len(TEXTS), 32)
    short = ops.encode_strings(["ab", "cde"], 512)
    assert ops.bucket_cols(short).shape == (2, 16)
    assert ops.bucket_rows(short).shape == (16, 512)


def _blocks():
    """Ragged rows; rows padded by bucket_rows; a negative byte in the
    middle of rows; overlong (-2) rows; a column count that is no
    multiple of k."""
    base = ops.encode_strings(TEXTS, LENGTH)
    mid = base.copy()
    mid[0, 1] = -1            # G, <pad>, T
    mid[4, 3] = -1
    mid[6, 0] = -1
    yield "ragged", base
    yield "row-padded", ops.bucket_rows(ops.bucket_cols(base), 32)
    yield "mid-row-negative", mid
    yield "odd-columns", np.ascontiguousarray(base[:, :23])


@pytest.fixture(scope="module")
def compiled():
    return rx.compile_regex_set(PATTERNS), ref_rx.compile_regex_set(PATTERNS)


@pytest.mark.parametrize("walker", ["dfa_match", "dfa_match_parallel",
                                    "dfa_match_compose-k3",
                                    "dfa_match_compose-k4"])
def test_plain_walks_match_reference(compiled, walker):
    got_c, want_c = compiled
    t_tab, t_acc, t_st = ops.device_dfa_tables(got_c, device="cpu")
    j_tab, j_acc, j_st = ref_ops.device_dfa_tables(want_c)
    for name, block in _blocks():
        t_data, j_data = torch.as_tensor(block), jnp.asarray(block)
        if walker == "dfa_match":
            got = ops.dfa_match(t_tab, t_acc, t_st, t_data)
            want = ref_ops.dfa_match(j_tab, j_acc, j_st, j_data)
        elif walker == "dfa_match_parallel":
            got = par.dfa_match_parallel(t_tab, t_acc, t_st, t_data)
            want = ref_par.dfa_match_parallel(j_tab, j_acc, j_st, j_data)
        else:
            k = int(walker[-1])
            got = par.dfa_match_compose(t_tab, t_acc, t_st, t_data, k)
            want = ref_par.dfa_match_compose(j_tab, j_acc, j_st, j_data, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        if name == "ragged":
            for ti, t in enumerate(TEXTS):
                for pi, p in enumerate(PATTERNS):
                    exp = len(t.encode()) <= LENGTH and \
                        rx.oracle_match(p, t.encode())
                    assert bool(got[ti, pi]) == exp, (t, p)


def test_scans_carry_states_like_reference(compiled):
    """``dfa_scan`` and the parallel scan from arbitrary carried states,
    and the transition functions / composition they are made of."""
    got_c, want_c = compiled
    rng = np.random.default_rng(0)
    block = ops.encode_strings(TEXTS, 40)
    states = rng.integers(0, got_c.num_states,
                          (len(TEXTS), len(PATTERNS))).astype(np.int32)
    t_tab = torch.as_tensor(got_c.table)
    j_tab = jnp.asarray(want_c.table)
    for got, want in (
            (ops.dfa_scan(t_tab, torch.as_tensor(states),
                          torch.as_tensor(block)),
             ref_ops.dfa_scan(j_tab, jnp.asarray(states),
                              jnp.asarray(block))),
            (par.dfa_parallel_scan(t_tab, torch.as_tensor(states),
                                   torch.as_tensor(block)),
             ref_par.dfa_parallel_scan(j_tab, jnp.asarray(states),
                                       jnp.asarray(block))),
            (par.dfa_scan_compose(t_tab, torch.as_tensor(states),
                                  torch.as_tensor(block), 3),
             ref_par.dfa_scan_compose(j_tab, jnp.asarray(states),
                                      jnp.asarray(block), 3)),
            (par.transition_functions(t_tab, torch.as_tensor(block[:3])),
             ref_par.transition_functions(j_tab, jnp.asarray(block[:3])))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = par.transition_functions(t_tab, torch.as_tensor(block[:2]))
    jf = ref_par.transition_functions(j_tab, jnp.asarray(block[:2]))
    np.testing.assert_array_equal(
        par.compose(f[:, 1], f[:, 0]).numpy(),
        np.asarray(ref_par.compose(jf[:, 1], jf[:, 0])))


def test_tables_cross_packages(compiled):
    """The reference's compiled tables fed to the port's walk give the
    reference's walk's bits."""
    _, want_c = compiled
    port_c = convert.compiled_regex_from_jax(want_c.table, want_c.accept,
                                             want_c.starts, want_c.patterns)
    block = ops.encode_strings(TEXTS, LENGTH)
    got = ops.dfa_match(*ops.device_dfa_tables(port_c, device="cpu"),
                        torch.as_tensor(block))
    want = ref_ops.dfa_match(*ref_ops.device_dfa_tables(want_c),
                             jnp.asarray(block))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        convert.compiled_regex_from_jax(want_c.table[:, :10], want_c.accept,
                                        want_c.starts)


def test_oracle_match_is_fullmatch():
    for p in PATTERNS:
        for t in TEXTS:
            assert rx.oracle_match(p, t.encode()) == \
                ref_rx.oracle_match(p, t.encode()) == \
                (re.fullmatch(p.encode(), t.encode()) is not None)
