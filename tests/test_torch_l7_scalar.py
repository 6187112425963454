"""The scalar L7 tier: ``native.ScalarDFA`` and the engines' single-
request paths against the JAX package.

``ScalarDFA`` walks the compiled stacked DFA tables on the host in C++
(``native/runtime.cc`` ``dfa_match_scalar``); ``HTTPPolicyEngine.
check_one`` and ``DNSPolicyEngine.allowed_one`` ride on it.  Both
packages' walkers take the same compiled tables and seeded byte strings
(empty ones, and strings at and past ``MAX_REQUEST_LINE``,
``MAX_HEADER_BLOCK`` and ``MAX_NAME_LEN``); the single-request paths
must equal the port's batched ``check`` / ``allowed`` and the
reference's ``check_one`` / ``allowed_one``.  Tolerance 0: every output
is a boolean.
"""

import numpy as np
import pytest

from cilium_tpu import native as ref_native
from cilium_tpu.l7 import dns as ref_dns
from cilium_tpu.l7 import http as ref_http
from cilium_tpu.policy import api as ref_api

from cilium_tpu_torch import native
from cilium_tpu_torch.compiler.regexc import compile_regex_set
from cilium_tpu_torch.l7 import dns, http
from cilium_tpu_torch.policy import api
from cilium_tpu_torch.workloads import FQDN_SELECTORS, HTTP_RULES

HEADER_RULES = [dict(method="GET", path="/api/.*",
                     headers=("X-Token abc.1",)),
                dict(method="POST", path="/upload",
                     headers=("Content-Type", "x-req-id 7")),
                dict(path="/public/.*", host="a[a-z]*\\.io"),
                dict(method="DELETE")]


def _strings(rng, alphabet: bytes, lengths):
    out = []
    for n in lengths:
        idx = rng.integers(0, len(alphabet), n)
        out.append(bytes(alphabet[i] for i in idx))
    return out


def _lengths(rng, limit):
    """Empty, short, and every length around ``limit``."""
    return [0, 1, 2] + list(rng.integers(3, 64, 40)) + \
        [limit - 1, limit, limit + 1, limit + 7]


@pytest.mark.parametrize("which", ["http", "headers", "dns"])
def test_scalar_dfa_matches_reference(which):
    rng = np.random.default_rng({"http": 1, "headers": 2, "dns": 3}[which])
    if which == "http":
        patterns = [http.rule_to_combined_regex(r) for r in HTTP_RULES]
        limit = http.MAX_REQUEST_LINE
        seeds = [http.request_line(http.HTTPRequest(m, p, "admin.example.com"))
                 for m in ("GET", "POST", "PUT")
                 for p in ("/public/a", "/api/v2/orders", "/admin/x")]
    elif which == "headers":
        patterns = [http._header_regex(h) for r in HEADER_RULES
                    for h in r.get("headers", ())]
        limit = http.MAX_HEADER_BLOCK
        seeds = ["\x01content-type: json\x01x-req-id: 7\x01",
                 "\x01x-token: abc.1\x01", "\x01\x01"]
    else:
        patterns = [s.to_regex() for s in FQDN_SELECTORS]
        limit = dns.MAX_NAME_LEN
        seeds = ["host1.example.com", "api.internal.svc", "db-3.prod.local",
                 "evil.attacker.net"]
    compiled = compile_regex_set(patterns)
    mine, ref = native.ScalarDFA(compiled), ref_native.ScalarDFA(compiled)
    assert mine.num_regex == ref.num_regex == len(patterns)
    alphabet = bytes(sorted(set("".join(seeds).encode()))) + b"\x00\x01\xff"
    data = [s.encode() for s in seeds] + \
        _strings(rng, alphabet, _lengths(rng, limit))
    # the seeds, padded up to and past the limit
    data += [s.encode() + b"x" * (limit - len(s) + k)
             for s in seeds[:2] for k in (-1, 0, 1)]
    hits = 0
    for d in data:
        got, want = mine.match(d), ref.match(d)
        assert got.dtype == bool and got.shape == (len(patterns),)
        np.testing.assert_array_equal(got, want, err_msg=repr(d[:40]))
        hits += int(got.any())
    assert 0 < hits < len(data)


def _ref_rule(r):
    return ref_api.PortRuleHTTP(path=r.path, method=r.method, host=r.host,
                                headers=tuple(r.headers))


def _requests(n, seed):
    """Requests over both rule sets: bench paths, header sets that
    satisfy, half-satisfy or miss the requirements, mixed-case hosts,
    request lines at and past ``MAX_REQUEST_LINE`` and header blocks
    past ``MAX_HEADER_BLOCK``."""
    rng = np.random.default_rng(seed)
    paths = ["/public/idx.html", "/api/v2/users/42", "/api/v2/orders",
             "/secret/x", "/admin/panel", "/api/vX/users/1", "/upload",
             "/api/x", ""]
    headers = [None, {"X-Token": "abc.1"}, {"x-token": "abc.2"},
               {"Content-Type": "json", "X-Req-Id": "7"},
               {"content-type": "json"}, {"X-Req-Id": "7"},
               {"X-Token": "abc.1", "Pad": "p" * 1100},
               {"X-Token": "abc.1", "Pad": "p" * 990}]
    hosts = ["admin.example.com", "ADMIN.example.com", "abc.io", "x.io", ""]
    out = []
    for _ in range(n):
        method = ["GET", "POST", "PUT", "DELETE"][rng.integers(0, 4)]
        host = hosts[rng.integers(0, len(hosts))]
        path = paths[rng.integers(0, len(paths))]
        u = rng.random()
        if u < 0.1:
            # the request line lands at, or one past, the limit
            fill = http.MAX_REQUEST_LINE - len(method) - len(host) - 2 - 8
            path = "/public/" + "a" * (fill + int(rng.integers(0, 2)))
        elif u < 0.15:
            path = "/public/" + "a" * 600
        out.append(http.HTTPRequest(method=method, path=path, host=host,
                                    headers=headers[rng.integers(
                                        0, len(headers))]))
    return out


@pytest.mark.parametrize("rules", ["config3", "headers", "allow-all"])
def test_check_one_equals_batched_and_reference(rules):
    port_rules = {"config3": list(HTTP_RULES), "allow-all": [],
                  "headers": [api.PortRuleHTTP(**r)
                              for r in HEADER_RULES]}[rules]
    eng = http.HTTPPolicyEngine(port_rules, device="cpu")
    ref = ref_http.HTTPPolicyEngine([_ref_rule(r) for r in port_rules])
    # the reference really takes its scalar tier (its native build
    # did not fall back)
    assert (getattr(ref, "_scalar", None) is None) == (rules == "allow-all")
    reqs = _requests(400, seed=11)
    lines = [len(http.request_line(r).encode()) for r in reqs]
    assert http.MAX_REQUEST_LINE in lines and \
        http.MAX_REQUEST_LINE + 1 in lines
    batched = eng.check(reqs)
    single = [eng.check_one(r) for r in reqs]
    want = [ref.check_one(ref_http.HTTPRequest(
        method=r.method, path=r.path, host=r.host, headers=r.headers))
        for r in reqs]
    assert single == [bool(v) for v in batched] == want
    if rules != "allow-all":
        assert 0 < sum(single) < len(reqs)


def test_allowed_one_equals_batched_and_reference():
    eng = dns.DNSPolicyEngine(list(FQDN_SELECTORS), device="cpu")
    ref = ref_dns.DNSPolicyEngine([ref_api.FQDNSelector(
        match_name=s.match_name, match_pattern=s.match_pattern)
        for s in FQDN_SELECTORS])
    rng = np.random.default_rng(5)
    names = ["host1.example.com", "HOST1.Example.com.", "api.internal.svc",
             "db-3.prod.local", "db-.prod.local", "evil.attacker.net", "",
             ".", "example.com"]
    for n in (dns.MAX_NAME_LEN - 12, dns.MAX_NAME_LEN - 11,
              dns.MAX_NAME_LEN - 10, 400):
        names.append("a" * n + ".example.com")
    names += ["h%d.example.com" % int(i) if i % 3 else
              "db-%d.prod.local" % int(i)
              for i in rng.integers(0, 10_000, 64)]
    assert any(len(n) == dns.MAX_NAME_LEN for n in names)
    assert any(len(n) == dns.MAX_NAME_LEN + 1 for n in names)
    batched = eng.allowed(names)
    single = [eng.allowed_one(n) for n in names]
    want = [ref.allowed_one(n) for n in names]
    assert single == [bool(v) for v in batched] == want
    assert 0 < sum(single) < len(names)
    assert dns.DNSPolicyEngine([], device="cpu").allowed_one("a.io") is \
        ref_dns.DNSPolicyEngine([]).allowed_one("a.io") is False


def test_scalar_tier_raises_when_the_native_build_fails(monkeypatch):
    """No fallback: a failed native build raises out of the engine's
    constructor, where the reference quietly takes the batched tier."""
    def broken():
        raise RuntimeError("native build failed")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="native build failed"):
        http.HTTPPolicyEngine(list(HTTP_RULES), device="cpu")
    with pytest.raises(RuntimeError, match="native build failed"):
        dns.DNSPolicyEngine(list(FQDN_SELECTORS), device="cpu")
