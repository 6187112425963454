"""The L7 policy engines (BASELINE configs 3-5): JAX package vs port.

HTTP (with and without header rules, the allow-all engine), DNS/FQDN and
Kafka verdicts of the port on the CPU must equal the reference's on the
same rules and requests (tolerance 0), through every entry point: the
batched check, the pre-encoded and pipelined forms, the dispatch split
and the single-request path.  The port's engines are also built with a
card's selection (``on_accel=True``: quantized tables, the card's stride
budget, assoc for long payloads) and must still give the same verdicts.
"""

import struct

import numpy as np
import pytest
import torch

from cilium_tpu.l7 import dns as ref_dns
from cilium_tpu.l7 import http as ref_http
from cilium_tpu.l7 import kafka as ref_kafka
from cilium_tpu.policy import api as ref_api

from cilium_tpu_torch.compiler.regexc import oracle_match
from cilium_tpu_torch.l7 import dns, http, kafka
from cilium_tpu_torch.policy import api
from cilium_tpu_torch.workloads import (FQDN_SELECTORS, HTTP_RULES,
                                        KAFKA_RULES, config3_requests,
                                        config4_requests, config5_names)

HEADER_RULES = [dict(method="GET", path="/api/.*",
                     headers=("X-Token abc.1",)),
                dict(method="POST", path="/upload",
                     headers=("Content-Type", "x-req-id 7")),
                dict(method="DELETE")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_rule(r):
    return ref_api.PortRuleHTTP(path=r.path, method=r.method, host=r.host,
                                headers=tuple(r.headers))


def _ref_req(r):
    return ref_http.HTTPRequest(method=r.method, path=r.path, host=r.host,
                                headers=r.headers)


def _mixed_requests(n, seed):
    """Requests over the config-3 and header rule sets: bench paths,
    header sets that satisfy, half-satisfy or miss the requirements,
    capital hosts, overlong paths and header blocks."""
    rng = np.random.default_rng(seed)
    paths = ["/public/idx.html", "/api/v2/users/42", "/api/v2/orders",
             "/secret/x", "/admin/panel", "/api/vX/users/1", "/upload",
             "/api/x", ""]
    headers = [None, {"X-Token": "abc.1"}, {"x-token": "abc.2"},
               {"Content-Type": "json", "X-Req-Id": "7"},
               {"content-type": "json"}, {"X-Req-Id": "7"},
               {"X-Token": "abc.1", "Pad": "p" * 1100}]
    out = []
    for _ in range(n):
        path = paths[rng.integers(0, len(paths))]
        if rng.random() < 0.05:
            path = "/public/" + "a" * 600
        out.append(http.HTTPRequest(
            method=["GET", "POST", "PUT", "DELETE"][rng.integers(0, 4)],
            path=path,
            host=["admin.example.com", "ADMIN.example.com", "x.io",
                  ""][rng.integers(0, 4)],
            headers=headers[rng.integers(0, len(headers))]))
    return out


@pytest.mark.parametrize("on_accel", [None, True])
@pytest.mark.parametrize("rules", ["config3", "headers"])
def test_http_verdicts_match_reference(rules, on_accel):
    port_rules = list(HTTP_RULES) if rules == "config3" else \
        [api.PortRuleHTTP(**r) for r in HEADER_RULES]
    eng = http.HTTPPolicyEngine(port_rules, device="cpu", on_accel=on_accel)
    ref = ref_http.HTTPPolicyEngine([_ref_rule(r) for r in port_rules])
    reqs = _mixed_requests(300, seed=1) + config3_requests(36)
    ref_reqs = [_ref_req(r) for r in reqs]
    want = ref.check(ref_reqs)
    assert 0 < want.sum() < len(reqs)
    got = eng.check(reqs)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    # the pre-encoded forms, on the host and already on the device
    data, hdata = eng.encode(reqs)
    r_data, r_hdata = ref.encode(ref_reqs)
    np.testing.assert_array_equal(data, r_data)
    if rules == "headers":
        np.testing.assert_array_equal(hdata, r_hdata)
    else:
        assert hdata is None and r_hdata is None
    np.testing.assert_array_equal(eng.check_encoded(data, hdata, len(reqs)),
                                  want)
    packed, hpacked = eng.encode_packed(reqs)
    on_dev = (packed.to("cpu"), hpacked.to("cpu") if hpacked else None)
    np.testing.assert_array_equal(
        eng.match_device(*on_dev)[:len(reqs)].numpy(), want)
    # pipelined, split dispatch and single requests
    parts = [reqs[:100], reqs[100:101], reqs[101:]]
    for g, w in zip(eng.check_pipelined(parts), ref.check_pipelined(
            [ref_reqs[:100], ref_reqs[100:101], ref_reqs[101:]])):
        np.testing.assert_array_equal(g, w)
    dispatch, finalize = eng.dispatch_split()
    np.testing.assert_array_equal(finalize(dispatch(reqs), len(reqs)), want)
    for i in range(0, len(reqs), 23):
        assert eng.check_one(reqs[i]) == bool(want[i])
    report = eng.engine_report()
    assert ("headers" in report) == (rules == "headers")
    if on_accel is None:
        assert report == ref.engine_report()
    else:
        assert report["combined"]["dtype"] == "int8"


def test_http_config3_oracle_and_allow_all():
    eng = http.HTTPPolicyEngine(list(HTTP_RULES), device="cpu")
    reqs = config3_requests(18)
    got = eng.check(reqs)
    for r, ok in zip(reqs, got):
        want = any(rule.matches(r.method, r.path, r.host)
                   for rule in HTTP_RULES)
        assert ok == want, r
    assert got.sum() == 3   # i % 3 and i % 6: only GET /public/idx.html
    allow_all = http.HTTPPolicyEngine([], device="cpu")
    ref_all = ref_http.HTTPPolicyEngine([])
    np.testing.assert_array_equal(allow_all.check(reqs),
                                  ref_all.check([_ref_req(r) for r in reqs]))
    assert allow_all.check_one(reqs[0]) and allow_all.encode(reqs) == \
        (None, None)
    assert allow_all.dispatch_split() is None
    assert allow_all.engine_report() is None
    assert [a.tolist() for a in allow_all.check_pipelined([reqs[:2]])] == \
        [[True, True]]
    with pytest.raises(ValueError):
        allow_all.match_device(None, None)
    for line, code in ((b"HTTP/1.1 404 Not Found", 404), (b"HTTP/1.0 99 x",
                                                          None),
                       (b"GET / HTTP/1.1", None), (b"HTTP/1.1 200", 200)):
        assert http.parse_status_line(line) == code == \
            ref_http.parse_status_line(line)


NAMES = ["host1.example.com", "HOST2.Example.COM.", "example.com",
         "a.b.example.com", "api.internal.svc", "api.internal.svc.",
         "API.internal.svc", "x.api.internal.svc", "db-7.prod.local",
         "db-.prod.local", "db7.prod.local", "db-x.y.prod.local", "",
         ".", "x" * 300 + ".example.com", "under_score.example.com"]


@pytest.mark.parametrize("on_accel", [None, True])
def test_dns_verdicts_match_reference(on_accel):
    eng = dns.DNSPolicyEngine(list(FQDN_SELECTORS), device="cpu",
                              on_accel=on_accel)
    ref = ref_dns.DNSPolicyEngine([ref_api.FQDNSelector(
        match_name=s.match_name, match_pattern=s.match_pattern)
        for s in FQDN_SELECTORS])
    names = NAMES + config5_names(64)
    want = ref.allowed(names)
    np.testing.assert_array_equal(eng.allowed(names), want)
    np.testing.assert_array_equal(eng.match(names), ref.match(names))
    for i, name in enumerate(names):
        assert eng.allowed_one(name) == bool(want[i]) == \
            ref.allowed_one(name), name
        canon = name.lower().rstrip(".")
        expect = len(canon) <= dns.MAX_NAME_LEN and any(
            oracle_match(s.to_regex(), canon.encode())
            for s in FQDN_SELECTORS)
        assert bool(want[i]) == expect, name
    np.testing.assert_array_equal(eng.encode(names), ref.encode(names))
    packed = eng.encode_packed(names)
    np.testing.assert_array_equal(
        eng.match_encoded(packed.to("cpu"), len(names)),
        ref.match(names))
    for g, w in zip(eng.allowed_pipelined([names[:5], names[5:]]),
                    ref.allowed_pipelined([names[:5], names[5:]])):
        np.testing.assert_array_equal(g, w)
    dispatch, finalize = eng.dispatch_split()
    np.testing.assert_array_equal(finalize(dispatch(names), len(names)),
                                  want)
    if on_accel is None:
        assert eng.engine_report() == ref.engine_report()


def test_dns_without_selectors_matches_reference():
    eng = dns.DNSPolicyEngine([], device="cpu")
    ref = ref_dns.DNSPolicyEngine([])
    np.testing.assert_array_equal(eng.allowed(NAMES), ref.allowed(NAMES))
    assert eng.match(NAMES).shape == ref.match(NAMES).shape == (len(NAMES),
                                                                 0)
    assert not eng.allowed_one("x.example.com")
    assert eng.encode(NAMES) is None and eng.dispatch_split() is None
    assert [a.tolist() for a in eng.allowed_pipelined([NAMES[:2]])] == \
        [[False, False]]
    with pytest.raises(ValueError):
        eng.match_device(None)
    assert dns._canon("A.B.") == ref_dns._canon("A.B.") == "a.b"


def _kafka_frame(api_key, version, client_id, body=b""):
    hdr = struct.pack(">hhi", api_key, version, 1)
    cid = struct.pack(">h", len(client_id)) + client_id.encode()
    payload = hdr + cid + body
    return struct.pack(">i", len(payload)) + payload


def _topics(topics):
    body = struct.pack(">i", len(topics))
    for t in topics:
        body += struct.pack(">h", len(t)) + t.encode()
    return body


def _wire_frames():
    """Metadata (several topics), produce v0 and v3, fetch, offsets,
    offset-commit, an unknown key, a truncated body, and frames the
    parser refuses."""
    yield _kafka_frame(3, 0, "trusted-0", _topics(["logs", "events.page"]))
    yield _kafka_frame(3, 1, "cli", _topics(["logs"]))
    yield _kafka_frame(3, 0, "cli", _topics([]))
    yield _kafka_frame(0, 0, "cli", struct.pack(">hi", 1, 1000) +
                       _topics(["logs"]))
    yield _kafka_frame(0, 3, "client-1", struct.pack(">h", -1) +
                       struct.pack(">hi", 1, 1000) + _topics(["logs"]))
    yield _kafka_frame(1, 2, "client-2", b"\0" * 12 +
                       _topics(["events.page"]))
    yield _kafka_frame(2, 0, "c", b"\0" * 4 + _topics(["events.page"]))
    yield _kafka_frame(8, 0, "c", struct.pack(">h", 2) + b"g1" +
                       _topics(["logs"]))
    yield _kafka_frame(18, 0, "trusted-0")
    yield _kafka_frame(1, 0, "cli", b"\0" * 5)
    yield b"\0\0"
    yield struct.pack(">i", 100) + b"\0" * 10


def test_kafka_verdicts_match_reference():
    eng = kafka.KafkaPolicyEngine(list(KAFKA_RULES))
    ref = ref_kafka.KafkaPolicyEngine([ref_api.PortRuleKafka(
        role=r.role, api_key=r.api_key, api_version=r.api_version,
        client_id=r.client_id, topic=r.topic) for r in KAFKA_RULES])
    reqs = config4_requests(512)
    ref_reqs = [ref_kafka.KafkaRequest(
        api_key=r.api_key, api_version=r.api_version,
        correlation_id=r.correlation_id, client_id=r.client_id,
        topics=list(r.topics)) for r in reqs]
    want = ref.check(ref_reqs)
    assert eng.check(reqs) == want and 0 < sum(want) < len(want)
    assert [eng.allows(r) for r in reqs] == want
    parsed, ref_parsed = [], []
    for frame in _wire_frames():
        try:
            want_req = ref_kafka.parse_kafka_request(frame)
        except ref_kafka.KafkaParseError:
            with pytest.raises(kafka.KafkaParseError):
                kafka.parse_kafka_request(frame)
            continue
        got_req = kafka.parse_kafka_request(frame)
        for f in ("api_key", "api_version", "correlation_id", "client_id",
                  "topics", "raw"):
            assert getattr(got_req, f) == getattr(want_req, f), f
        parsed.append(got_req)
        ref_parsed.append(want_req)
    assert len(parsed) == 10
    got = eng.check(parsed)
    assert got == ref.check(ref_parsed)
    assert True in got and False in got
    assert kafka.KafkaPolicyEngine([]).check(parsed) == [True] * 10
    with pytest.raises(api.PolicyError):
        kafka.KafkaPolicyEngine([api.PortRuleKafka(api_key="nope")])


def test_l7_entry_points_default_to_the_card():
    for call in (lambda: http.HTTPPolicyEngine(list(HTTP_RULES)),
                 lambda: http.HTTPPolicyEngine([]),
                 lambda: dns.DNSPolicyEngine(list(FQDN_SELECTORS)),
                 lambda: dns.DNSPolicyEngine([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
