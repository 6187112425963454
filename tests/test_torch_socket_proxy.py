"""The port's socket proxy against the JAX package's, on live TCP.

Every exchange runs twice: the same client bytes through a JAX
``SocketProxy`` and through a port ``SocketProxy``, each in front of its
own loopback upstream; the bytes the client gets back and the bytes the
upstream receives must be equal (tolerance 0: bytes).  Covered: the
memcached stream (the generic parser pump), the Kafka ACL and
correlation exchange, HTTP allow / deny and the chunked-framing matrix
of ``tests/test_http_chunked.py``.  The port alone: the pipelined
request after a chunked body, the batched tier (``http_batch_window``)
against the scalar tier and its fail-closed rule, proxy-mark re-entry
through the port's ``Datapath``, the verdict-to-socket chain and the
``ProxyManager`` redirect lifecycle.

Every read waits on the bytes it expects, on EOF, or on the upstream's
connection having ended, each under a deadline of a few seconds, never
on a fixed drain; every proxy and upstream is torn down in a
``finally`` or a fixture.
"""

import asyncio
import socket
import socketserver
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cilium_tpu.l7 import http as ref_http
from cilium_tpu.l7 import kafka as ref_kafka
from cilium_tpu.l7 import socket_proxy as ref_sp
from cilium_tpu.l7.parser import PortRuleL7 as RefPortRuleL7
from cilium_tpu.policy import api as ref_api
from cilium_tpu import proxy as ref_proxy

from cilium_tpu_torch import proxy as port_proxy
from cilium_tpu_torch.l7 import http as port_http
from cilium_tpu_torch.l7 import kafka as port_kafka
from cilium_tpu_torch.l7 import socket_proxy as port_sp
from cilium_tpu_torch.l7.parser import PortRuleL7, VerdictBatcher
from cilium_tpu_torch.policy import api as port_api

DEADLINE = 5.0

REF = SimpleNamespace(
    name="jax", sp=ref_sp, PortRuleL7=RefPortRuleL7,
    PortRuleHTTP=ref_api.PortRuleHTTP, PortRuleKafka=ref_api.PortRuleKafka,
    KafkaPolicyEngine=ref_kafka.KafkaPolicyEngine,
    http_engine=lambda rules: ref_http.HTTPPolicyEngine(rules),
    AccessLog=ref_proxy.AccessLog)
PORT = SimpleNamespace(
    name="port", sp=port_sp, PortRuleL7=PortRuleL7,
    PortRuleHTTP=port_api.PortRuleHTTP, PortRuleKafka=port_api.PortRuleKafka,
    KafkaPolicyEngine=port_kafka.KafkaPolicyEngine,
    http_engine=lambda rules: port_http.HTTPPolicyEngine(rules,
                                                         device="cpu"),
    AccessLog=port_proxy.AccessLog)


# --------------------------------------------------------------- upstream

class Upstream(socketserver.ThreadingTCPServer):
    """Records what each connection receives; ``reply(buf)`` returns
    (bytes consumed, reply) over the connection's unconsumed bytes, so
    replies do not depend on how the proxy split its writes."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, reply=lambda buf: (0, b"")):
        self.reply = reply
        self.cond = threading.Condition()
        self.received = []
        self.peers = []
        self.accepted = 0
        self.finished = 0
        super().__init__(("127.0.0.1", 0), _UpHandler)
        self._thread = threading.Thread(target=self.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self.server_address[1]

    def blob(self) -> bytes:
        with self.cond:
            return b"".join(self.received)

    def wait_done(self, connections: int, timeout: float = DEADLINE) -> bool:
        """Until ``connections`` upstream legs have been accepted and
        every accepted leg has ended (the proxy closes its upstream leg
        when the client's connection ends)."""
        with self.cond:
            return self.cond.wait_for(
                lambda: self.accepted >= connections and
                self.finished == self.accepted, timeout)

    def wait_for(self, needle: bytes, timeout: float = DEADLINE) -> bool:
        with self.cond:
            return self.cond.wait_for(
                lambda: needle in b"".join(self.received), timeout)

    def close(self):
        self.shutdown()
        self.server_close()


class _UpHandler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        with srv.cond:
            srv.accepted += 1
            srv.peers.append(self.client_address)
            srv.cond.notify_all()
        buf = b""
        try:
            while True:
                try:
                    data = self.request.recv(65536)
                except OSError:
                    return
                if not data:
                    return
                with srv.cond:
                    srv.received.append(data)
                    srv.cond.notify_all()
                buf += data
                while True:
                    used, out = srv.reply(buf)
                    if not used:
                        break
                    buf = buf[used:]
                    if out:
                        self.request.sendall(out)
        finally:
            with srv.cond:
                srv.finished += 1
                srv.cond.notify_all()


OK_RESPONSE = b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n\r\nok"


def http_replier(buf):
    """One 200 per complete request (Content-Length or chunked body)."""
    end = buf.find(b"\r\n\r\n")
    if end < 0:
        return 0, b""
    head = buf[:end].lower()
    rest = end + 4
    if b"transfer-encoding: chunked" in head:
        term = buf.find(b"0\r\n\r\n", rest)
        if term < 0:
            return 0, b""
        return term + 5, OK_RESPONSE
    length = 0
    for line in head.split(b"\r\n")[1:]:
        if line.startswith(b"content-length:"):
            length = int(line.split(b":", 1)[1])
    if len(buf) < rest + length:
        return 0, b""
    return rest + length, OK_RESPONSE


def memcached_replier(buf):
    nl = buf.find(b"\r\n")
    return (nl + 2, b"END\r\n") if nl >= 0 else (0, b"")


def kafka_replier(buf):
    """One response frame (correlation id, error 0) per request frame."""
    if len(buf) < 4:
        return 0, b""
    (size,) = struct.unpack_from(">i", buf, 0)
    if len(buf) < 4 + size:
        return 0, b""
    (corr,) = struct.unpack_from(">i", buf, 8)
    payload = struct.pack(">ih", corr, 0)
    return 4 + size, struct.pack(">i", len(payload)) + payload


# ----------------------------------------------------------------- client

def connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=DEADLINE)
    s.settimeout(0.2)
    return s


def read_until(sock, token=None, timeout=DEADLINE) -> bytes:
    """Until ``token`` (or each of a tuple of tokens) is in what was
    read; None: until EOF or reset."""
    deadline = time.time() + timeout
    tokens = token if isinstance(token, tuple) else (token,)
    buf = b""
    while time.time() < deadline:
        if token is not None and all(t in buf for t in tokens):
            break
        try:
            chunk = sock.recv(65536)
        except socket.timeout:
            continue
        except OSError:
            break
        if not chunk:
            break
        buf += chunk
    return buf


def exchange(port, steps, upstream, connections=1):
    """Run ``steps`` [(bytes or [pieces], token or None)] on one
    connection; returns (bytes the client read, bytes upstream got)."""
    c = connect(port)
    got = b""
    try:
        for send, token in steps:
            for piece in (send if isinstance(send, list) else [send]):
                try:
                    c.sendall(piece)
                except OSError:
                    break
                if isinstance(send, list):
                    time.sleep(0.005)
            got += read_until(c, token)
    finally:
        c.close()
    assert upstream.wait_done(connections), "upstream leg never ended"
    return got, upstream.blob()


def both(scenario):
    """``scenario(pkg, proxy)`` on the JAX and on the port proxy."""
    out = {}
    for pkg in (REF, PORT):
        proxy = pkg.sp.SocketProxy(access_log=pkg.AccessLog())
        try:
            out[pkg.name] = scenario(pkg, proxy)
        finally:
            proxy.shutdown()
    return out["jax"], out["port"]


# ------------------------------------------------- generic (memcached)

def test_memcached_stream_matches_reference():
    def run(pkg, proxy):
        upstream = Upstream(memcached_replier)
        try:
            ctx = pkg.sp.ListenerContext(
                redirect_id="1:ingress:TCP:11211", parser_type="memcache",
                orig_dst=lambda peer: ("127.0.0.1", upstream.port),
                l7_rules=lambda peer: [pkg.PortRuleL7.from_dict(
                    {"command": "get", "key": "sess:*"})],
                identities=lambda peer: (101, 202))
            port = proxy.start_listener(0, ctx)
            got = exchange(port, [(b"get sess:42\r\n", b"END\r\n"),
                                  (b"get secret:1\r\n", b"\r\n"),
                                  (b"get sess:7\r\nget x\r\n",
                                   (b"SERVER_ERROR", b"\r\nEND\r\n"))],
                           upstream)
            log = [(e.verdict, e.src_identity, e.dst_identity)
                   for e in proxy.access_log.tail()]
            return got, log
        finally:
            upstream.close()

    want, got = both(run)
    assert got == want
    (client, up), log = got
    assert b"END\r\n" in client and b"SERVER_ERROR" in client
    assert b"get sess:42\r\n" in up and b"secret" not in up
    assert ("denied", 101, 202) in log and ("forwarded", 101, 202) in log


# ------------------------------------------------------------- kafka

def kafka_request(api_key, corr, topic, client=b"cli", version=0):
    body = struct.pack(">hhi", api_key, version, corr)
    body += struct.pack(">h", len(client)) + client
    if api_key == 0:  # produce: acks, timeout, topics
        body += struct.pack(">hi", 1, 1000)
        body += struct.pack(">i", 1)
        body += struct.pack(">h", len(topic)) + topic
        body += struct.pack(">i", 0)  # partitions: []
    return struct.pack(">i", len(body)) + body


def test_kafka_acl_and_correlation_match_reference():
    def run(pkg, proxy):
        upstream = Upstream(kafka_replier)
        engine = pkg.KafkaPolicyEngine([pkg.PortRuleKafka(
            api_key="produce", topic="allowed-topic")])
        try:
            ctx = pkg.sp.ListenerContext(
                redirect_id="2:egress:TCP:9092", parser_type="kafka",
                orig_dst=lambda peer: ("127.0.0.1", upstream.port),
                kafka_engine_for=lambda peer: engine)
            port = proxy.start_listener(0, ctx)
            steps = [(kafka_request(0, 7, b"allowed-topic"),
                      struct.pack(">i", 7)),
                     (kafka_request(0, 9, b"forbidden-topic"),
                      struct.pack(">i", 9)),
                     (kafka_request(0, 11, b"allowed-topic", version=1) +
                      kafka_request(0, 12, b"other", version=1),
                      struct.pack(">i", 11))]
            got = exchange(port, steps, upstream)
            entries = proxy.access_log.tail()
            log = [(e.verdict, e.info.get("correlation_id"))
                   for e in entries]
            return got, sorted(log)
        finally:
            upstream.close()

    want, got = both(run)
    assert got == want
    (client, up), log = got
    assert struct.pack(">h", port_sp.TOPIC_AUTHORIZATION_FAILED) in client
    assert b"forbidden-topic" not in up and b"other" not in up
    assert ("response", 7) in log and ("denied", 9) in log


@pytest.mark.parametrize("seed", [0, 1])
def test_kafka_deny_response_and_correlation_cache_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(64):
        api_key = int(rng.choice([0, 1, 3, 10, 18]))
        version = int(rng.integers(0, 3))
        corr = int(rng.integers(-(1 << 31), 1 << 31))
        topics = [f"t{int(t)}" for t in
                  rng.integers(0, 5, int(rng.integers(0, 4)))]
        mine = port_kafka.KafkaRequest(api_key=api_key, api_version=version,
                                       correlation_id=corr, topics=topics,
                                       client_id="c")
        ref = ref_kafka.KafkaRequest(api_key=api_key, api_version=version,
                                     correlation_id=corr, topics=topics,
                                     client_id="c")
        frame = port_sp.kafka_deny_response(mine)
        assert frame == ref_sp.kafka_deny_response(ref)
        (size,) = struct.unpack_from(">i", frame, 0)
        assert len(frame) == 4 + size
        assert struct.unpack_from(">i", frame, 4)[0] == corr
    caches = (port_sp.CorrelationCache(capacity=8),
              ref_sp.CorrelationCache(capacity=8))
    ids = [int(i) for i in rng.integers(0, 40, 60)]
    for i in ids:
        for cache, mod in zip(caches, (port_kafka, ref_kafka)):
            cache.put(mod.parse_kafka_request(kafka_request(0, i, b"t")))
            time.sleep(0.0005)   # distinct sent_at, the eviction order
    assert [len(c) for c in caches] == [len(caches[1])] * 2
    assert caches[0].overflows == caches[1].overflows > 0
    for i in range(40):
        a, b = (c.correlate(i) for c in caches)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.api_key, a.topics) == (b.api_key, b.topics)


# -------------------------------------------------------------- http

def http_ctx(pkg, upstream, rules):
    engine = pkg.http_engine([pkg.PortRuleHTTP(**r) for r in rules])
    return pkg.sp.ListenerContext(
        redirect_id="r:ingress:TCP:80", parser_type="http",
        orig_dst=lambda peer: ("127.0.0.1", upstream.port),
        http_engine_for=lambda peer: engine)


def run_http(steps, rules=({"path": "/public/.*"},), connections=1):
    def run(pkg, proxy):
        upstream = Upstream(http_replier)
        try:
            port = proxy.start_listener(0, http_ctx(pkg, upstream, rules))
            return exchange(port, steps, upstream, connections)
        finally:
            upstream.close()
    return both(run)


def test_http_allow_deny_matches_reference():
    rules = ({"method": "GET", "path": "/public/.*"},)
    ok = (b"GET /public/index.html HTTP/1.1\r\nHost: site\r\n"
          b"content-length: 0\r\n\r\n", b"ok")
    body = (b"GET /public/b HTTP/1.1\r\nHost: site\r\n"
            b"content-length: 5\r\n\r\nhello", b"ok")
    deny = (b"POST /admin HTTP/1.1\r\nHost: site\r\n"
            b"content-length: 3\r\n\r\nabc", None)
    want, got = run_http([ok, body, deny], rules)
    assert got == want
    client, up = got
    assert client.count(b"200 OK") == 2 and b"403" in client
    assert b"/admin" not in up and b"hello" in up


HEAD_CHUNKED = (b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n")
SECRET = b"GET /secret HTTP/1.1\r\n\r\n"
CHUNKED = {
    "valid": [(HEAD_CHUNKED + b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n",
               b"ok")],
    "split": [([(HEAD_CHUNKED + b"b\r\nhello world\r\n0\r\n\r\n")[i:i + 7]
                for i in range(0, 85, 7)], b"ok")],
    "te-cl": [(b"POST /public/a HTTP/1.1\r\nHost: h\r\nContent-Length: 4\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n" + SECRET,
               None)],
    "missing-crlf": [(HEAD_CHUNKED + b"5\r\nhelloXX" + SECRET, None)],
    "trailers-dropped": [(HEAD_CHUNKED + b"2\r\nhi\r\n0\r\n"
                          b"X-Checksum: abc123\r\n\r\n", b"ok")],
    "framing-trailer": [(HEAD_CHUNKED + b"2\r\nhi\r\n0\r\n"
                         b"Content-Length: 99\r\n\r\n" + SECRET, None)],
    "denied-chunked": [(b"POST /secret HTTP/1.1\r\nHost: h\r\n"
                        b"Transfer-Encoding: chunked\r\n\r\n"
                        b"5\r\nhello\r\n0\r\n\r\n", None)],
}
for _te in (b"gzip, chunked", b"xchunked", b"chunked, identity",
            b"chu\tnked"):
    CHUNKED["stacked-te:" + _te.decode()] = [(
        b"POST /public/a HTTP/1.1\r\nHost: h\r\nTransfer-Encoding: " + _te +
        b"\r\n\r\n0\r\n\r\n", None)]
for _i, _head in enumerate((
        b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
        b"Transfer-Encoding: chunked\r\n\tgzip\r\n\r\n",
        b"POST /public/a HTTP/1.1\r\nHost: h\r\n"
        b"Content-Length: 5\r\n colon-less junk\r\n\r\n")):
    CHUNKED[f"obs-fold:{_i}"] = [(_head + b"0\r\n\r\n" + SECRET, None)]
for _bad in (b"+5", b"5;ext=1", b" 5", b"5 ", b"0x5", b"",
             b"ffffffffffffffffff", b"5\n"):
    CHUNKED["chunk-size:" + repr(_bad)] = [(
        HEAD_CHUNKED + _bad + b"\r\nhello\r\n0\r\n\r\n" + SECRET, None)]
for _t in (b"no-colon-here", b": empty-name", b"sp ace: v"):
    CHUNKED["trailer:" + _t.decode()] = [(
        HEAD_CHUNKED + b"2\r\nhi\r\n0\r\n" + _t + b"\r\n\r\n" + SECRET,
        None)]


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_matrix_matches_reference(case):
    want, got = run_http(CHUNKED[case])
    assert got == want
    client, up = got
    assert b"secret" not in up
    if case in ("valid", "split", "trailers-dropped"):
        assert b"200 OK" in client and up.endswith(b"0\r\n\r\n")
        assert b"X-Checksum" not in up
    if case == "denied-chunked":
        assert b"403" in client and not up


def test_pipelined_request_after_chunked_body_is_denied():
    """Bytes after a valid chunked body are the next request, not body
    spill: the port denies it (403 to the client) and nothing of it
    reaches the upstream, whose connection has ended before it is
    read."""
    proxy = port_sp.SocketProxy(access_log=port_proxy.AccessLog())
    upstream = Upstream(http_replier)
    try:
        port = proxy.start_listener(0, http_ctx(PORT, upstream,
                                                ({"path": "/public/.*"},)))
        client, up = exchange(port, [(
            HEAD_CHUNKED + b"5\r\nhello\r\n0\r\n\r\n"
            b"GET /secret HTTP/1.1\r\nHost: h\r\n\r\n", None)], upstream)
    finally:
        proxy.shutdown()
        upstream.close()
    assert b"POST /public/a" in up and b"5\r\nhello\r\n0\r\n\r\n" in up
    assert b"secret" not in up
    assert b"403 Forbidden" in client
    verdicts = [e.verdict for e in proxy.access_log.tail()]
    assert "forwarded" in verdicts and "denied" in verdicts


# ------------------------------------------------------ batched tier

def concurrent_gets(port, expect):
    """One connection a path of ``expect`` {path: allowed}, all at once;
    each reads to the upstream's reply, or to EOF after a deny.  Returns
    {path: response}."""
    out = {}

    def one(path):
        c = connect(port)
        try:
            c.sendall(f"GET {path} HTTP/1.1\r\nHost: s\r\n"
                      f"content-length: 0\r\n\r\n".encode())
            out[path] = read_until(c, b"ok" if expect[path] else None)
        finally:
            c.close()

    threads = [threading.Thread(target=one, args=(p,)) for p in expect]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * DEADLINE)
    return out


@pytest.mark.parametrize("clients", [12, 32])
def test_batched_tier_answers_as_the_scalar_tier(clients):
    rng = np.random.default_rng(clients)
    engine = port_http.HTTPPolicyEngine(
        [port_api.PortRuleHTTP(method="GET", path="/public/.*"),
         port_api.PortRuleHTTP(method="GET", path="/api/v[0-9]+/.*")],
        device="cpu")
    paths = [["/public/", "/admin/", "/api/v2/", "/api/vX/"][int(k)] +
             str(i) for i, k in enumerate(rng.integers(0, 4, clients))]
    scalar = {p: engine.check_one(port_http.HTTPRequest("GET", p, "s"))
              for p in paths}
    assert 0 < sum(scalar.values()) < clients
    upstream = Upstream(http_replier)
    proxy = port_sp.SocketProxy(http_batch_window=0.002)
    try:
        ctx = port_sp.ListenerContext(
            redirect_id="b:ingress:TCP:80", parser_type="http",
            orig_dst=lambda peer: ("127.0.0.1", upstream.port),
            http_engine_for=lambda peer: engine)
        port = proxy.start_listener(0, ctx)
        got = concurrent_gets(port, scalar)
        _eng, batcher = proxy._http_batchers[id(engine)]
        stats = batcher.stats()
    finally:
        proxy.shutdown()
        upstream.close()
    assert len(got) == clients
    for p in paths:
        assert (b"200 OK" in got[p]) == scalar[p], p
        assert (b"403" in got[p]) == (not scalar[p]), p
    assert stats["checked"] == clients and stats["errors"] == 0
    assert 1 <= stats["batches"] <= clients


class _BrokenEngine:
    """An engine whose batched check raises."""

    rules = [object()]

    def check(self, requests):
        raise RuntimeError("device lost")


def test_a_failed_dispatch_denies_every_frame_of_its_batch():
    engine = _BrokenEngine()
    upstream = Upstream(http_replier)
    proxy = port_sp.SocketProxy(http_batch_window=0.002)
    try:
        ctx = port_sp.ListenerContext(
            redirect_id="f:ingress:TCP:80", parser_type="http",
            orig_dst=lambda peer: ("127.0.0.1", upstream.port),
            http_engine_for=lambda peer: engine)
        port = proxy.start_listener(0, ctx)
        paths = [f"/public/{i}" for i in range(8)]
        got = concurrent_gets(port, dict.fromkeys(paths, False))
        _eng, batcher = proxy._http_batchers[id(engine)]
        errors, checked = batcher.errors, batcher.checked
    finally:
        proxy.shutdown()
        upstream.close()
    assert all(b"403" in got[p] for p in paths), got
    assert checked == 8 and errors >= 1
    assert b"GET" not in upstream.blob()


def test_verdict_batcher_fails_closed_and_pushes_back():
    """The batcher itself: a raising split dispatch denies every item
    of its batch and counts an error; an overloaded lane denies at
    once."""
    def dispatch(items):
        raise RuntimeError("launch failed")

    calls = []
    batcher = VerdictBatcher(lambda items: [True] * len(items),
                             max_wait=0.002,
                             dispatch_split=(dispatch, lambda h, n: h))
    ok = VerdictBatcher(lambda items: calls.append(len(items)) or
                        [i % 2 == 0 for i in items], max_wait=0.002)

    async def main():
        failed = await asyncio.gather(*[batcher.check(i) for i in range(6)])
        good = await asyncio.gather(*[ok.check(i) for i in range(6)])
        return failed, good

    try:
        failed, good = asyncio.run(main())
        assert failed == [False] * 6 and batcher.errors >= 1
        assert good == [True, False] * 3 and ok.errors == 0
        assert sum(calls) == 6 and ok.stats()["checked"] == 6
        ok._core.overloaded = True
        assert asyncio.run(ok.check(0)) is False
    finally:
        batcher.close()
        ok.close()


# ----------------------------------------------------------- re-entry

def test_reentry_identity_through_the_port_proxy():
    """The upstream leg of a proxied memcached connection carries the
    source identity (``mark_for``); fed to ``mark_identity`` the port's
    ``Datapath`` classifies the flow as that identity and allows it,
    where the unmarked twin is WORLD and denied; the mark is gone after
    close."""
    from cilium_tpu_torch.datapath.engine import Datapath, make_full_batch
    from cilium_tpu_torch.policy.mapstate import (INGRESS, PolicyKey,
                                                  PolicyMapState,
                                                  PolicyMapStateEntry)
    st = PolicyMapState()
    st[PolicyKey(identity=777, dest_port=9000, nexthdr=6,
                 direction=INGRESS)] = PolicyMapStateEntry()
    dp = Datapath(ct_slots=1 << 8, ct_probe=4, device="cpu")
    dp.load_policy([st], revision=1, ipcache_prefixes={})
    upstream = Upstream(memcached_replier)
    proxy = port_sp.SocketProxy()
    c = None
    try:
        ctx = port_sp.ListenerContext(
            redirect_id="9:ingress:TCP:9000", parser_type="memcache",
            orig_dst=lambda peer: ("127.0.0.1", upstream.port),
            l7_rules=lambda peer: [PortRuleL7.from_dict(
                {"command": "get", "key": "*"})],
            identities=lambda peer: (777, 888))
        c = connect(proxy.start_listener(0, ctx))
        c.sendall(b"get a\r\n")
        assert b"END" in read_until(c, b"END")
        leg = upstream.peers[-1]
        mark = proxy.mark_for(leg)
        assert mark == 777
        assert proxy.mark_for(leg, ("127.0.0.1", upstream.port)) == 777
        v, _e, ident, _n = dp.process(make_full_batch(
            endpoint=[0, 0], saddr=[leg[0]] * 2, daddr=["10.5.0.2"] * 2,
            sport=[leg[1], leg[1] + 1], dport=[9000, 9000],
            direction=[0, 0], mark_identity=[mark, 0], device="cpu"),
            now=60)
        assert ident.tolist() == [777, 2]
        assert int(v[0]) == 0 and int(v[1]) < 0
    finally:
        if c is not None:
            c.close()
        upstream.wait_done(1)
        proxy.shutdown()
        upstream.close()
    deadline = time.time() + DEADLINE
    while proxy.mark_for(leg) and time.time() < deadline:
        time.sleep(0.02)
    assert proxy.mark_for(leg) == 0 and not proxy.conn_marks
    assert proxy.proxy_stats() == {"9:ingress:TCP:9000": 1}


# ------------------------------------------------ verdict -> socket

def free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_verdict_to_socket_through_the_port():
    """The port's ``VerdictEngine`` answers the proxy port, and the
    listener bound at that port enforces the memcached rule."""
    from cilium_tpu_torch.compiler.policy_tables import compile_endpoints
    from cilium_tpu_torch.datapath.verdict import (VerdictEngine,
                                                   make_packet_batch)
    from cilium_tpu_torch.policy.mapstate import (INGRESS, PolicyKey,
                                                  PolicyMapState,
                                                  PolicyMapStateEntry)
    proxy_port = free_port()
    st = PolicyMapState()
    st[PolicyKey(identity=301, dest_port=11211, nexthdr=6,
                 direction=INGRESS)] = \
        PolicyMapStateEntry(proxy_port=proxy_port)
    eng = VerdictEngine(compile_endpoints([st], revision=1), device="cpu")
    verdict = int(eng(make_packet_batch(
        endpoint=[0], identity=[301], dport=[11211], proto=[6],
        direction=[0], length=[64], device="cpu"))[0])
    assert verdict == proxy_port
    upstream = Upstream(memcached_replier)
    proxy = port_sp.SocketProxy()
    try:
        ctx = port_sp.ListenerContext(
            redirect_id="7:ingress:TCP:11211", parser_type="memcache",
            orig_dst=lambda peer: ("127.0.0.1", upstream.port),
            l7_rules=lambda peer: [PortRuleL7.from_dict(
                {"command": "get", "key": "ok*"})])
        assert proxy.start_listener(verdict, ctx) == proxy_port
        client, up = exchange(verdict, [(b"get secret\r\n", b"\r\n"),
                                        (b"get ok:1\r\n", b"END\r\n")],
                              upstream)
    finally:
        proxy.shutdown()
        upstream.close()
    assert client.startswith(b"SERVER_ERROR") and client.endswith(b"END\r\n")
    assert up == b"get ok:1\r\n"


def test_proxy_manager_activate_and_remove_redirect():
    """Redirect lifecycle drives the data plane: create -> activate (a
    listener on the allocated port; the HTTP engine on the manager's
    device) -> remove (the listener is gone)."""
    from cilium_tpu_torch.policy.api import L7Rules
    from cilium_tpu_torch.policy.l4 import (L4Filter, L7DataMap,
                                            PARSER_TYPE_HTTP,
                                            WILDCARD_SELECTOR)
    l7map = L7DataMap()
    l7map[WILDCARD_SELECTOR] = L7Rules(
        http=[port_api.PortRuleHTTP(method="GET", path="/api/.*")])
    flt = L4Filter(port=8080, protocol="TCP", u8proto=6,
                   l7_parser=PARSER_TYPE_HTTP, l7_rules_per_ep=l7map,
                   ingress=True)
    port = free_port()
    pm = port_proxy.ProxyManager(port_min=port, port_max=port,
                                 device="cpu")
    upstream = Upstream(http_replier)
    try:
        redir = pm.create_or_update_redirect(flt, endpoint_id=5)
        assert redir.proxy_port == port
        bound = pm.activate_redirect(
            redir, orig_dst=lambda peer: ("127.0.0.1", upstream.port),
            identities=lambda peer: (40, 50))
        assert bound == port and pm.dataplane is not None
        client, up = exchange(bound, [(
            b"GET /api/x HTTP/1.1\r\nHost: h\r\ncontent-length: 0\r\n\r\n",
            b"ok"), (b"GET /other HTTP/1.1\r\nHost: h\r\n"
                     b"content-length: 0\r\n\r\n", None)], upstream)
        assert b"200 OK" in client and b"403" in client
        assert b"/api/x" in up and b"/other" not in up
        assert pm.remove_redirect(redir.id)
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", bound), timeout=2).close()
        denied = [e for e in pm.access_log.tail() if e.verdict == "denied"]
        assert denied and denied[0].src_identity == 40
    finally:
        pm.shutdown_dataplane()
        upstream.close()
    assert pm.dataplane is None
