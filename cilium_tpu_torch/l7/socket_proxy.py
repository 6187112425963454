"""Socket-level L7 proxy data plane.

The round-1 gap this closes: redirects existed only as in-process
engine dispatch on pre-parsed requests.  This module is the real data
plane — a transparent TCP proxy (asyncio in a background thread) that
listens on each redirect's allocated proxy port, connects to the
original destination (resolved via the proxymap analog), and pumps
bytes BOTH directions through the policy machinery:

- generic parser protocols (cassandra/memcached/line/block/...) drive
  the proxylib-contract parser framework (l7/parser.py on_data:
  PASS/DROP/MORE/INJECT/ERROR) over the live stream, with deny frames
  injected back to the client in-protocol;
- kafka gets a dedicated handler mirroring the reference's in-agent Go
  proxy (pkg/proxy/kafka.go:454): per-request ACL checks, synthesized
  typed error responses, and a correlation cache matching responses to
  forwarded requests (pkg/kafka/correlation_cache.go:97) for
  response-path access logging;
- http/1.1 requests are framed (request line + headers +
  Content-Length body), checked against the redirect's HTTPPolicyEngine,
  denied with a 403 in-protocol; responses pass through.

Every request is access-logged through the ProxyManager's AccessLog
(pkg/proxy/logger analog).

A copy of ``cilium_tpu/l7/socket_proxy.py``.  HTTP frames are decided by
the redirect's engine: on the host by its scalar walk (``check_one``),
or, with ``http_batch_window > 0``, micro-batched through a
``VerdictBatcher`` onto the engine's device walk.  ``shutdown`` also
closes the batchers' dispatcher threads.
"""

from __future__ import annotations

import asyncio
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.metrics import PROXY_UPSTREAM_TIME
from .http import HTTPRequest
from .kafka import (KafkaParseError, KafkaRequest, parse_kafka_request)
from .parser import Connection as ParserConnection
from .parser import Op, REGISTRY, ParserRegistry, VerdictBatcher

# Kafka error code injected on deny (reference: pkg/kafka/error-codes).
TOPIC_AUTHORIZATION_FAILED = 29

PRODUCE, FETCH, METADATA = 0, 1, 3


# --------------------------------------------------------------------------
# Kafka response correlation (pkg/kafka/correlation_cache.go:97)

@dataclass
class CorrelationEntry:
    correlation_id: int
    api_key: int
    api_version: int
    topics: List[str]
    sent_at: float


class CorrelationCache:
    """Outstanding forwarded requests, matched to responses by
    correlation id so the response path can be attributed and logged."""

    def __init__(self, capacity: int = 4096):
        self._entries: Dict[int, CorrelationEntry] = {}
        self.capacity = capacity
        self.overflows = 0

    def put(self, req: KafkaRequest) -> None:
        if len(self._entries) >= self.capacity:
            # drop the oldest (the reference expires by correlation
            # window); overflow counted for observability
            oldest = min(self._entries, default=None,
                         key=lambda k: self._entries[k].sent_at)
            if oldest is not None:
                del self._entries[oldest]
                self.overflows += 1
        self._entries[req.correlation_id] = CorrelationEntry(
            correlation_id=req.correlation_id, api_key=req.api_key,
            api_version=req.api_version, topics=list(req.topics),
            sent_at=time.time())

    def correlate(self, correlation_id: int) -> Optional[CorrelationEntry]:
        return self._entries.pop(correlation_id, None)

    def __len__(self):
        return len(self._entries)


def kafka_deny_response(req: KafkaRequest) -> bytes:
    """Typed in-protocol error response for a denied request
    (reference: kafka.go createProduceResponse etc. via sarama)."""
    corr = struct.pack(">i", req.correlation_id)
    topics = req.topics or [""]
    if req.api_key == PRODUCE:
        body = struct.pack(">i", len(topics))
        for t in topics:
            tb = t.encode()
            body += struct.pack(">h", len(tb)) + tb
            #   partitions: [ {partition=0, error=29, offset=-1} ]
            body += struct.pack(">i", 1) + struct.pack(
                ">ihq", 0, TOPIC_AUTHORIZATION_FAILED, -1)
        if req.api_version >= 1:
            body += struct.pack(">i", 0)  # throttle_time_ms
    elif req.api_key == FETCH:
        body = b""
        if req.api_version >= 1:
            body += struct.pack(">i", 0)  # throttle_time_ms
        body += struct.pack(">i", len(topics))
        for t in topics:
            tb = t.encode()
            body += struct.pack(">h", len(tb)) + tb
            #   partitions: [ {partition=0, error=29, hw=-1, empty set} ]
            body += struct.pack(">i", 1) + struct.pack(
                ">ihqi", 0, TOPIC_AUTHORIZATION_FAILED, -1, 0)
    elif req.api_key == METADATA:
        body = struct.pack(">i", 0)  # brokers: []
        body += struct.pack(">i", len(topics))
        for t in topics:
            tb = t.encode()
            #   topic_metadata: {error=29, topic, partitions: []}
            body += struct.pack(">h", TOPIC_AUTHORIZATION_FAILED)
            body += struct.pack(">h", len(tb)) + tb
            body += struct.pack(">i", 0)
    else:
        body = struct.pack(">h", TOPIC_AUTHORIZATION_FAILED)
    payload = corr + body
    return struct.pack(">i", len(payload)) + payload


HTTP_DENY = (b"HTTP/1.1 403 Forbidden\r\n"
             b"content-length: 15\r\n"
             b"content-type: text/plain\r\n"
             b"connection: close\r\n\r\n"
             b"Access denied\r\n")


# --------------------------------------------------------------------------

@dataclass
class ListenerContext:
    """Everything a live listener needs per connection.

    orig_dst: the proxymap analog — maps the accepted client address to
    the flow's original (pre-redirect) destination.
    identities/rules resolve the remote peer for policy + logging.
    """

    redirect_id: str
    parser_type: str
    orig_dst: Callable[[Tuple[str, int]], Tuple[str, int]]
    l7_rules: Callable[[Tuple[str, int]], list] = lambda addr: []
    identities: Callable[[Tuple[str, int]], Tuple[int, int]] = \
        lambda addr: (0, 0)
    http_engine_for: Optional[Callable[[Tuple[str, int]], object]] = None
    kafka_engine_for: Optional[Callable[[Tuple[str, int]], object]] = None


class SocketProxy:
    """Owns the event loop + one TCP listener per active redirect."""

    def __init__(self, access_log=None, registry: ParserRegistry = REGISTRY,
                 host: str = "127.0.0.1", http_batch_window: float = 0.0):
        self.host = host
        self.registry = registry
        self.access_log = access_log
        # live-proxy batch path: with a window > 0, concurrent HTTP
        # frames are micro-batched through the redirect's policy
        # engine (parser.VerdictBatcher) instead of one scalar
        # check_one per frame; 0 keeps the latency-first scalar path
        self.http_batch_window = http_batch_window
        self._http_batchers: Dict[int, Tuple[object, VerdictBatcher]] = {}
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="socket-proxy")
        self._thread.start()
        self._servers: Dict[str, asyncio.AbstractServer] = {}
        self._conn_tasks: set = set()
        self._next_conn_id = 0
        self._lock = threading.Lock()
        # per-redirect accepted-connection counts: the proxy-bound
        # ledger the L7 fast-verdict bench reads — connections the
        # fused on-device stage decided never appear here (the whole
        # point of making redirect-to-proxy the exception)
        self.conn_counts: Dict[str, int] = {}
        # Proxy-mark analog (bpf_netdev.c:128-146 / the reference's
        # SO_MARK on the upstream socket): each upstream connection is
        # registered under its full 4-tuple (local ip, local port,
        # remote ip, remote port) with the ORIGINAL source identity, so
        # the re-entry path can classify proxied flows as their true
        # source instead of the proxy host.  Keyed by the 4-tuple, not
        # the local pair alone: the kernel may reuse a local ephemeral
        # port across sockets with distinct remotes, and a collision
        # would let one connection's teardown erase another's live mark.
        self.conn_marks: Dict[Tuple[str, int, str, int], int] = {}

    def _run(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def _submit(self, coro, timeout=10.0):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    # ---------------------------------------------------------- lifecycle

    def start_listener(self, port: int, ctx: ListenerContext) -> int:
        """Bind the redirect's proxy port; returns the bound port."""
        async def _start():
            server = await asyncio.start_server(
                lambda r, w: self._handle(r, w, ctx),
                host=self.host, port=port)
            self._servers[ctx.redirect_id] = server
            return server.sockets[0].getsockname()[1]
        return self._submit(_start())

    def stop_listener(self, redirect_id: str) -> None:
        async def _stop():
            server = self._servers.pop(redirect_id, None)
            if server is not None:
                server.close()
                await server.wait_closed()
        self._submit(_stop())

    def shutdown(self) -> None:
        for rid in list(self._servers):
            try:
                self.stop_listener(rid)
            except Exception:  # noqa: BLE001
                pass

        async def _cancel_connections():
            # connections still open end here, through their own
            # finally blocks, instead of dying with the loop
            tasks = list(self._conn_tasks)
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            self._submit(_cancel_connections(), timeout=5.0)
        except Exception:  # noqa: BLE001
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
        for _engine, batcher in self._http_batchers.values():
            batcher.close()

    def mark_for(self, upstream_local_addr: Tuple[str, int],
                 upstream_peer_addr: Optional[Tuple[str, int]] = None
                 ) -> int:
        """The identity stamped on an upstream leg — what the netdev
        program reads back from the mark (bpf_netdev.c:128-146).
        0 = no mark (not a proxied flow).  Pass the remote address for
        an exact 4-tuple match; without it the first matching local
        pair is returned (convenience for single-upstream tests)."""
        with self._lock:
            if upstream_peer_addr is not None:
                return self.conn_marks.get(
                    (upstream_local_addr[0], upstream_local_addr[1],
                     upstream_peer_addr[0], upstream_peer_addr[1]), 0)
            for (lip, lport, _rip, _rport), ident in \
                    self.conn_marks.items():
                if (lip, lport) == tuple(upstream_local_addr[:2]):
                    return ident
            return 0

    def _log(self, ctx: ListenerContext, verdict: str, proto: str,
             src_id: int, dst_id: int, info: dict) -> None:
        if self.access_log is None:
            return
        from ..proxy import AccessLogEntry
        self.access_log.log(AccessLogEntry(
            timestamp=time.time(), proxy_id=ctx.redirect_id,
            l7_protocol=proto, verdict=verdict, src_identity=src_id,
            dst_identity=dst_id, info=info))

    # -------------------------------------------------------- connection

    def proxy_stats(self) -> Dict[str, int]:
        """{redirect id: connections accepted} — how much traffic is
        still proxy-bound (vs decided inline by the fast path)."""
        with self._lock:
            return dict(self.conn_counts)

    async def _handle(self, client_r: asyncio.StreamReader,
                      client_w: asyncio.StreamWriter,
                      ctx: ListenerContext) -> None:
        peer = client_w.get_extra_info("peername") or ("", 0)
        # the loop holds tasks weakly: a strong reference keeps a live
        # connection's handler until it ends (or shutdown cancels it)
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        task.add_done_callback(self._conn_tasks.discard)
        with self._lock:
            self.conn_counts[ctx.redirect_id] = \
                self.conn_counts.get(ctx.redirect_id, 0) + 1
        try:
            upstream_host, upstream_port = ctx.orig_dst(peer)
            up_r, up_w = await asyncio.open_connection(upstream_host,
                                                       upstream_port)
        except Exception:  # noqa: BLE001 — no orig dst / upstream down
            client_w.close()
            return
        src_id, dst_id = ctx.identities(peer)
        # stamp the original identity on the upstream leg (SO_MARK
        # analog) for the re-entry classification
        up_local = up_w.get_extra_info("sockname")
        up_peer = up_w.get_extra_info("peername")
        mark_key = None
        if up_local is not None and up_peer is not None:
            mark_key = (up_local[0], up_local[1],
                        up_peer[0], up_peer[1])
            with self._lock:
                self.conn_marks[mark_key] = src_id
        try:
            if ctx.parser_type == "kafka":
                await self._pump_kafka(client_r, client_w, up_r, up_w,
                                       ctx, peer, src_id, dst_id)
            elif ctx.parser_type == "http":
                await self._pump_http(client_r, client_w, up_r, up_w,
                                      ctx, peer, src_id, dst_id)
            else:
                await self._pump_parser(client_r, client_w, up_r, up_w,
                                        ctx, peer, src_id, dst_id)
        finally:
            if mark_key is not None:
                with self._lock:
                    self.conn_marks.pop(mark_key, None)
            for w in (client_w, up_w):
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    pass

    # ------------------------------------------- generic parser protocols

    async def _pump_parser(self, client_r, client_w, up_r, up_w, ctx,
                           peer, src_id, dst_id):
        factory = self.registry.get(ctx.parser_type)
        if factory is None:
            return
        with self._lock:
            self._next_conn_id += 1
            conn_id = self._next_conn_id
        conn = ParserConnection(
            conn_id=conn_id, proto=ctx.parser_type, ingress=True,
            src_identity=src_id, dst_identity=dst_id,
            l7_rules=list(ctx.l7_rules(peer)))
        parser = factory(conn)

        async def request_path():
            buf = b""
            eof = False
            while not eof or buf:
                if not eof:
                    chunk = await client_r.read(65536)
                    if chunk:
                        buf += chunk
                    else:
                        eof = True
                progress = True
                while buf and progress:
                    progress = False
                    ops = parser.on_data(False, eof, buf)
                    for op in ops:
                        if op.op == Op.PASS:
                            up_w.write(buf[:op.n])
                            buf = buf[op.n:]
                            progress = True
                            self._log(ctx, "forwarded", ctx.parser_type,
                                      src_id, dst_id, {"bytes": op.n})
                        elif op.op == Op.DROP:
                            buf = buf[op.n:]
                            progress = True
                            self._log(ctx, "denied", ctx.parser_type,
                                      src_id, dst_id, {"bytes": op.n})
                        elif op.op == Op.INJECT:
                            client_w.write(op.data)
                            await client_w.drain()
                        elif op.op == Op.MORE:
                            break
                        elif op.op == Op.ERROR:
                            raise ConnectionResetError("parser error")
                    await up_w.drain()
                    if eof and not progress:
                        buf = b""  # trailing bytes already judged
            try:
                up_w.write_eof()
            except OSError:
                pass

        async def reply_path():
            buf = b""
            eof = False
            while not eof or buf:
                if not eof:
                    chunk = await up_r.read(65536)
                    if chunk:
                        buf += chunk
                    else:
                        eof = True
                progress = True
                while buf and progress:
                    progress = False
                    ops = parser.on_data(True, eof, buf)
                    for op in ops:
                        if op.op == Op.PASS:
                            client_w.write(buf[:op.n])
                            buf = buf[op.n:]
                            progress = True
                        elif op.op == Op.DROP:
                            buf = buf[op.n:]
                            progress = True
                        elif op.op == Op.INJECT:
                            up_w.write(op.data)
                            await up_w.drain()
                        elif op.op == Op.MORE:
                            break
                        elif op.op == Op.ERROR:
                            raise ConnectionResetError("parser error")
                    await client_w.drain()
                    if eof and not progress:
                        buf = b""
            try:
                client_w.write_eof()
            except OSError:
                pass

        await _run_both(request_path(), reply_path())

    # ----------------------------------------------------------- kafka

    async def _pump_kafka(self, client_r, client_w, up_r, up_w, ctx,
                          peer, src_id, dst_id):
        engine = ctx.kafka_engine_for(peer) if ctx.kafka_engine_for \
            else None
        # Per-connection cache (pkg/proxy/kafka.go:335 allocates one per
        # kafkaRedirect connection): correlation ids are a client-chosen
        # per-connection namespace, so a proxy-wide cache would let two
        # clients with colliding ids mis-attribute each other's responses.
        correlation = CorrelationCache()

        async def request_path():
            buf = b""
            while True:
                frame, buf = await _read_kafka_frame(client_r, buf)
                if frame is None:
                    break
                try:
                    req = parse_kafka_request(frame)
                except KafkaParseError:
                    # unparseable: fail closed when rules exist
                    if engine is not None and engine.rules:
                        raise ConnectionResetError("bad kafka frame")
                    up_w.write(frame)
                    await up_w.drain()
                    continue
                allowed = engine.allows(req) if engine is not None \
                    else True
                info = {"api_key": req.api_key, "topics": req.topics,
                        "client_id": req.client_id,
                        "correlation_id": req.correlation_id}
                if allowed:
                    correlation.put(req)
                    up_w.write(frame)
                    await up_w.drain()
                    self._log(ctx, "forwarded", "kafka", src_id, dst_id,
                              info)
                else:
                    client_w.write(kafka_deny_response(req))
                    await client_w.drain()
                    self._log(ctx, "denied", "kafka", src_id, dst_id,
                              info)
            try:
                up_w.write_eof()
            except OSError:
                pass

        async def reply_path():
            buf = b""
            while True:
                frame, buf = await _read_kafka_frame(up_r, buf)
                if frame is None:
                    break
                if len(frame) >= 8:
                    (corr,) = struct.unpack_from(">i", frame, 4)
                    entry = correlation.correlate(corr)
                    if entry is not None:
                        latency = time.time() - entry.sent_at
                        # upstream reply time (cilium_proxy_upstream_
                        # reply_seconds analog), correlated exactly
                        PROXY_UPSTREAM_TIME.observe(
                            latency, labels={"protocol": "kafka"})
                        self._log(ctx, "response", "kafka", dst_id,
                                  src_id,
                                  {"correlation_id": corr,
                                   "api_key": entry.api_key,
                                   "topics": entry.topics,
                                   "latency_ms": round(
                                       latency * 1000, 2)})
                client_w.write(frame)
                await client_w.drain()
            try:
                client_w.write_eof()
            except OSError:
                pass

        await _run_both(request_path(), reply_path())

    # ------------------------------------------------------------- http

    def _http_batcher(self, engine) -> VerdictBatcher:
        """Per-engine VerdictBatcher (created lazily on the loop
        thread; the engine ref is kept so id() can't be recycled)."""
        ent = self._http_batchers.get(id(engine))
        if ent is None:
            def check_batch(reqs):
                return list(engine.check(reqs))
            # engines with a device program hand the batcher their
            # dispatch/finalize split, so the serving core overlaps
            # host encode with the in-flight device match
            split = engine.dispatch_split() \
                if hasattr(engine, "dispatch_split") else None
            ent = (engine, VerdictBatcher(
                check_batch, max_wait=self.http_batch_window,
                dispatch_split=split, name="http-proxy"))
            self._http_batchers[id(engine)] = ent
        return ent[1]

    async def _pump_http(self, client_r, client_w, up_r, up_w, ctx,
                         peer, src_id, dst_id):
        engine = ctx.http_engine_for(peer) if ctx.http_engine_for \
            else None
        batcher = self._http_batcher(engine) \
            if (self.http_batch_window > 0 and engine is not None) \
            else None
        # forwarded-request timestamps, consumed by the reply path's
        # status-line sampler: HTTP/1.1 responses arrive in request
        # order on one connection, so a FIFO correlates them for the
        # upstream-reply-time histogram (%DURATION% analog).  Both
        # coroutines run on the same loop — no locking needed.
        from collections import deque as _deque
        sent_at: "_deque[float]" = _deque(maxlen=256)

        async def request_path():
            buf = b""
            while True:
                head, buf = await _read_http_head(client_r, buf)
                if head is None:
                    break
                request_line, headers, raw_head = head
                try:
                    method, path, _version = request_line.split(" ", 2)
                except ValueError:
                    raise ConnectionResetError("bad request line")
                chunked = False
                te = headers.get("transfer-encoding")
                if te is not None:
                    # the only encoding framed here is a bare final
                    # "chunked"; anything stacked ("gzip, chunked") or
                    # unknown is a framing ambiguity -> fail closed.
                    # TE+CL together is the classic TE.CL smuggling
                    # split-brain (RFC 7230 3.3.3): reset, never pick
                    # one side
                    if te.strip().lower() != "chunked":
                        raise ConnectionResetError(
                            "unsupported transfer-encoding")
                    if "content-length" in headers:
                        raise ConnectionResetError(
                            "content-length with chunked")
                    chunked = True
                req = HTTPRequest(method=method, path=path,
                                  host=headers.get("host", ""),
                                  headers=dict(headers))
                if batcher is not None:
                    allowed = await batcher.check(req)
                elif engine is not None:
                    allowed = engine.check_one(req)
                else:
                    allowed = True
                info = {"method": method, "path": path,
                        "host": headers.get("host", "")}
                if not allowed:
                    client_w.write(HTTP_DENY)
                    await client_w.drain()
                    self._log(ctx, "denied", "http", src_id, dst_id,
                              info)
                    # consume the remainder of the denied request's
                    # body (bounded) so the close is a clean FIN:
                    # closing with unread bytes in the receive buffer
                    # RSTs, and an RST can discard the 403 before the
                    # client reads it
                    try:
                        if chunked:
                            await _forward_chunked(
                                client_r, buf, _DISCARD,
                                max_bytes=DENY_DRAIN_MAX)
                        else:
                            remaining = _content_length(headers) \
                                - len(buf)
                            allowance = DENY_DRAIN_MAX
                            while remaining > 0 and allowance > 0:
                                chunk = await client_r.read(
                                    min(65536, remaining))
                                if not chunk:
                                    break
                                remaining -= len(chunk)
                                allowance -= len(chunk)
                    except ConnectionResetError:
                        pass
                    raise ConnectionResetError("denied: close")
                if chunked:
                    # forward the verified head, then re-frame the body
                    # chunk by chunk: upstream only ever sees bytes this
                    # proxy serialized itself, so its framing cannot
                    # diverge from the one the policy check used
                    up_w.write(raw_head)
                    buf = await _forward_chunked(client_r, buf, up_w)
                    await up_w.drain()
                    sent_at.append(time.perf_counter())
                else:
                    body_len = _content_length(headers)
                    while len(buf) < body_len:
                        chunk = await client_r.read(65536)
                        if not chunk:
                            raise ConnectionResetError("truncated body")
                        buf += chunk
                    body, buf = buf[:body_len], buf[body_len:]
                    up_w.write(raw_head + body)
                    await up_w.drain()
                    sent_at.append(time.perf_counter())
                self._log(ctx, "forwarded", "http", src_id, dst_id,
                          info)
            try:
                up_w.write_eof()
            except OSError:
                pass

        async def reply_path():
            from .http import parse_status_line
            head_buf = b""
            while True:
                chunk = await up_r.read(65536)
                if not chunk:
                    break
                # Response-status sampling for the Hubble HTTP metrics
                # (%RESPONSE_CODE% analog): status lines that start a
                # chunk are parsed; mid-chunk pipelined continuations
                # stream through unsampled — counters, not framing,
                # ride on this
                if head_buf or chunk.startswith(b"HTTP/"):
                    head_buf = (head_buf + chunk)[:256]
                    nl = head_buf.find(b"\r\n")
                    if nl >= 0:
                        status = parse_status_line(head_buf[:nl])
                        if status is not None:
                            if sent_at:
                                # upstream reply time: forwarded
                                # request -> its status line
                                PROXY_UPSTREAM_TIME.observe(
                                    time.perf_counter() -
                                    sent_at.popleft(),
                                    labels={"protocol": "http"})
                            self._log(ctx, "response", "http", dst_id,
                                      src_id, {"status": status})
                        head_buf = b""
                    elif len(head_buf) >= 256:
                        head_buf = b""
                client_w.write(chunk)
                await client_w.drain()
            try:
                client_w.write_eof()
            except OSError:
                pass

        await _run_both(request_path(), reply_path())


async def _run_both(req_coro, rep_coro):
    """Run both pumps; first exception cancels the peer."""
    tasks = [asyncio.ensure_future(req_coro),
             asyncio.ensure_future(rep_coro)]
    try:
        await asyncio.gather(*tasks)
    except (ConnectionResetError, ConnectionError, asyncio.IncompleteReadError,
            OSError):
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


async def _read_kafka_frame(reader: asyncio.StreamReader,
                            buf: bytes) -> Tuple[Optional[bytes], bytes]:
    """One size-prefixed Kafka frame (request or response)."""
    while len(buf) < 4:
        chunk = await reader.read(65536)
        if not chunk:
            return None, buf
        buf += chunk
    (size,) = struct.unpack_from(">i", buf, 0)
    if size < 0 or size > (64 << 20):
        raise ConnectionResetError("bad kafka frame size")
    total = 4 + size
    while len(buf) < total:
        chunk = await reader.read(65536)
        if not chunk:
            return None, buf
        buf += chunk
    return buf[:total], buf[total:]


_HEX_DIGITS = frozenset(b"0123456789abcdefABCDEF")
# RFC 7230 token charset, for strict trailer-field-name validation
_TOKEN_CHARS = frozenset(
    b"!#$%&'*+-.^_`|~0123456789"
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
MAX_CHUNK_BYTES = 64 << 20
MAX_TRAILER_LINES = 32
# how much of a denied request's body the proxy will read off the wire
# to deliver the 403 over a clean FIN before giving up and resetting
DENY_DRAIN_MAX = 4 << 20


async def _read_crlf_line(reader: asyncio.StreamReader, buf: bytes,
                          limit: int = 8192) -> Tuple[bytes, bytes]:
    """One CRLF-terminated line (line without CRLF, leftover).  A bare
    LF is NOT accepted as a terminator: lenient line endings are
    exactly the parser disagreement smuggling rides on."""
    while b"\r\n" not in buf:
        if len(buf) > limit:
            raise ConnectionResetError("oversized line")
        chunk = await reader.read(65536)
        if not chunk:
            raise ConnectionResetError("truncated chunked body")
        buf += chunk
    line, rest = buf.split(b"\r\n", 1)
    if len(line) > limit:
        raise ConnectionResetError("oversized line")
    return line, rest


class _DiscardSink:
    """Writer-shaped null sink for draining a denied request's body."""

    def write(self, _data) -> None:
        pass

    async def drain(self) -> None:
        pass


_DISCARD = _DiscardSink()


async def _forward_chunked(reader: asyncio.StreamReader, buf: bytes,
                           up_w, max_bytes: Optional[int] = None
                           ) -> bytes:
    """Strictly parse one chunked request body and forward a canonical
    re-serialization (the reference rides Envoy's codec, which frames
    chunked bodies the same way: envoy/cilium_l7policy.cc:127 only ever
    sees codec-framed requests).  Fail-closed rules:

    - chunk-size line: 1-16 hex digits, nothing else — chunk
      extensions (``;name=value``) are rejected outright, as are
      signs, whitespace, and bare-LF line endings;
    - every chunk's data must be followed by exactly CRLF;
    - trailers after the 0-chunk are strictly parsed (token ``:``
      value), bounded, and DISCARDED — framing- or routing-critical
      fields arriving after the policy check can never reach upstream.

    Chunk data is streamed upstream in read-sized pieces once its size
    line is validated (no per-chunk buffering — a chunk may be up to
    MAX_CHUNK_BYTES).  A framing violation discovered mid-chunk resets
    the connection, leaving upstream with an unterminated body it can
    never mistake for a complete request.

    ``max_bytes`` bounds the total body (used by the deny-path drain
    into ``_DISCARD``); exceeding it resets.  Returns the leftover
    bytes after the body (pipelined next request).
    """
    total = 0
    while True:
        line, buf = await _read_crlf_line(reader, buf, limit=32)
        if not line or len(line) > 16 or \
                any(c not in _HEX_DIGITS for c in line):
            raise ConnectionResetError("bad chunk size")
        size = int(line, 16)
        if size > MAX_CHUNK_BYTES:
            raise ConnectionResetError("oversized chunk")
        if size == 0:
            break
        total += size
        if max_bytes is not None and total > max_bytes:
            raise ConnectionResetError("chunked body over budget")
        up_w.write(b"%x\r\n" % size)
        remaining = size
        take = min(len(buf), remaining)
        if take:
            up_w.write(buf[:take])
            buf = buf[take:]
            remaining -= take
        while remaining:
            chunk = await reader.read(min(65536, remaining))
            if not chunk:
                raise ConnectionResetError("truncated chunk")
            up_w.write(chunk)
            remaining -= len(chunk)
            await up_w.drain()
        while len(buf) < 2:
            chunk = await reader.read(65536)
            if not chunk:
                raise ConnectionResetError("truncated chunk")
            buf += chunk
        if buf[:2] != b"\r\n":
            raise ConnectionResetError("chunk data not CRLF-terminated")
        up_w.write(b"\r\n")
        buf = buf[2:]
        await up_w.drain()
    # trailer section: zero or more strict header lines, then empty line
    for _ in range(MAX_TRAILER_LINES + 1):
        line, buf = await _read_crlf_line(reader, buf)
        if not line:
            break
        name, sep, _value = line.partition(b":")
        if not sep or not name or \
                any(c not in _TOKEN_CHARS for c in name):
            raise ConnectionResetError("bad trailer line")
        if name.lower() in (b"content-length", b"transfer-encoding",
                            b"host"):
            raise ConnectionResetError("framing header in trailers")
    else:
        raise ConnectionResetError("too many trailer lines")
    up_w.write(b"0\r\n\r\n")
    return buf


def _content_length(headers: Dict[str, str]) -> int:
    """Strict request-framing length.  Every request byte the proxy
    forwards is framed off this value, so anything ambiguous is a
    smuggling vector and MUST fail closed (the reference delegates this
    to Envoy's codec, which rejects the same inputs): negative values
    would make the read loop skip and ``buf[:body_len]`` mis-frame,
    letting pipelined bytes after an allowed head reach upstream
    unchecked; ``+``/whitespace/hex forms are parser-dependent."""
    raw = headers.get("content-length")
    if raw is None:
        return 0
    # ascii check matters: str.isdigit() accepts latin-1 superscripts
    # ("\xb2") that int() then rejects with a ValueError outside the
    # connection-error handling path
    if not (raw.isascii() and raw.isdigit()):
        # rejects "", "-5", "+5", " 5", "0x10", "5, 5" — digits only
        raise ConnectionResetError("bad content-length")
    return int(raw)


async def _read_http_head(reader: asyncio.StreamReader, buf: bytes):
    """Request line + headers.  Returns ((request_line, headers, raw),
    leftover) or (None, leftover) on clean EOF before a request.

    Duplicate framing-critical headers (Content-Length,
    Transfer-Encoding) fail the connection closed: a last-wins dict
    would silently desync this proxy's framing from the upstream's
    (classic CL.CL request smuggling)."""
    while b"\r\n\r\n" not in buf:
        chunk = await reader.read(65536)
        if not chunk:
            if buf:
                raise ConnectionResetError("truncated http head")
            return None, buf
        buf += chunk
        if len(buf) > (1 << 20):
            raise ConnectionResetError("oversized http head")
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("latin1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        # every head line must be a plain `name: value` — obs-fold
        # continuations (leading SP/HTAB) and colon-less lines are
        # rejected, NOT skipped: raw_head is forwarded verbatim, so a
        # line this parser ignores but the upstream honors (e.g. a
        # folded "\tgzip" extending Transfer-Encoding) would desync
        # the two framings (request smuggling)
        if line[:1] in (" ", "\t") or ":" not in line:
            raise ConnectionResetError("malformed header line")
        k, v = line.split(":", 1)
        key = k.strip().lower()
        if key in headers and key in ("content-length",
                                      "transfer-encoding"):
            raise ConnectionResetError(f"duplicate {key}")
        headers[key] = v.strip()
    return (lines[0], headers, head + b"\r\n\r\n"), rest
