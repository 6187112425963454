"""Network verdict service: remote peers stream packet-header batches,
the card answers verdicts.

Port of ``cilium_tpu/verdict_service.py``, same wire protocol and peer
authentication.  Any ingest point (another node's datapath, a proxy, a
capture pipeline) ships header batches over TCP to a card-backed
classifier.  Per connection, two-tier ingest feeding the engine's
shared serving lane:

  reader thread --> C++ SPSC PacketRing --> drain thread --> shared
   (socket recv,      (native/runtime.cc,     (drains up to   serving
    raw records        lock-free, SoA          max_batch,     dispatcher
    pushed as           drain)                 submits a      (datapath/
    received)                                  ticket, keeps   serving.py)
                                               2 in flight)

Small frames from chatty clients coalesce in the ring, so the card sees
large batches whatever the clients' write sizes; responses return per
frame, in order (SPSC preserves FIFO, and serving tickets resolve in
submission order).  Concurrent connections, and every other caller of
the serving lane, coalesce into one launch.

Wire protocol — 12-byte headers are big-endian; the record payload is
the native PKT_HEADER_DTYPE layout (little-endian fields, 24B/record,
ABI-checked against the C++ struct):
  request : u32 0xC111A901 | u32 frame_id | u32 count |
            count * 24B PKT_HEADER_DTYPE records
  request+payload (L7 fast-verdict lane):
            u32 0xC111A903 | u32 frame_id | u32 count | u32 window |
            count * 24B records | count * window u8 payload bytes
            (0xFF = padding, 0xFE = window-truncation poison — L7
            match strings are ASCII, so both are unambiguous)
  response: u32 0xC111A902 | u32 frame_id | u32 count |
            count * i32 verdict (big-endian) |
            count * i32 identity (big-endian)

Payload-carrying frames feed the engine's L7 fast-verdict stage; plain
frames (and frames against an engine without fast verdicts) redirect
every L7 rule to its proxy port.  Batches round up to a power-of-two
bucket with pad rows copied from the first real record (they cannot
mint conntrack keys); pad results are sliced off.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

from .datapath.serving import VerdictDispatcher
from .native import PKT_HEADER_DTYPE, PacketRing, load
from .utils.netio import recv_exact as _recv_exact
from .utils.netio import recv_exact_within as _recv_exact_within

MAGIC_REQ = 0xC111A901
MAGIC_RESP = 0xC111A902
MAGIC_REQ_PL = 0xC111A903   # records + L7 payload lane
MAGIC_AUTH = 0xC111A9A1     # server challenge frame
MAGIC_AUTH_OK = 0xC111A9A2  # server accept frame
MAX_COUNT = 1 << 20
MAX_PAYLOAD_WINDOW = 4096   # wire bound on the per-record L7 window

# wire payload byte markers (match strings are ASCII, so the top two
# byte values are free): 0xFF = -1 padding, 0xFE = -2 poison
_PL_PAD = 0xFF
_PL_POISON = 0xFE


def pack_wire_payloads(strings, window: int) -> np.ndarray:
    """Host helper: per-record L7 match strings -> the [n, window]
    uint8 wire payload block.  None entries stay all-padding (absent
    -> redirect); overlong strings are poisoned whole-row (the server
    decodes them to the -2 fail-to-redirect convention)."""
    n = len(strings)
    out = np.full((n, window), _PL_PAD, np.uint8)
    for i, s in enumerate(strings):
        if s is None:
            continue
        b = s.encode() if isinstance(s, str) else bytes(s)
        if len(b) > window:
            out[i] = _PL_POISON
        elif b:
            out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return out


def _decode_wire_payloads(raw: bytes, count: int,
                          window: int) -> np.ndarray:
    """Wire block -> the engine's [n, W] int32 payload convention."""
    pl = np.frombuffer(raw, np.uint8).astype(np.int32)
    pl = pl.reshape(count, window)
    pl[pl == _PL_PAD] = -1
    pl[pl == _PL_POISON] = -2
    return pl

# per-connection ticket pipeline depth: how many serving tickets a
# connection keeps outstanding before blocking on the oldest — matches
# the serving dispatcher's double-buffer depth
PIPELINE_DEPTH = 2


class VerdictServiceError(RuntimeError):
    pass


class VerdictService:
    """Serves a Datapath over TCP: one ring + drain thread per
    connection, all submitting into the engine's shared continuous
    micro-batching dispatcher (datapath/serving.py) so concurrent
    connections share device launches instead of serializing on the
    engine lock."""

    def __init__(self, datapath, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 1 << 15,
                 secret: "bytes | None" = None,
                 handshake_timeout: float = 5.0,
                 frame_timeout: float = 30.0,
                 submit_deadline_s: "float | None" = None):
        load()  # the ring is mandatory here; fail at construction
        # Peer authentication: the reference keeps equivalent surfaces
        # on unix sockets or localhost; a cross-node bind here REQUIRES
        # a shared secret (challenge-response HMAC on connect) — fail
        # closed rather than trust the network
        if secret is not None and not secret:
            # an empty key is an HMAC any peer can compute — worse
            # than no auth, because the operator believes auth is on
            raise ValueError("verdict service secret must be "
                             "non-empty")
        if host not in ("127.0.0.1", "localhost", "::1") and \
                not secret:
            raise ValueError(
                f"binding verdict service on {host!r} requires a "
                f"shared secret (secret=...); only loopback may run "
                f"unauthenticated")
        self.secret = secret
        self.datapath = datapath
        self.max_batch = max_batch
        # a silent peer must never pin a server thread: the handshake
        # runs under a short deadline, and once a frame header
        # arrives, its payload must follow within frame_timeout
        self.handshake_timeout = handshake_timeout
        self.frame_timeout = frame_timeout
        # optional per-submission serving deadline: expired work is
        # shed fail-closed by the dispatcher's admission control (the
        # resulting ticket error drops the connection — fail fast)
        self.submit_deadline_s = submit_deadline_s
        self.frames_served = 0
        self._stats_lock = threading.Lock()  # one drain thread per conn
        # device work goes through the engine's SHARED serving
        # dispatcher (all callers coalesce) unless this service wants
        # smaller device batches than the shared lane allows — then it
        # runs a private lane at its own max_batch
        shared = datapath.serving() if hasattr(datapath, "serving") \
            else None
        if shared is not None and max_batch >= shared.max_batch:
            self._dispatcher = shared
        else:
            self._dispatcher = VerdictDispatcher(
                datapath, max_batch=max_batch, lane="verdict-service")
        self._batches_base = self._dispatcher.batches
        svc = self

        class _Conn(socketserver.BaseRequestHandler):
            def handle(self):
                svc._serve_conn(self.request)

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _TCP((host, port), _Conn)
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------- per-connection

    def _authenticate(self, sock: socket.socket) -> bool:
        """Challenge-response: send a fresh nonce, require
        HMAC-SHA256(secret, nonce) back (replay-proof; the secret
        never crosses the wire).  Constant-time compare.  The whole
        exchange runs under ``handshake_timeout`` — a peer that
        connects and goes silent is dropped, not a pinned thread —
        and the deadline is cleared only after MAGIC_AUTH_OK."""
        import hmac as _hmac
        import os as _os
        nonce = _os.urandom(16)
        try:
            sock.settimeout(self.handshake_timeout)
            sock.sendall(struct.pack(">I", MAGIC_AUTH) + nonce)
            answer = _recv_exact(sock, 32)
        except OSError:
            return False
        if answer is None:
            return False
        want = _hmac.new(self.secret, nonce, "sha256").digest()
        if not _hmac.compare_digest(want, answer):
            return False
        try:
            sock.sendall(struct.pack(">I", MAGIC_AUTH_OK))
            sock.settimeout(None)
        except OSError:
            return False
        return True

    def _serve_conn(self, sock: socket.socket) -> None:
        if self.secret is not None and not self._authenticate(sock):
            try:
                sock.close()
            except OSError:
                pass
            return
        ring = PacketRing(capacity=1 << 16)
        # (frame_id, remaining count, remaining payload rows or None);
        # the ring carries records only, so the payload lane rides
        # this host-side queue aligned to the frame coverage
        frames: "deque[Tuple[int, int, object]]" = deque()
        frames_lock = threading.Lock()
        eof = threading.Event()
        wake = threading.Event()
        dead = threading.Event()  # dispatcher exited (error or EOF)

        def dispatcher():
            # (ticket, covers): covers maps the submitted records back
            # to wire frames — computed at submit time (coverage is
            # independent of verdict values), resolved at completion.
            # Up to PIPELINE_DEPTH tickets stay outstanding so this
            # connection's drain+submit of batch N+1 overlaps batch
            # N's device walk — the per-connection double buffer on
            # top of the shared dispatcher's own.
            inflight: "deque[Tuple[object, list]]" = deque()

            def complete_one():
                ticket, covers = inflight.popleft()
                verdicts, idents = ticket.result()
                if ticket.error is not None:
                    # the serving tier failed closed (those frames are
                    # denials); this service's contract is stronger:
                    # drop the connection so the client fails fast
                    raise VerdictServiceError(
                        f"serving dispatch failed: {ticket.error!r}")
                for fid, s, e, partial in covers:
                    item = (fid, verdicts[s:e], idents[s:e])
                    self._send_resp(sock,
                                    item + (True,) if partial else item,
                                    partials)

            try:
                while True:
                    if getattr(self._dispatcher, "overloaded", False):
                        # admission push-back: stop draining while the
                        # serving lane is above its high watermark —
                        # records stay queued in the SPSC ring, the
                        # reader stalls when it fills, and TCP
                        # backpressures the client instead of the
                        # dispatcher queuing (and shedding) our work
                        if inflight:
                            complete_one()
                        else:
                            wake.wait(0.01)
                            wake.clear()
                        continue
                    with frames_lock:
                        have = len(frames) > 0
                    if not have:
                        if inflight:
                            complete_one()
                            continue
                        if eof.is_set():
                            return
                        wake.wait(0.05)
                        wake.clear()
                        continue
                    soa, n = ring.pop_batch(self.max_batch)
                    if n == 0:
                        if inflight:
                            complete_one()
                            continue
                        wake.wait(0.005)
                        wake.clear()
                        continue
                    # frame coverage of this drain, claimed up front
                    covers = []
                    pl_parts = []  # (start row, payload rows)
                    off = 0
                    with frames_lock:
                        while frames and off + frames[0][1] <= n:
                            fid, cnt, fpl = frames.popleft()
                            covers.append((fid, off, off + cnt, False))
                            if fpl is not None:
                                pl_parts.append((off, fpl[:cnt]))
                            off += cnt
                        if off != n:
                            # drain split a frame: its tail is still in
                            # the ring; stash the head
                            fid, cnt, fpl = frames.popleft()
                            took = n - off
                            frames.appendleft(
                                (fid, cnt - took,
                                 None if fpl is None else fpl[took:]))
                            covers.append((fid, off, n, True))
                            if fpl is not None:
                                pl_parts.append((off, fpl[:took]))
                    payload = None
                    if pl_parts:
                        # assemble the drain's payload block; frames
                        # without one stay absent (-1 -> redirect)
                        wmax = max(b.shape[1] for _s, b in pl_parts)
                        payload = np.full((n, wmax), -1, np.int32)
                        for s, blk in pl_parts:
                            payload[s:s + blk.shape[0],
                                    :blk.shape[1]] = blk
                    # pop_batch returned fresh arrays — safe to hand
                    # to the dispatcher thread without copying
                    inflight.append(
                        (self._dispatcher.submit_records(
                            soa, n, deadline=self.submit_deadline_s,
                            payload=payload),
                         covers))
                    while len(inflight) >= PIPELINE_DEPTH:
                        complete_one()
            except Exception:  # noqa: BLE001 — send failure or e.g.
                # "no policy loaded" mid-rebuild: a dead dispatcher
                # must not leave the client hanging until its timeout
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            finally:
                dead.set()  # unblocks a reader stuck on a full ring

        # partial-frame reassembly buffer: frame_id -> [verdicts, ids]
        partials = {}

        t = threading.Thread(target=dispatcher, daemon=True,
                             name="verdict-dispatch")
        t.start()
        try:
            while True:
                head = _recv_exact(sock, 12)
                if head is None:
                    break
                magic, frame_id, count = struct.unpack(">III", head)
                if magic not in (MAGIC_REQ, MAGIC_REQ_PL) or \
                        count == 0 or count > MAX_COUNT:
                    break  # protocol error: drop the connection
                window = 0
                if magic == MAGIC_REQ_PL:
                    whead = _recv_exact_within(sock, 4,
                                               self.frame_timeout)
                    if whead is None:
                        break
                    (window,) = struct.unpack(">I", whead)
                    if window == 0 or window > MAX_PAYLOAD_WINDOW:
                        break
                # the header committed the peer to a payload: it must
                # arrive within the frame deadline (idle BETWEEN
                # frames stays unbounded — a healthy quiet client is
                # fine; a half-frame stall is a dead peer)
                raw = _recv_exact_within(
                    sock, count * PKT_HEADER_DTYPE.itemsize,
                    self.frame_timeout)
                if raw is None:
                    break
                fpl = None
                if window:
                    rawpl = _recv_exact_within(sock, count * window,
                                               self.frame_timeout)
                    if rawpl is None:
                        break
                    fpl = _decode_wire_payloads(rawpl, count, window)
                recs = np.frombuffer(raw, PKT_HEADER_DTYPE)
                with frames_lock:
                    frames.append((frame_id, count, fpl))
                pushed = 0
                while pushed < count:
                    if dead.is_set():
                        return  # nobody will ever drain the ring
                    got = ring.push(recs[pushed:], drop_on_full=False)
                    pushed += got
                    wake.set()
                    if not got:          # ring full: give the
                        time.sleep(0.001)  # dispatcher room to drain
        finally:
            eof.set()
            wake.set()
            t.join(timeout=5)
            if not t.is_alive():
                ring.close()
            # else: dispatcher still running (a long first call / blocked
            # send) — the ring is freed by its __del__ once the thread
            # exits; destroying it now would be a native use-after-free

    def _send_resp(self, sock, item, partials) -> None:
        if len(item) == 4:            # head of a split frame: buffer it
            fid, v, i, _partial = item
            acc = partials.setdefault(fid, [[], []])
            acc[0].append(v)
            acc[1].append(i)
            return
        fid, v, i = item
        if fid in partials:
            acc = partials.pop(fid)
            v = np.concatenate(acc[0] + [v])
            i = np.concatenate(acc[1] + [i])
        payload = struct.pack(">III", MAGIC_RESP, fid, len(v)) + \
            v.astype(">i4").tobytes() + i.astype(">i4").tobytes()
        with self._stats_lock:    # before send: a synchronous client
            self.frames_served += 1  # may read the counter on response
        sock.sendall(payload)

    # --------------------------------------------------------- lifecycle

    @property
    def batches_dispatched(self) -> int:
        """Device launches on this service's serving lane since the
        service was constructed (the shared lane also counts other
        callers' launches — batching health, not an exact ledger)."""
        return self._dispatcher.batches - self._batches_base

    def serving_stats(self) -> dict:
        """The serving dispatcher's coalescing/error counters."""
        return self._dispatcher.stats()

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "VerdictService":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="verdict-service")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        # a private lane dies with the service; the engine's shared
        # lane keeps serving other callers
        if self._dispatcher is not getattr(self.datapath, "_serving",
                                           None):
            self._dispatcher.close()


class VerdictClient:
    """Blocking client: ship PKT_HEADER_DTYPE record batches, get
    (verdicts, identities) back.  Pipelinable: frame ids correlate."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 secret: "bytes | None" = None):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._next_id = 0
        self._lock = threading.Lock()
        if secret is not None:
            self._handshake(secret)

    def _handshake(self, secret: bytes) -> None:
        import hmac as _hmac
        head = _recv_exact(self._sock, 4 + 16)
        if head is None or \
                struct.unpack(">I", head[:4])[0] != MAGIC_AUTH:
            raise VerdictServiceError("expected auth challenge")
        self._sock.sendall(
            _hmac.new(secret, head[4:], "sha256").digest())
        ack = _recv_exact(self._sock, 4)
        if ack is None or \
                struct.unpack(">I", ack)[0] != MAGIC_AUTH_OK:
            raise VerdictServiceError("authentication rejected")

    def classify(self, records: np.ndarray, payloads=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """``payloads`` (optional) rides the L7 fast-verdict lane: a
        list of per-record match strings/bytes (None = absent) or a
        pre-packed [n, W] uint8 block (pack_wire_payloads)."""
        recs = np.ascontiguousarray(records, PKT_HEADER_DTYPE)
        if len(recs) == 0:   # the server treats count=0 as a protocol
            return (np.empty(0, np.int32),   # error — short-circuit
                    np.empty(0, np.int32))
        pl = None
        if payloads is not None:
            pl = payloads if isinstance(payloads, np.ndarray) else \
                pack_wire_payloads(list(payloads), 64)
            if pl.shape[0] != len(recs):
                raise ValueError("payload rows != record count")
            pl = np.ascontiguousarray(pl, np.uint8)
        with self._lock:
            fid = self._next_id
            self._next_id += 1
            if pl is None:
                self._sock.sendall(
                    struct.pack(">III", MAGIC_REQ, fid, len(recs)) +
                    recs.tobytes())
            else:
                self._sock.sendall(
                    struct.pack(">IIII", MAGIC_REQ_PL, fid, len(recs),
                                pl.shape[1]) +
                    recs.tobytes() + pl.tobytes())
            head = _recv_exact(self._sock, 12)
            if head is None:
                raise VerdictServiceError("connection closed")
            magic, rid, count = struct.unpack(">III", head)
            if magic != MAGIC_RESP or rid != fid:
                raise VerdictServiceError(
                    f"bad response (magic={magic:#x} id={rid})")
            body = _recv_exact(self._sock, count * 8)
            if body is None:
                raise VerdictServiceError("truncated response")
            v = np.frombuffer(body[:count * 4], ">i4").astype(np.int32)
            i = np.frombuffer(body[count * 4:], ">i4").astype(np.int32)
            return v, i

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
