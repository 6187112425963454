"""xDS over the wire: the process boundary for the proxy plane.

Reference: pkg/envoy/server.go:114 StartXDSServer — the agent serves
NPDS (per-endpoint NetworkPolicy) and NPHDS (ip -> identity) streams
over a unix-domain gRPC socket to the out-of-process Envoy; policy
pushes block on client ACKs (AckingResourceMutator).

Here the same versioned cache (``xds.Cache``) is served over
TCP with the kvstore framing (4-byte length + JSON), so the socket
proxy can run as a SEPARATE supervised process that subscribes,
applies, and ACKs — and the agent's push barrier spans the process
boundary.

Wire protocol (all frames JSON):
  client -> {"op": "subscribe", "type_url": T, "client": name}
  server -> {"push": T, "version": V, "resources": {...}}   (stream)
  client -> {"op": "ack", "type_url": T, "version": V}
  client -> {"op": "nack", "type_url": T, "version": V, "detail": d}

A whole copy of ``cilium_tpu/l7/xds_wire.py``: the frames are the
reference's byte for byte, so a client of either package reads a server
of the other.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..kvstore.server import recv_frame, send_frame
from ..xds import Cache, Watch


class _XDSConn(socketserver.BaseRequestHandler):
    """One subscriber connection: N type-url subscriptions, each a
    forwarder thread pumping Watch.next() -> push frames."""

    def setup(self):
        self.cache: Cache = self.server.xds_cache
        self.wlock = threading.Lock()
        self.watches: Dict[str, Watch] = {}
        self.alive = True

    def handle(self):
        while True:
            try:
                req = recv_frame(self.request)
            except (ValueError, OSError):
                break
            if req is None:
                break
            op = req.get("op")
            if op == "subscribe":
                self._subscribe(req["type_url"],
                                req.get("client", "anon"))
                # handshake: the subscriber is now part of every ACK
                # barrier (wait_for_acks snapshots current watches, so
                # an unregistered subscriber would be invisible to it)
                try:
                    send_frame(self.request,
                               {"subscribed": req["type_url"]},
                               self.wlock)
                except OSError:
                    break
            elif op == "ack":
                w = self.watches.get(req["type_url"])
                if w is not None:
                    w.ack(int(req["version"]))
            elif op == "nack":
                w = self.watches.get(req["type_url"])
                if w is not None:
                    w.nack(int(req["version"]),
                           req.get("detail", ""))

    def _subscribe(self, type_url: str, client: str) -> None:
        if type_url in self.watches:
            return
        watch = self.cache.watch(type_url, client)
        self.watches[type_url] = watch

        def forward():
            # initial state counts as the first push (list-then-watch)
            while self.alive:
                vr = watch.next(timeout=0.5)
                if vr is None:
                    continue
                try:
                    send_frame(self.request,
                               {"push": type_url,
                                "version": vr.version,
                                "resources": vr.resources}, self.wlock)
                except OSError:
                    return

        # NOTE: no explicit initial send — the forwarder's first
        # next() already delivers the current version (Watch starts at
        # _delivered=0), and a duplicate push would make the child
        # tear down and rebind live listeners for nothing.
        threading.Thread(target=forward, daemon=True,
                         name=f"xds-fwd-{type_url[-12:]}").start()

    def finish(self):
        self.alive = False
        for w in self.watches.values():
            self.cache.unwatch(w)
            w._notify()  # unblock the forwarder promptly
        self.watches.clear()


class _TCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class XDSWireServer:
    """Serve a Cache to subscriber processes (StartXDSServer analog)."""

    def __init__(self, cache: Cache, host: str = "127.0.0.1",
                 port: int = 0):
        self.cache = cache
        self._tcp = _TCP((host, port), _XDSConn)
        self._tcp.xds_cache = cache
        self.host, self.port = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="xds-server")

    def start(self) -> "XDSWireServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()


class XDSWireClient:
    """Subscriber side (the proxy child's view of the agent)."""

    def __init__(self, port: int, client: str,
                 host: str = "127.0.0.1",
                 connect_timeout: float = 5.0):
        self.client = client
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        # type_url -> handler(version, resources) -> bool (ACK if True)
        self._handlers: Dict[str, Callable[[int, Dict], bool]] = {}
        self._subscribed: Dict[str, threading.Event] = {}
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="xds-client")
        self._reader.start()

    def subscribe(self, type_url: str,
                  handler: Callable[[int, Dict], bool],
                  timeout: float = 10.0) -> None:
        """Handler is called for every push; returning True ACKs the
        version, False NACKs it (apply-then-ack, the Envoy contract).
        Blocks until the server confirms the watch is registered, so a
        returned subscribe means this client is inside every subsequent
        ACK barrier."""
        self._handlers[type_url] = handler
        ev = self._subscribed.setdefault(type_url, threading.Event())
        send_frame(self._sock, {"op": "subscribe", "type_url": type_url,
                                "client": self.client}, self._wlock)
        if not ev.wait(timeout):
            raise TimeoutError(f"subscribe({type_url}) unconfirmed")

    def _read_loop(self):
        try:
            self._read_loop_inner()
        finally:
            # ANY exit — including an unexpected exception on a
            # malformed frame — must wake wait_disconnected(), or the
            # proxy child would serve stale policy forever while
            # holding its ports against the successor's child
            self._closed.set()

    def _read_loop_inner(self):
        while not self._closed.is_set():
            try:
                msg = recv_frame(self._sock)
            except (ValueError, OSError):
                break
            if msg is None:
                break
            if "subscribed" in msg:
                ev = self._subscribed.setdefault(msg["subscribed"],
                                                 threading.Event())
                ev.set()
                continue
            type_url = msg.get("push")
            handler = self._handlers.get(type_url)
            if handler is None:
                continue
            version = int(msg["version"])
            try:
                ok = bool(handler(version, msg.get("resources", {})))
                detail = ""
            except Exception as e:  # noqa: BLE001 — NACK, don't die
                ok, detail = False, repr(e)
            try:
                send_frame(self._sock,
                           {"op": "ack" if ok else "nack",
                            "type_url": type_url, "version": version,
                            "detail": detail}, self._wlock)
            except OSError:
                break

    def wait_disconnected(self, timeout: "float | None" = None) -> bool:
        """Block until the stream is gone (server died, close()).  The
        proxy child's crash-only hook: without the agent's stream it
        would serve stale policy and hold its ports against the
        successor child, so it exits and lets the supervisor respawn."""
        return self._closed.wait(timeout)

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
