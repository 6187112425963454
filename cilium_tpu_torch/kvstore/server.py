"""TCP kvstore server — the control plane's real network transport.

A whole copy of ``cilium_tpu/kvstore/server.py``.

Round 1's "distributed" control plane never crossed a process boundary:
every agent shared one in-process MemStore.  This server puts the
MemStore behind a socket with etcd-shaped semantics (reference:
pkg/kvstore/etcd.go — leases, atomic CreateOnly/CreateIfExists, prefix
watches, distributed locks), so separate agent *processes* share one
store and the allocator/ipcache/node protocols run over the wire.

Wire protocol: 4-byte big-endian length + JSON.
  request : {"id": n, "op": "...", ...args}   (values base64)
  response: {"id": n, "ok": bool, ...result}
  event   : {"watch_id": w, "typ": ..., "key": ..., "value_b64": ...}

Sessions are leases: each connection starts one with a TTL; the client
keeps it alive with renew_lease.  A killed client (kill -9) stops
renewing; when the TTL lapses the server reaps the session and its
lease-backed keys vanish — watchers on other connections see the
deletes (allocator.go:88-89 semantics).
"""

from __future__ import annotations

import base64
import json
import queue
import socket
import socketserver
import struct
import threading
import uuid
from typing import Dict, Optional, Tuple

from ..utils.netio import recv_exact as _recv_exact
from .backend import Event, KVLockError, Lock, Watcher
from .memory import InMemoryBackend, MemStore

DEFAULT_PORT = 42379  # etcd's 2379, out of the privileged/common range

# Per-connection in-flight bound for *blocking* ops (lock acquisition).
# Fast ops are dispatched inline on the reader thread, so the reader is
# only ever parked in recv_frame — it sees client EOF promptly and
# finish() releases held locks/watches eagerly.  Lock requests past the
# bound fail fast with a lock error instead of queuing daemon threads.
MAX_INFLIGHT = 64

# Server-side cap on the client-requested lock acquisition timeout, so a
# hostile client can't park dispatch threads forever.
MAX_LOCK_TIMEOUT = 120.0


def send_frame(sock: socket.socket, obj: dict,
               lock: Optional[threading.Lock] = None) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    frame = struct.pack(">I", len(data)) + data
    if lock:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = struct.unpack(">I", hdr)
    if length > (64 << 20):
        raise ValueError(f"frame too large: {length}")
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return json.loads(body)


def _b64(value: bytes) -> str:
    return base64.b64encode(value).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class _Conn(socketserver.BaseRequestHandler):
    """One client connection: a session + its watches and locks."""

    def setup(self):
        self.server_obj: "KVStoreServer" = self.server.kv_server
        self.store: MemStore = self.server_obj.store
        # ops delegate to a per-connection InMemoryBackend session, so
        # lease/CAS/lock semantics live in exactly one place
        # (memory.py); this handler only does wire marshaling + watch
        # forwarding
        self.backend: Optional[InMemoryBackend] = None
        # dlock guards watches/locks/finished: dispatch threads insert
        # concurrently with finish() tearing down
        self.dlock = threading.Lock()
        self.finished = False
        # watch_id -> (Watcher, forwarder thread)
        self.watches: Dict[int, Tuple[Watcher, threading.Thread]] = {}
        # lock_id -> Lock handle
        self.locks: Dict[str, Lock] = {}
        # client-supplied lock_ref bookkeeping for abandoned waits:
        # refs with an acquisition still in flight, refs the client
        # aborted before the grant arrived, and ref -> lock_id for
        # aborts that race past the grant.  aborted_refs only ever
        # holds refs still in pending_refs, so it cannot leak.
        self.pending_refs: set = set()
        self.aborted_refs: set = set()
        self.granted_refs: Dict[str, str] = {}
        self._inflight = threading.BoundedSemaphore(MAX_INFLIGHT)
        # Single-writer outgoing queue: responses and watch events never
        # contend on the socket, so a watch forwarder stuck behind a
        # slow consumer cannot stall the reader thread's inline
        # dispatches (keepalives keep flowing).  A consumer that lets
        # the queue fill for SEND_TIMEOUT is evicted (connection
        # closed), like the reference monitor's lossy per-subscriber
        # queues (monitor/main.go send path).
        self.out_q: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=1024)
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True, name="kv-writer")
        self._writer.start()

    SEND_TIMEOUT = 5.0

    def _write_loop(self) -> None:
        while True:
            try:
                obj = self.out_q.get(timeout=0.5)
            except queue.Empty:
                if self.finished:
                    return
                continue
            if obj is None:
                return
            try:
                send_frame(self.request, obj)
            except OSError:
                return

    def handle(self):
        self.request.settimeout(None)
        while True:
            try:
                req = recv_frame(self.request)
            except (ValueError, OSError):
                break
            if req is None:
                break
            if req.get("op") == "lock":
                # only lock acquisition may block long; it runs on its
                # own thread so keepalives keep flowing, bounded so a
                # flood fails fast instead of growing a thread per frame
                if self._inflight.acquire(blocking=False):
                    threading.Thread(target=self._dispatch,
                                     args=(req, True),
                                     daemon=True).start()
                else:
                    self._respond({"id": req.get("id"), "ok": False,
                                   "error": "too many pending locks",
                                   "kind": "lock"})
            else:
                # fast ops run inline: the reader thread is otherwise
                # always parked in recv_frame, so EOF -> finish() is
                # prompt even while lock threads wait
                self._dispatch(req, False)

    def _respond(self, resp: dict) -> bool:
        """Enqueue a frame for the writer thread.  A consumer whose
        queue stays full for SEND_TIMEOUT is evicted."""
        try:
            self.out_q.put(resp, timeout=self.SEND_TIMEOUT)
            return True
        except queue.Full:
            try:
                self.request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return False

    def _dispatch(self, req: dict, holds_slot: bool) -> None:
        rid = req.get("id")
        try:
            result = self._handle_op(req)
            resp = {"id": rid, "ok": True}
            if result:
                resp.update(result)
        except KVLockError as e:
            resp = {"id": rid, "ok": False, "error": str(e),
                    "kind": "lock"}
        except Exception as e:  # noqa: BLE001 — wire back, don't die
            resp = {"id": rid, "ok": False, "error": repr(e)}
        finally:
            if holds_slot:
                self._inflight.release()
        self._respond(resp)

    # ------------------------------------------------------------- ops

    def _handle_op(self, req: dict) -> Optional[dict]:
        op = req["op"]
        if op == "hello":
            self.backend = InMemoryBackend(
                self.store, lease_ttl=float(req.get("ttl", 15.0)))
            return {"session": self.backend.session}
        be = self.backend
        if be is None:
            raise ValueError("hello required first")
        if op == "renew_lease":
            be.renew_lease()
            return None
        if op == "get":
            v = be.get(req["key"])
            return {"missing": True} if v is None else {"value_b64": _b64(v)}
        if op == "get_prefix":
            v = be.get_prefix(req["prefix"])
            return {"missing": True} if v is None else {"value_b64": _b64(v)}
        if op == "set":
            be.set(req["key"], _unb64(req["value_b64"]),
                   lease=bool(req.get("lease")))
            return None
        if op == "delete":
            be.delete(req["key"])
            return None
        if op == "delete_prefix":
            be.delete_prefix(req["prefix"])
            return None
        if op == "create_only":
            return {"created": be.create_only(
                req["key"], _unb64(req["value_b64"]),
                lease=bool(req.get("lease")))}
        if op == "create_if_exists":
            return {"created": be.create_if_exists(
                req["cond_key"], req["key"], _unb64(req["value_b64"]),
                lease=bool(req.get("lease")))}
        if op == "list_prefix":
            return {"items": {k: _b64(v) for k, v in
                              be.list_prefix(req["prefix"]).items()}}
        if op in ("watch", "list_and_watch"):
            return self._start_watch(req, initial=(op == "list_and_watch"))
        if op == "unwatch":
            self._stop_watch(req["watch_id"])
            return None
        if op == "lock":
            timeout = min(float(req.get("timeout", 30.0)),
                          MAX_LOCK_TIMEOUT)
            lock_ref = req.get("lock_ref")
            if lock_ref is not None:
                with self.dlock:
                    self.pending_refs.add(lock_ref)
            try:
                lock = be.lock_path(req["path"], timeout=timeout)
            except KVLockError:
                with self.dlock:
                    self.pending_refs.discard(lock_ref)
                    self.aborted_refs.discard(lock_ref)
                raise
            lock_id = uuid.uuid4().hex
            with self.dlock:
                self.pending_refs.discard(lock_ref)
                if self.finished:
                    pass  # fall through: connection died while we waited
                elif lock_ref is not None and \
                        lock_ref in self.aborted_refs:
                    # client gave up (its own wait timed out) before the
                    # grant: release instead of stranding a lock the
                    # client has no handle to
                    self.aborted_refs.discard(lock_ref)
                else:
                    self.locks[lock_id] = lock
                    if lock_ref is not None:
                        self.granted_refs[lock_ref] = lock_id
                    return {"lock_id": lock_id}
            lock.unlock()
            raise KVLockError("lock wait abandoned")
        if op == "abort_lock":
            # client-side lock wait timed out; whether the grant already
            # happened decides which side releases
            ref = req["lock_ref"]
            held = None
            with self.dlock:
                lock_id = self.granted_refs.pop(ref, None)
                if lock_id is not None:
                    held = self.locks.pop(lock_id, None)
                elif ref in self.pending_refs:
                    # only mark refs with an acquisition still in
                    # flight; anything else would leak forever
                    self.aborted_refs.add(ref)
            if held:
                held.unlock()
            return None
        if op == "unlock":
            with self.dlock:
                held = self.locks.pop(req["lock_id"], None)
                self.granted_refs = {r: lid for r, lid
                                     in self.granted_refs.items()
                                     if lid != req["lock_id"]}
            if held:
                held.unlock()
            return None
        if op == "status":
            return {"text": be.status().replace("in-memory", "remote", 1)}
        raise ValueError(f"unknown op {op!r}")

    # ----------------------------------------------------------- watches

    def _start_watch(self, req: dict, initial: bool) -> dict:
        watch_id = int(req["watch_id"])
        prefix = req["prefix"]
        watcher = Watcher(prefix, _WatchHost(self.store))
        with self.store.mu:
            if initial:
                self.store.expire_sessions()
                for key in sorted(self.store.data):
                    if key.startswith(prefix):
                        watcher._emit(Event("create", key,
                                            self.store.data[key][0]))
                watcher._emit(Event("list-done"))
            self.store.watchers.append((prefix, watcher))

        def forward():
            for ev in watcher:
                if not self._respond({"watch_id": watch_id,
                                      "typ": ev.typ, "key": ev.key,
                                      "value_b64": _b64(ev.value)}):
                    return

        t = threading.Thread(target=forward, daemon=True)
        t.start()
        with self.dlock:
            if self.finished:
                watcher.stop()
                raise ValueError("connection closed")
            self.watches[watch_id] = (watcher, t)
        return {}

    def _stop_watch(self, watch_id: int) -> None:
        with self.dlock:
            entry = self.watches.pop(int(watch_id), None)
        if entry:
            entry[0].stop()

    def finish(self):
        with self.dlock:
            self.finished = True
            watches = list(self.watches.values())
            self.watches.clear()
            locks = list(self.locks.values())
            self.locks.clear()
            self.granted_refs.clear()
            self.aborted_refs.clear()
            self.pending_refs.clear()
        try:
            self.out_q.put_nowait(None)  # stop the writer
        except queue.Full:
            pass  # writer exits via the finished flag
        for watcher, _t in watches:
            watcher.stop()
        # held locks die with the connection (eager release avoids a
        # stuck allocator waiting a full TTL)
        for lock in locks:
            try:
                lock.unlock()
            except Exception:  # noqa: BLE001
                pass
        # the backend is NOT closed here: its session lives until the
        # TTL lapses, exactly like an etcd lease after the client
        # vanishes (close() would expire the lease immediately)


class _WatchHost:
    """Adapter so server-side Watchers can detach from the MemStore."""

    def __init__(self, store: MemStore):
        self.store = store

    def _remove_watcher(self, watcher: Watcher) -> None:
        with self.store.mu:
            self.store.watchers = [(p, w) for p, w in self.store.watchers
                                   if w is not watcher]


class _ThreadingTCP(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class KVStoreServer:
    """The store + listener.  start() binds and serves in background."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: Optional[MemStore] = None,
                 expire_interval: float = 0.2):
        self.store = store if store is not None else MemStore()
        self._tcp = _ThreadingTCP((host, port), _Conn)
        self._tcp.kv_server = self
        self.host, self.port = self._tcp.server_address
        self._serve_thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True, name="kv-server")
        self._expire_interval = expire_interval
        self._stop = threading.Event()
        self._expirer = threading.Thread(target=self._expire_loop,
                                         daemon=True, name="kv-expirer")

    def start(self) -> "KVStoreServer":
        self._serve_thread.start()
        self._expirer.start()
        return self

    def _expire_loop(self):
        # leases must lapse even when no client issues requests —
        # that's the whole point of detecting a kill -9'd agent
        while not self._stop.wait(self._expire_interval):
            with self.store.mu:
                self.store.expire_sessions()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._stop.set()
        self._tcp.shutdown()
        self._tcp.server_close()
