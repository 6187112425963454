"""TCP kvstore client: BackendOperations over a socket.

A whole copy of ``cilium_tpu/kvstore/remote.py``.

The client half of kvstore/server.py — a drop-in backend for the
Daemon, so two agent processes converge identities/ipcache/nodes
through a real network transport (reference: pkg/kvstore/etcd.go's
client role).  A background keepalive thread renews the session lease
at ttl/3; if the process dies the lease lapses server-side and its
lease-backed keys vanish.
"""

from __future__ import annotations

import base64
import socket
import threading
from typing import Dict, Optional

from ..observability.tracer import tracer
from ..utils.metrics import KVSTORE_OPERATIONS
from ..utils.resilience import (TRANSPORT_RETRIES, TRANSPORT_VERIFIES,
                                Deadline)
from .backend import (EVENT_LIST_DONE, BackendOperations, Event,
                      KVLockError, Lock, Watcher, register_backend)
from .server import recv_frame, send_frame

DEFAULT_TTL = 15.0

# Default per-request deadline.  An infinite default wait means a dead
# server dispatch thread (or a dropped response frame) wedges the
# calling daemon forever; ops that legitimately block longer — lock
# acquisition — pass an explicit padded _timeout.
DEFAULT_CALL_TIMEOUT = 30.0

# Ops safe to re-send blindly after a timed-out wait: reads return the
# same answer, set/delete converge to the same state.  Everything else
# (CAS creates, lock ops, watch registration, session hello) either
# double-applies or double-registers on a re-send — those surface the
# timeout and let the caller verify.
_IDEMPOTENT_OPS = frozenset({
    "get", "get_prefix", "list_prefix", "set", "delete",
    "delete_prefix", "renew_lease", "status"})


class RemoteError(RuntimeError):
    pass


class RemoteTimeout(RemoteError):
    """The wait for a response frame expired; the request may still be
    executing server-side (the connection is not known dead)."""


class RemoteBackend(BackendOperations):
    name = "remote"

    def __init__(self, host: str = "127.0.0.1", port: int = 42379,
                 lease_ttl: float = DEFAULT_TTL,
                 connect_timeout: float = 5.0,
                 call_timeout: float = DEFAULT_CALL_TIMEOUT):
        self.host, self.port = host, int(port)
        self.lease_ttl = lease_ttl
        self.call_timeout = call_timeout
        self._sock = socket.create_connection((host, self.port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._mu = threading.Lock()
        self._next_id = 0
        self._pending: Dict[int, dict] = {}      # id -> {"ev", "resp"}
        self._watchers: Dict[int, Watcher] = {}  # watch_id -> Watcher
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True, name="kv-reader")
        self._reader.start()
        resp = self._call("hello", ttl=lease_ttl)
        self.session = resp["session"]
        self._keepalive = threading.Thread(target=self._keepalive_loop,
                                           daemon=True,
                                           name="kv-keepalive")
        self._keepalive.start()

    # --------------------------------------------------------- plumbing

    def _read_loop(self):
        while not self._closed.is_set():
            try:
                msg = recv_frame(self._sock)
            except (OSError, ValueError):
                msg = None
            if msg is None:
                break
            if "watch_id" in msg:
                with self._mu:
                    watcher = self._watchers.get(int(msg["watch_id"]))
                if watcher is not None:
                    watcher._emit(Event(
                        msg["typ"], msg.get("key", ""),
                        base64.b64decode(msg.get("value_b64", ""))))
                continue
            with self._mu:
                slot = self._pending.get(msg.get("id"))
            if slot is not None:
                slot["resp"] = msg
                slot["ev"].set()
        # connection lost: mark closed FIRST so no new _call can park a
        # slot that nothing will ever complete, then fail everything
        # pending and end watches
        self._closed.set()
        with self._mu:
            pending = list(self._pending.values())
            watchers = list(self._watchers.values())
            self._pending.clear()
            self._watchers.clear()
        for slot in pending:
            slot.setdefault("resp", {"ok": False,
                                     "error": "connection lost"})
            slot["ev"].set()
        for watcher in watchers:
            watcher._queue.put(None)

    def _keepalive_loop(self):
        interval = max(0.2, self.lease_ttl / 3.0)
        while not self._closed.wait(interval):
            try:
                self._call("renew_lease")
                ok = True
            except RemoteError:
                ok = False
            listener = self.keepalive_listener
            if listener is not None:
                try:
                    listener(ok)
                except Exception:  # noqa: BLE001 — observer only
                    pass
            if not ok:
                return

    def _call(self, op: str, _timeout: Optional[float] = None,
              **args) -> dict:
        """One request with a deadline.  Idempotent ops split the
        budget across two attempts: a dropped response frame is
        recovered at half the budget instead of surfacing as a hard
        error at the full one.  Non-idempotent ops get exactly one
        send — their callers verify on RemoteTimeout."""
        if _timeout is None:
            _timeout = self.call_timeout
        # op-kind accounting (cilium_kvstore_operations_total analog)
        # + a child span when inside an active trace (daemon ->
        # kvstore context propagation)
        KVSTORE_OPERATIONS.inc(labels={"backend": "remote", "op": op})
        with tracer.child_span(f"kvstore.{op}"):
            if op not in _IDEMPOTENT_OPS:
                return self._call_once(op, _timeout, args)
            deadline = Deadline(_timeout)
            try:
                return self._call_once(op, max(0.05, _timeout / 2.0),
                                       args)
            except RemoteTimeout:
                if self._closed.is_set():
                    raise
                TRANSPORT_RETRIES.inc(
                    labels={"transport": "remote", "op": op})
                return self._call_once(
                    op, max(0.05, deadline.remaining()), args)

    def _call_once(self, op: str, timeout: float, args: dict) -> dict:
        if self._closed.is_set():
            raise RemoteError("client closed")
        with self._mu:
            self._next_id += 1
            rid = self._next_id
            slot = {"ev": threading.Event()}
            self._pending[rid] = slot
        req = {"id": rid, "op": op}
        req.update(args)
        try:
            send_frame(self._sock, req, self._wlock)
        except OSError as e:
            with self._mu:
                self._pending.pop(rid, None)
            raise RemoteError(f"send failed: {e}") from e
        if not slot["ev"].wait(timeout):
            with self._mu:
                self._pending.pop(rid, None)
            raise RemoteTimeout(f"{op}: timed out")
        with self._mu:
            self._pending.pop(rid, None)
        resp = slot["resp"]
        if not resp.get("ok"):
            if resp.get("kind") == "lock":
                raise KVLockError(resp.get("error", "lock failed"))
            raise RemoteError(resp.get("error", "request failed"))
        return resp

    @staticmethod
    def _b64(value: bytes) -> str:
        return base64.b64encode(value).decode()

    # -------------------------------------------------------- plain ops

    def get(self, key: str) -> Optional[bytes]:
        resp = self._call("get", key=key)
        return None if resp.get("missing") else \
            base64.b64decode(resp["value_b64"])

    def get_prefix(self, prefix: str) -> Optional[bytes]:
        resp = self._call("get_prefix", prefix=prefix)
        return None if resp.get("missing") else \
            base64.b64decode(resp["value_b64"])

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        self._call("set", key=key, value_b64=self._b64(value), lease=lease)

    def delete(self, key: str) -> None:
        self._call("delete", key=key)

    def delete_prefix(self, prefix: str) -> None:
        self._call("delete_prefix", prefix=prefix)

    def create_only(self, key: str, value: bytes,
                    lease: bool = False) -> bool:
        try:
            return self._call("create_only", key=key,
                              value_b64=self._b64(value),
                              lease=lease)["created"]
        except RemoteTimeout:
            # the CAS may have been applied and only the reply lost —
            # verify instead of blindly re-sending (which would report
            # created=False against our own first write)
            if self._closed.is_set():
                raise
            TRANSPORT_VERIFIES.inc(
                labels={"transport": "remote", "op": "create_only"})
            return self.get(key) == value

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        return self._call("create_if_exists", cond_key=cond_key, key=key,
                          value_b64=self._b64(value),
                          lease=lease)["created"]

    # -------------------------------------------------- listing / watch

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        items = self._call("list_prefix", prefix=prefix)["items"]
        return {k: base64.b64decode(v) for k, v in items.items()}

    def _new_watch(self, op: str, prefix: str) -> Watcher:
        watcher = Watcher(prefix, self)
        with self._mu:
            self._next_id += 1
            watch_id = self._next_id
            self._watchers[watch_id] = watcher
        watcher._remote_id = watch_id
        self._call(op, prefix=prefix, watch_id=watch_id)
        return watcher

    def watch(self, prefix: str) -> Watcher:
        return self._new_watch("watch", prefix)

    def list_and_watch(self, prefix: str) -> Watcher:
        return self._new_watch("list_and_watch", prefix)

    def _remove_watcher(self, watcher: Watcher) -> None:
        watch_id = getattr(watcher, "_remote_id", None)
        if watch_id is None:
            return
        with self._mu:
            self._watchers.pop(watch_id, None)
        if not self._closed.is_set():
            try:
                self._call("unwatch", watch_id=watch_id)
            except (RemoteError, KVLockError):
                pass

    # --------------------------------------------------- locks / lease

    def lock_path(self, path: str, timeout: float = 30.0) -> Lock:
        # server enforces the acquisition timeout; our wait is padded
        # so the grant/timeout response normally arrives first.  If our
        # wait still expires (e.g. the frame sat unread behind the
        # server's dispatch bound, so its clock started late), tell the
        # server the wait is abandoned — whichever side the grant raced
        # to releases it, so no lock is stranded on a live connection
        # with no client handle.
        import uuid as _uuid
        ref = _uuid.uuid4().hex
        try:
            resp = self._call("lock", _timeout=timeout + 10.0, path=path,
                              timeout=timeout, lock_ref=ref)
        except RemoteError:
            if not self._closed.is_set():
                try:
                    self._call("abort_lock", _timeout=5.0, lock_ref=ref)
                except (RemoteError, KVLockError):
                    pass
            raise
        return Lock(self, path, resp["lock_id"])

    def _unlock(self, path: str, token: str) -> None:
        try:
            self._call("unlock", lock_id=token)
        except RemoteError:
            pass

    def renew_lease(self) -> None:
        self._call("renew_lease")

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def status(self) -> str:
        try:
            return self._call("status", _timeout=2.0)["text"]
        except (RemoteError, KVLockError):
            return "remote: unreachable"


register_backend(RemoteBackend.name, RemoteBackend)
