"""etcd v3 kvstore backend (JSON gateway wire).

A whole copy of ``cilium_tpu/kvstore/etcd.py``.

Reference: pkg/kvstore/etcd.go:1 — the production backend: a session
lease kept alive by the client, txn-based CreateOnly/CreateIfExists,
prefix ranges, streaming watches, and lease-based locks.  This speaks
the etcd v3 gRPC-gateway JSON protocol (/v3/kv/*, /v3/lease/*,
/v3/watch with base64 keys), so it runs unchanged against a real etcd
gateway or the in-repo mini_etcd.MiniEtcd.

Implements the same ``BackendOperations`` surface as the in-memory and
TCP backends — the whole allocator/ipcache/node stack runs against any
of the three (backend portability is the point: backend.go:86).
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import time
import uuid
from typing import Dict, Optional

from ..observability.tracer import tracer
from ..utils.metrics import KVSTORE_OPERATIONS
from ..utils.netio import teardown_http_conn
from ..utils.resilience import (SYNTHETIC_EVENTS, TRANSPORT_DEADLINES,
                                TRANSPORT_RETRIES, TRANSPORT_VERIFIES,
                                WATCH_RELISTS, AmbiguousResult, Deadline)
from .backend import (BackendOperations, EVENT_CREATE, EVENT_DELETE,
                      EVENT_LIST_DONE, EVENT_MODIFY, Event, KVLockError,
                      Lock, Watcher, register_backend)


def _b64e(s: "str | bytes") -> str:
    if isinstance(s, str):
        s = s.encode()
    return base64.b64encode(s).decode()


def _b64d(s: str) -> bytes:
    return base64.b64decode(s)


def _prefix_range_end(prefix: bytes) -> bytes:
    """etcd prefix query: range_end = prefix with its last byte
    incremented (clientv3.GetPrefixRangeEnd)."""
    end = bytearray(prefix)
    for i in reversed(range(len(end))):
        if end[i] < 0xFF:
            end[i] += 1
            return bytes(end[:i + 1])
        del end[i]
    return b"\x00"  # prefix of all 0xff: range to the end of keyspace


class EtcdError(RuntimeError):
    pass


class EtcdAmbiguousError(EtcdError, AmbiguousResult):
    """The connection died after the request was delivered: the op may
    or may not have been applied.  Raised only for non-idempotent
    paths (txn CAS) — callers verify by reading the result back."""


# Paths whose effect is NOT idempotent: a lost reply after a delivered
# request leaves the outcome unknown, and a blind re-send of the txn
# CAS would report succeeded=false against the caller's OWN first
# write.  Everything else retries blindly: range/keepalive are pure
# reads, put/deleterange converge to the same state on re-apply, and
# grant/revoke leak at most one TTL-bounded lease.
_NON_IDEMPOTENT_PATHS = frozenset({"/v3/kv/txn"})
_CALL_ATTEMPTS = 3


class EtcdBackend(BackendOperations):
    """BackendOperations over the etcd v3 JSON gateway."""

    name = "etcd"

    def __init__(self, host: str = "127.0.0.1", port: int = 2379,
                 lease_ttl: float = 15.0, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.lease_ttl = lease_ttl
        self._watchers: Dict[Watcher, threading.Thread] = {}
        self._watcher_conns: Dict[Watcher, object] = {}
        self._lock = threading.Lock()
        self._conn_mu = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._closed = threading.Event()
        # session lease (etcd.go: one lease per client, kept alive)
        out = self._call("/v3/lease/grant",
                         {"TTL": str(max(1, int(lease_ttl)))})
        self.lease_id = int(out["ID"])
        self._keepalive = threading.Thread(
            target=self._keepalive_loop, daemon=True,
            name="etcd-keepalive")
        self._keepalive.start()

    # ------------------------------------------------------- transport

    def _call(self, path: str, body: Dict) -> Dict:
        """One request over a persistent keep-alive connection (the
        lock hot path polls; a connect/close per op would churn
        ephemeral ports).  Idempotent paths get bounded
        reconnect-and-retry under a deadline; a non-idempotent path
        (txn CAS) whose connection dies AFTER the request was sent
        surfaces EtcdAmbiguousError instead — the caller must verify
        the outcome, never blind-resend."""
        payload = json.dumps(body).encode()
        idempotent = path not in _NON_IDEMPOTENT_PATHS
        deadline = Deadline(self.timeout)
        # op-kind accounting (cilium_kvstore_operations_total analog)
        # + a child span when the caller is inside an active trace
        # (daemon -> kvstore context propagation)
        op_kind = path[len("/v3/"):].replace("/", "-")
        KVSTORE_OPERATIONS.inc(labels={"backend": "etcd",
                                       "op": op_kind})
        with tracer.child_span(f"etcd.{op_kind}"):
            return self._call_locked(path, payload, idempotent,
                                     deadline)

    def _call_locked(self, path: str, payload: bytes,
                     idempotent: bool, deadline: Deadline) -> Dict:
        attempt = 0
        with self._conn_mu:
            while True:
                sent = False
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout)
                try:
                    self._conn.request(
                        "POST", path, body=payload,
                        headers={"Content-Type": "application/json"})
                    sent = True
                    resp = self._conn.getresponse()
                    data = resp.read()
                    status = resp.status
                    break
                except (OSError, http.client.HTTPException) as e:
                    self._conn.close()
                    self._conn = None
                    attempt += 1
                    if sent and not idempotent:
                        raise EtcdAmbiguousError(f"{path}: {e}") from e
                    if attempt >= _CALL_ATTEMPTS or deadline.expired:
                        if deadline.expired:
                            TRANSPORT_DEADLINES.inc(
                                labels={"transport": "etcd"})
                        raise EtcdError(f"{path}: {e}") from e
                    TRANSPORT_RETRIES.inc(
                        labels={"transport": "etcd", "op": path})
                    time.sleep(min(0.02 * (2 ** (attempt - 1)),
                                   deadline.remaining()))
        if status != 200:
            raise EtcdError(f"{path}: HTTP {status}")
        try:
            out = json.loads(data)
        except ValueError as e:
            raise EtcdError(f"{path}: bad response") from e
        if "error" in out:
            raise EtcdError(f"{path}: {out['error']}")
        return out

    def _keepalive_loop(self) -> None:
        interval = max(0.05, self.lease_ttl / 3.0)
        while not self._closed.wait(interval):
            try:
                self._call("/v3/lease/keepalive",
                           {"ID": str(self.lease_id)})
                ok = True  # transient failures: lease survives to ttl
            except EtcdError:
                ok = False
            listener = self.keepalive_listener
            if listener is not None:
                try:
                    listener(ok)
                except Exception:  # noqa: BLE001 — observer only
                    pass

    def _regrant_on_lost_lease(self, fn):
        """Run a lease-attached mutation; if the session lease expired
        server-side (an outage outlived the TTL — the server reaped it
        along with every key it backed), grant a fresh lease and retry
        once.  ``fn`` must re-read ``self.lease_id`` per attempt.  The
        outage reconcile (kvstore/outage.py) re-asserts the reaped
        keys through exactly this path."""
        try:
            return fn()
        except EtcdError as e:
            if "lease not found" not in str(e).lower():
                raise
            out = self._call("/v3/lease/grant",
                             {"TTL": str(max(1, int(self.lease_ttl)))})
            self.lease_id = int(out["ID"])
            return fn()

    # ------------------------------------------------------- plain ops

    def get(self, key: str) -> Optional[bytes]:
        out = self._call("/v3/kv/range", {"key": _b64e(key)})
        kvs = out.get("kvs", [])
        return _b64d(kvs[0]["value"]) if kvs else None

    def get_prefix(self, prefix: str) -> Optional[bytes]:
        p = prefix.encode()
        out = self._call("/v3/kv/range", {
            "key": _b64e(p),
            "range_end": _b64e(_prefix_range_end(p)), "limit": "1"})
        kvs = out.get("kvs", [])
        return _b64d(kvs[0]["value"]) if kvs else None

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        def put():
            body = {"key": _b64e(key), "value": _b64e(value)}
            if lease:
                body["lease"] = str(self.lease_id)
            self._call("/v3/kv/put", body)
        if lease:
            self._regrant_on_lost_lease(put)
        else:
            put()

    def delete(self, key: str) -> None:
        self._call("/v3/kv/deleterange", {"key": _b64e(key)})

    def delete_prefix(self, prefix: str) -> None:
        p = prefix.encode()
        self._call("/v3/kv/deleterange", {
            "key": _b64e(p),
            "range_end": _b64e(_prefix_range_end(p))})

    # ------------------------------------------------------ atomic ops

    def _txn_put_if(self, compare: Dict, key: str, value: bytes,
                    lease: bool) -> bool:
        def txn():
            put = {"key": _b64e(key), "value": _b64e(value)}
            if lease:
                put["lease"] = str(self.lease_id)
            out = self._call("/v3/kv/txn", {
                "compare": [compare],
                "success": [{"request_put": put}]})
            return bool(out.get("succeeded"))
        if lease:
            return self._regrant_on_lost_lease(txn)
        return txn()

    def create_only(self, key: str, value: bytes,
                    lease: bool = False) -> bool:
        # etcd.go CreateOnly: compare create_revision == 0 (absent)
        try:
            return self._txn_put_if(
                {"key": _b64e(key), "target": "CREATE",
                 "result": "EQUAL", "create_revision": "0"},
                key, value, lease)
        except EtcdAmbiguousError:
            # verify-on-retry: value equality is the idempotency test.
            # Callers that need exact ownership (lock_path) write a
            # unique per-request token as the value, so "our value is
            # there" can only mean our create landed.  A failed read
            # here propagates EtcdError: the outcome stays unknown.
            TRANSPORT_VERIFIES.inc(
                labels={"transport": "etcd", "op": "create_only"})
            return self.get(key) == value

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        # compare cond_key's create_revision > 0 (present)
        try:
            return self._txn_put_if(
                {"key": _b64e(cond_key), "target": "CREATE",
                 "result": "GREATER", "create_revision": "0"},
                key, value, lease)
        except EtcdAmbiguousError:
            TRANSPORT_VERIFIES.inc(
                labels={"transport": "etcd", "op": "create_if_exists"})
            return self.get(key) == value

    # ------------------------------------------------ listing/watching

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        p = prefix.encode()
        out = self._call("/v3/kv/range", {
            "key": _b64e(p),
            "range_end": _b64e(_prefix_range_end(p))})
        return {_b64d(kv["key"]).decode(): _b64d(kv["value"])
                for kv in out.get("kvs", [])}

    def _snapshot(self, prefix: str):
        p = prefix.encode()
        out = self._call("/v3/kv/range", {
            "key": _b64e(p),
            "range_end": _b64e(_prefix_range_end(p))})
        rev = int(out.get("header", {}).get("revision", "0"))
        return out.get("kvs", []), rev

    def _relist_into(self, watcher: Watcher, known: set) -> int:
        """Compaction recovery: relist the prefix, diff against the
        consumer-visible key set, and emit synthetic MODIFY/DELETE
        events (the reflector Replace semantics of k8s/client.py) so a
        consumer can never retain an entry deleted in the blind
        window.  Returns the revision to resume the watch from."""
        kvs, rev = self._snapshot(watcher.prefix)
        WATCH_RELISTS.inc(labels={"transport": "etcd"})
        fresh: Dict[str, bytes] = {}
        for kv in kvs:
            fresh[_b64d(kv["key"]).decode()] = \
                _b64d(kv.get("value", ""))
        for key, value in fresh.items():
            typ = EVENT_MODIFY if key in known else EVENT_CREATE
            watcher._emit(Event(typ, key, value))
            SYNTHETIC_EVENTS.inc(
                labels={"transport": "etcd", "typ": typ})
        for key in sorted(known - fresh.keys()):
            watcher._emit(Event(EVENT_DELETE, key))
            SYNTHETIC_EVENTS.inc(
                labels={"transport": "etcd", "typ": EVENT_DELETE})
        known.clear()
        known.update(fresh)
        return rev + 1

    def _watch_stream(self, watcher: Watcher, start_rev: int,
                      known: set) -> None:
        """Reader thread: one /v3/watch stream, re-established from the
        last delivered revision on stream loss; CREATE vs MODIFY from
        kv.version (1 = first write, etcd semantics).  ``known`` is
        the consumer-visible key set, maintained here so compaction
        recovery can relist-and-diff instead of dropping events."""
        prefix = watcher.prefix.encode()
        cursor: Optional[int] = start_rev  # None => compacted: relist
        while not self._closed.is_set() and \
                not watcher._stopped.is_set():
            if cursor is None:
                try:
                    cursor = self._relist_into(watcher, known)
                except EtcdError:
                    if self._closed.is_set() or \
                            watcher._stopped.is_set():
                        return
                    time.sleep(0.05)
                continue
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            try:
                conn.connect()
                with self._lock:
                    if watcher._stopped.is_set():
                        return
                    self._watcher_conns[watcher] = conn
                payload = json.dumps({"create_request": {
                    "key": _b64e(prefix),
                    "range_end": _b64e(_prefix_range_end(prefix)),
                    "start_revision": str(cursor)}}).encode()
                KVSTORE_OPERATIONS.inc(labels={"backend": "etcd",
                                               "op": "watch"})
                conn.request("POST", "/v3/watch", body=payload,
                             headers={"Content-Type":
                                      "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    raise OSError(f"watch: HTTP {resp.status}")
                conn.sock.settimeout(None)
                for raw in resp:
                    line = raw.strip()
                    if not line:
                        continue
                    msg = json.loads(line)
                    result = msg.get("result", {})
                    if msg.get("error") or "compact_revision" in result:
                        # compacted: the only lossless recovery is a
                        # relist-and-diff against the consumer-visible
                        # set, resuming from the fresh revision
                        cursor = None
                        break
                    events = result.get("events", [])
                    for ev in events:
                        kv = ev.get("kv", {})
                        key = _b64d(kv.get("key", "")).decode()
                        if ev.get("type") == "DELETE":
                            known.discard(key)
                            watcher._emit(Event(EVENT_DELETE, key))
                        else:
                            typ = EVENT_CREATE \
                                if kv.get("version") == "1" \
                                else EVENT_MODIFY
                            known.add(key)
                            watcher._emit(Event(
                                typ, key,
                                _b64d(kv.get("value", ""))))
                    rev = result.get("header", {}).get("revision")
                    if rev is not None and events:
                        cursor = int(rev) + 1
            except AttributeError:
                # http.client nulls resp.fp when the stop path closes
                # the connection under a blocked reader; ONLY then is
                # it a dead stream — otherwise it's a real bug
                if watcher._stopped.is_set() or self._closed.is_set():
                    return
                raise
            except (OSError, ValueError, http.client.HTTPException):
                # HTTPException covers NotConnected from a conn the
                # stop path tore down (auto_open cleared) and
                # IncompleteRead from a stream cut mid-chunk
                if watcher._stopped.is_set() or self._closed.is_set():
                    return
                time.sleep(0.05)
            finally:
                teardown_http_conn(conn)
                with self._lock:
                    self._watcher_conns.pop(watcher, None)

    def _revision(self) -> int:
        """Current store revision (cheap: no kvs transferred)."""
        out = self._call("/v3/kv/range",
                         {"key": _b64e("\x00"), "limit": "1"})
        return int(out.get("header", {}).get("revision", "0"))

    def watch(self, prefix: str) -> Watcher:
        watcher, t = self._make_watcher(prefix, self._revision() + 1,
                                        set())
        t.start()
        return watcher

    def list_and_watch(self, prefix: str) -> Watcher:
        kvs, rev = self._snapshot(prefix)
        # seed the consumer-visible set with the listed keys: they are
        # what compaction recovery must diff deletions against
        known = {_b64d(kv["key"]).decode() for kv in kvs}
        watcher, t = self._make_watcher(prefix, rev + 1, known)
        for kv in kvs:
            watcher._emit(Event(EVENT_CREATE,
                                _b64d(kv["key"]).decode(),
                                _b64d(kv["value"])))
        watcher._emit(Event(EVENT_LIST_DONE))
        # the local thread handle, NOT a dict re-index: a concurrent
        # close() may already have unregistered the watcher
        t.start()
        return watcher

    def _make_watcher(self, prefix: str, start_rev: int, known: set
                      ) -> "tuple[Watcher, threading.Thread]":
        watcher = Watcher(prefix, self)
        t = threading.Thread(target=self._watch_stream,
                             args=(watcher, start_rev, known),
                             daemon=True,
                             name=f"etcd-watch-{prefix}")
        with self._lock:
            self._watchers[watcher] = t
        return watcher, t

    def _remove_watcher(self, watcher: Watcher) -> None:
        with self._lock:
            self._watchers.pop(watcher, None)
            conn = self._watcher_conns.pop(watcher, None)
        if conn is not None:
            teardown_http_conn(conn)

    # ------------------------------------------------------------ locks

    def lock_path(self, path: str, timeout: float = 30.0) -> Lock:
        """Lease-bound lock via atomic create (etcd.go LockPath via
        concurrency.Mutex; same liveness: holder death releases it
        when the lease expires).  The token doubles as the
        idempotency token: if the create txn's reply is lost,
        create_only reads the key back and value==own-token means the
        lock is ours — a reset mid-acquisition can no longer orphan
        the lock until its lease expires."""
        token = uuid.uuid4().hex
        lock_key = f"{path}.lock"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.create_only(lock_key, token.encode(), lease=True):
                return Lock(self, path, token)
            time.sleep(0.02)
        raise KVLockError(f"lock {path!r}: timeout")

    def _unlock(self, path: str, token: str) -> None:
        # delete only OUR lock (compare value == token), atomically —
        # never a successor's
        body = {
            "compare": [{"key": _b64e(f"{path}.lock"),
                         "target": "VALUE", "result": "EQUAL",
                         "value": _b64e(token)}],
            "success": [{"request_delete_range":
                         {"key": _b64e(f"{path}.lock")}}]}
        try:
            self._call("/v3/kv/txn", body)
        except EtcdAmbiguousError:
            # delete-if-value==token is naturally idempotent: if the
            # first send applied, the re-sent compare fails against an
            # absent key (or a successor's token) and no-ops
            self._call("/v3/kv/txn", body)

    # -------------------------------------------------------- liveness

    def renew_lease(self) -> None:
        self._call("/v3/lease/keepalive", {"ID": str(self.lease_id)})

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            w.stop()
        try:
            self._call("/v3/lease/revoke", {"ID": str(self.lease_id)})
        except EtcdError:
            pass

    def status(self) -> str:
        try:
            self._call("/v3/kv/range", {"key": _b64e("\x00")})
            return f"etcd: ok ({self.host}:{self.port}, " \
                   f"lease {self.lease_id})"
        except EtcdError as e:
            return f"etcd: unreachable ({e})"


register_backend("etcd", EtcdBackend)
