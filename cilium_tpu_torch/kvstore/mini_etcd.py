"""In-repo mini-etcd: an etcd v3 JSON-gateway subset server.

A whole copy of ``cilium_tpu/kvstore/mini_etcd.py``.

Reference: the production backend of pkg/kvstore is etcd
(pkg/kvstore/etcd.go:1 — leases, keepalives, txn-based CreateOnly,
prefix watches).  This environment has zero egress, so portability of
``BackendOperations`` against a second, *production-shaped* protocol is
proven against this server instead: it speaks the etcd v3 gRPC-gateway
JSON wire (base64 keys/values, the same request/response field names)
for exactly the subset client-side etcd.py uses:

  POST /v3/kv/range         {key, range_end?, limit?}
  POST /v3/kv/put           {key, value, lease?}
  POST /v3/kv/deleterange   {key, range_end?}
  POST /v3/kv/txn           {compare[], success[], failure[]}
  POST /v3/lease/grant      {TTL}
  POST /v3/lease/keepalive  {ID}
  POST /v3/lease/revoke     {ID}
  POST /v3/watch            {create_request:{key, range_end?,
                             start_revision?}} -> chunked JSON stream

Semantics implemented the etcd way: a single global revision counter,
per-key create_revision/mod_revision/version, leases that delete their
attached keys on expiry, watches that replay history from
start_revision and stream live events.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

# bounded watch-replay history; a start_revision older than the window
# answers with compacted=true (etcd's ErrCompacted analog)
HISTORY_LIMIT = 4096


def _b64e(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _b64d(s: str) -> bytes:
    return base64.b64decode(s)


class _KV:
    __slots__ = ("value", "create_rev", "mod_rev", "version", "lease")

    def __init__(self, value: bytes, create_rev: int, mod_rev: int,
                 version: int, lease: int):
        self.value = value
        self.create_rev = create_rev
        self.mod_rev = mod_rev
        self.version = version
        self.lease = lease

    def to_json(self, key: bytes) -> Dict:
        return {"key": _b64e(key), "value": _b64e(self.value),
                "create_revision": str(self.create_rev),
                "mod_revision": str(self.mod_rev),
                "version": str(self.version),
                "lease": str(self.lease)}


class _Lease:
    __slots__ = ("ttl", "deadline", "keys")

    def __init__(self, ttl: float, deadline: float):
        self.ttl = ttl
        self.deadline = deadline
        self.keys: set = set()


class MiniEtcd:
    """Threaded server; start() binds an ephemeral port."""

    def __init__(self, reap_interval: float = 0.2):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rev = 1                    # etcd starts at revision 1
        self._kv: Dict[bytes, _KV] = {}
        self._leases: Dict[int, _Lease] = {}
        self._next_lease = 1000
        # (rev, "PUT"|"DELETE", key, kv-json-or-None)
        self._history: List[Tuple[int, str, bytes, Optional[Dict]]] = []
        self._oldest_rev = 1
        self._stop = threading.Event()
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        httpd.etcd = self
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._threads = [
            threading.Thread(target=httpd.serve_forever, daemon=True,
                             name="mini-etcd"),
            threading.Thread(target=self._reaper, daemon=True,
                             name="mini-etcd-reaper"),
        ]
        self._reap_interval = reap_interval

    def start(self) -> "MiniEtcd":
        for t in self._threads:
            t.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------ internals

    def _record(self, etype: str, key: bytes,
                kv: Optional[_KV]) -> None:
        """Append one event at the CURRENT revision (callers bump)."""
        self._history.append(
            (self._rev, etype, key,
             kv.to_json(key) if kv is not None else None))
        if len(self._history) > HISTORY_LIMIT:
            drop = len(self._history) - HISTORY_LIMIT
            self._oldest_rev = self._history[drop - 1][0] + 1
            del self._history[:drop]

    def _put_locked(self, key: bytes, value: bytes, lease: int) -> None:
        self._rev += 1
        cur = self._kv.get(key)
        if cur is None:
            kv = _KV(value, self._rev, self._rev, 1, lease)
        else:
            kv = _KV(value, cur.create_rev, self._rev,
                     cur.version + 1, lease)
            if cur.lease and cur.lease != lease and \
                    cur.lease in self._leases:
                self._leases[cur.lease].keys.discard(key)
        self._kv[key] = kv
        if lease and lease in self._leases:
            self._leases[lease].keys.add(key)
        self._record("PUT", key, kv)
        self._cond.notify_all()

    def _delete_locked(self, key: bytes) -> bool:
        cur = self._kv.pop(key, None)
        if cur is None:
            return False
        self._rev += 1
        if cur.lease and cur.lease in self._leases:
            self._leases[cur.lease].keys.discard(key)
        self._record("DELETE", key, None)
        self._cond.notify_all()
        return True

    def _range_keys(self, key: bytes, range_end: bytes) -> List[bytes]:
        if not range_end:
            return [key] if key in self._kv else []
        return sorted(k for k in self._kv
                      if key <= k < range_end)

    def compact(self, revision: Optional[int] = None) -> None:
        """Discard watch-replay history up to ``revision`` (default:
        everything so far) — the etcd Compact analog.  A watch asking
        for an older start_revision gets the compacted error and must
        relist."""
        with self._cond:
            rev = self._rev if revision is None else revision
            self._history = [h for h in self._history if h[0] > rev]
            self._oldest_rev = rev + 1
            self._cond.notify_all()

    def _reap_expired_locked(self, now: float) -> int:
        dead = [lid for lid, l in self._leases.items()
                if l.deadline <= now]
        for lid in dead:
            lease = self._leases.pop(lid)
            for key in sorted(lease.keys):
                self._delete_locked(key)
        return len(dead)

    def _reaper(self) -> None:
        while not self._stop.wait(self._reap_interval):
            with self._cond:
                self._reap_expired_locked(time.monotonic())

    def expire_leases(self) -> int:
        """Chaos hook (utils/faultinject.ControlPlaneFaultInjector):
        expire every live lease NOW and reap its keys — the
        long-outage scenario where clients' keepalives stopped long
        enough ago that the server dropped their session state.
        Returns the number of leases expired."""
        with self._cond:
            for lease in self._leases.values():
                lease.deadline = 0.0
            return self._reap_expired_locked(time.monotonic())

    # ---------------------------------------------------- API handlers

    def handle(self, path: str, body: Dict) -> Dict:
        """Non-streaming endpoints."""
        with self._cond:
            if path == "/v3/kv/range":
                key = _b64d(body.get("key", ""))
                end = _b64d(body.get("range_end", ""))
                keys = self._range_keys(key, end)
                limit = int(body.get("limit", 0))
                if limit:
                    keys = keys[:limit]
                return {"header": {"revision": str(self._rev)},
                        "kvs": [self._kv[k].to_json(k) for k in keys],
                        "count": str(len(keys))}
            if path == "/v3/kv/put":
                lease = int(body.get("lease", 0))
                if lease and lease not in self._leases:
                    return {"error": "lease not found", "code": 5}
                self._put_locked(_b64d(body["key"]),
                                 _b64d(body.get("value", "")), lease)
                return {"header": {"revision": str(self._rev)}}
            if path == "/v3/kv/deleterange":
                key = _b64d(body.get("key", ""))
                end = _b64d(body.get("range_end", ""))
                deleted = 0
                for k in self._range_keys(key, end):
                    if self._delete_locked(k):
                        deleted += 1
                return {"header": {"revision": str(self._rev)},
                        "deleted": str(deleted)}
            if path == "/v3/kv/txn":
                return self._txn_locked(body)
            if path == "/v3/lease/grant":
                ttl = float(body.get("TTL", 5))
                self._next_lease += 1
                lid = self._next_lease
                self._leases[lid] = _Lease(
                    ttl, time.monotonic() + ttl)
                return {"ID": str(lid), "TTL": str(int(ttl))}
            if path == "/v3/lease/keepalive":
                lid = int(body.get("ID", 0))
                lease = self._leases.get(lid)
                if lease is None:
                    return {"result": {"ID": str(lid), "TTL": "0"}}
                lease.deadline = time.monotonic() + lease.ttl
                return {"result": {"ID": str(lid),
                                   "TTL": str(int(lease.ttl))}}
            if path == "/v3/lease/revoke":
                lid = int(body.get("ID", 0))
                lease = self._leases.pop(lid, None)
                if lease is not None:
                    for key in sorted(lease.keys):
                        self._delete_locked(key)
                return {"header": {"revision": str(self._rev)}}
        return {"error": f"unknown path {path}", "code": 3}

    def _txn_locked(self, body: Dict) -> Dict:
        succeeded = all(self._compare(c)
                        for c in body.get("compare", []))
        ops = body.get("success" if succeeded else "failure", [])
        responses = []
        for op in ops:
            if "request_put" in op:
                p = op["request_put"]
                lease = int(p.get("lease", 0))
                if lease and lease not in self._leases:
                    return {"error": "lease not found", "code": 5}
                self._put_locked(_b64d(p["key"]),
                                 _b64d(p.get("value", "")), lease)
                responses.append({"response_put": {}})
            elif "request_delete_range" in op:
                p = op["request_delete_range"]
                for k in self._range_keys(
                        _b64d(p.get("key", "")),
                        _b64d(p.get("range_end", ""))):
                    self._delete_locked(k)
                responses.append({"response_delete_range": {}})
            elif "request_range" in op:
                p = op["request_range"]
                keys = self._range_keys(_b64d(p.get("key", "")),
                                        _b64d(p.get("range_end", "")))
                responses.append({"response_range": {
                    "kvs": [self._kv[k].to_json(k) for k in keys],
                    "count": str(len(keys))}})
        return {"header": {"revision": str(self._rev)},
                "succeeded": succeeded, "responses": responses}

    def _compare(self, c: Dict) -> bool:
        key = _b64d(c.get("key", ""))
        kv = self._kv.get(key)
        target = c.get("target", "VALUE")
        result = c.get("result", "EQUAL")
        if target == "CREATE":
            actual = kv.create_rev if kv is not None else 0
            want = int(c.get("create_revision", 0))
        elif target == "VALUE":
            actual = kv.value if kv is not None else b""
            want = _b64d(c.get("value", ""))
        elif target == "VERSION":
            actual = kv.version if kv is not None else 0
            want = int(c.get("version", 0))
        else:
            return False
        if result == "EQUAL":
            return actual == want
        if result == "GREATER":
            return actual > want
        if result == "LESS":
            return actual < want
        if result == "NOT_EQUAL":
            return actual != want
        return False

    # ----------------------------------------------------- watch plane

    def watch_events(self, key: bytes, range_end: bytes,
                     start_rev: int, stopped) -> "iter":
        """Generator of watch-response dicts (the handler streams
        them).  Yields a compacted error if start_rev fell out of the
        replay window."""
        with self._cond:
            if start_rev and start_rev < self._oldest_rev:
                yield {"result": {"compact_revision":
                                  str(self._oldest_rev)},
                       "error": "required revision has been compacted"}
                return
            # etcd semantics: start_revision=0 means "from current",
            # NOT "replay retained history" — replay only happens for
            # an explicit revision (replaying from 0 would re-emit up
            # to HISTORY_LIMIT stale events, including DELETEs,
            # diverging from real etcd)
            cursor = self._rev if start_rev == 0 else start_rev - 1
        yield {"result": {"created": True,
                          "header": {"revision": str(self._rev)}}}
        while not stopped():
            with self._cond:
                batch = []
                for rev, etype, k, kvj in self._history:
                    if rev <= cursor:
                        continue
                    in_range = (k == key if not range_end
                                else key <= k < range_end)
                    if not in_range:
                        cursor = max(cursor, rev)
                        continue
                    ev = {"type": etype} if etype == "DELETE" else {}
                    ev["kv"] = kvj if kvj is not None else \
                        {"key": _b64e(k)}
                    batch.append((rev, ev))
                if not batch:
                    self._cond.wait(timeout=0.5)
                    rev_now = self._rev
                    idle = True
                else:
                    idle = False
            if idle:
                # progress notify (etcd WithProgressNotify analog):
                # gives the handler a write on every idle tick, so an
                # abandoned client surfaces as BrokenPipeError instead
                # of a zombie handler thread spinning forever
                yield {"result": {"header": {"revision": str(rev_now)}}}
                continue
            events = [e for _r, e in batch]
            cursor = batch[-1][0]
            yield {"result": {"header": {"revision": str(cursor)},
                              "events": events}}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802 — http.server contract
        etcd: MiniEtcd = self.server.etcd
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            self._json(400, {"error": "bad json"})
            return
        if self.path == "/v3/watch":
            self._stream_watch(etcd, body)
            return
        self._json(200, etcd.handle(self.path, body))

    def _stream_watch(self, etcd: MiniEtcd, body: Dict) -> None:
        req = body.get("create_request", {})
        key = _b64d(req.get("key", ""))
        range_end = _b64d(req.get("range_end", ""))
        start = int(req.get("start_revision", 0))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        stopped = etcd._stop.is_set
        try:
            for resp in etcd.watch_events(key, range_end, start,
                                          stopped):
                data = (json.dumps(resp) + "\n").encode()
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        self.close_connection = True

    def _json(self, code: int, obj: Dict) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
