"""k8s list/watch HTTP client + reflectors (the informer transport).

Reference: daemon/k8s_watcher.go:70-78 builds client-go informers; each
is a Reflector doing LIST (grab the collection + its resourceVersion),
then WATCH from that version (a long-lived chunked stream of typed
events), reconnecting from the last seen version on stream loss and
falling back to a full relist on **410 Gone** (the server compacted the
requested version away).  This module is that machinery over plain
``http.client``, feeding the existing ``K8sWatcher.enqueue_event``
sink — the watcher's ordering/dedup semantics are unchanged; only the
transport is new.

``K8sTransport`` is the EnableK8sWatcher analog: one reflector per
watched resource, all driving one ``K8sWatcher``.

A whole copy of ``cilium_tpu/k8s/client.py``: either package's client
reads either package's fake apiserver.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple
from urllib.parse import urlparse

# resource path -> the K8sWatcher kind it feeds
WATCHED_RESOURCES = {
    "/apis/cilium.io/v2/ciliumnetworkpolicies": "cnp",
    "/apis/networking.k8s.io/v1/networkpolicies": "networkpolicy",
    "/api/v1/services": "service",
    "/api/v1/endpoints": "endpoints",
    "/api/v1/pods": "pod",
    "/api/v1/nodes": "node",
    "/api/v1/namespaces": "namespace",
    "/apis/networking.k8s.io/v1/ingresses": "ingress",
}


class GoneError(Exception):
    """410: the requested resourceVersion was compacted away."""


from ..utils.netio import teardown_http_conn as _teardown_conn  # noqa: E402
from ..utils.resilience import (CircuitBreaker,  # noqa: E402
                                WATCH_RELISTS)


class K8sClient:
    """Minimal apiserver client: list + streaming watch."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        u = urlparse(base_url)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.timeout = timeout

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def list(self, path: str) -> Tuple[List[Dict], str]:
        """Returns (items, collection resourceVersion)."""
        conn = self._connect()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise OSError(f"list {path}: HTTP {resp.status}")
            doc = json.loads(body)
            return (doc.get("items", []),
                    (doc.get("metadata") or {}).get("resourceVersion",
                                                    "0"))
        finally:
            conn.close()

    def watch(self, path: str, resource_version: str,
              register=None) -> Iterator[Tuple[str, Dict]]:
        """Yields (event type, object) from a chunked watch stream
        starting after ``resource_version``.  Raises GoneError on the
        in-stream 410 Status event; plain stream loss just ends the
        iterator (the reflector re-watches from its last version).

        The watch read has NO timeout: a healthy cluster can be silent
        for minutes.  ``register(conn)`` hands the live connection to
        the caller so its stop path can close it from outside and
        unblock the read (client-go's context-cancelled watch)."""
        conn = self._connect()
        # connect EAGERLY: HTTPConnection only opens its socket at
        # request time, so a caller registering the conn for
        # stop-time teardown would otherwise see sock=None and its
        # kill would be a silent no-op (stuck reflector thread)
        conn.connect()
        if register is not None:
            register(conn)
        try:
            conn.request(
                "GET",
                f"{path}?watch=true&resourceVersion={resource_version}")
            resp = conn.getresponse()
            if resp.status == 410:
                raise GoneError(path)
            if resp.status != 200:
                raise OSError(f"watch {path}: HTTP {resp.status}")
            conn.sock.settimeout(None)
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    raise OSError(f"watch {path}: bad frame")
                etype = event.get("type", "")
                obj = event.get("object", {})
                if etype == "ERROR":
                    if obj.get("code") == 410:
                        raise GoneError(path)
                    raise OSError(f"watch {path}: {obj}")
                yield etype, obj
        finally:
            # the stream may still be live (generator abandoned
            # mid-iteration) — see _teardown_conn for why plain
            # close() would block here
            _teardown_conn(conn)


class Reflector:
    """LIST+WATCH one resource into a K8sWatcher (client-go Reflector
    + DeltaFIFO Replace semantics)."""

    def __init__(self, client: K8sClient, path: str, kind: str,
                 watcher, backoff_base: float = 0.05,
                 backoff_max: float = 2.0,
                 breaker: Optional[CircuitBreaker] = None):
        self.client = client
        self.path = path
        self.kind = kind
        self.watcher = watcher
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        # a flapping apiserver degrades to the breaker's bounded probe
        # cadence instead of a reconnect hot loop
        self.breaker = breaker or CircuitBreaker(
            f"k8s-watch-{kind}", failure_threshold=3,
            reset_timeout=max(backoff_base * 4, 0.1),
            max_reset=max(backoff_max, 5.0))
        self._stop = threading.Event()
        self._conn_lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"reflector-{kind}")
        # object key -> last seen object (for relist deletion diffing,
        # the DeletedFinalStateUnknown analog)
        self._known: Dict[Tuple[str, str], Dict] = {}
        self.relists = 0
        self.rewatches = 0
        self.synced = threading.Event()

    # ------------------------------------------------------------ loop

    def start(self) -> "Reflector":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._conn_lock:
            if self._conn is not None:
                _teardown_conn(self._conn)
        self._thread.join(timeout=timeout)

    def _register_conn(self, conn) -> None:
        with self._conn_lock:
            self._conn = conn
        if self._stop.is_set():
            _teardown_conn(conn)

    def _key(self, obj: Dict) -> Tuple[str, str]:
        meta = obj.get("metadata", {})
        return (meta.get("namespace", ""), meta.get("name", ""))

    def _feed(self, action: str, obj: Dict) -> None:
        try:
            self.watcher.enqueue_event(self.kind, action, obj)
        except RuntimeError:
            # watcher stopped: the reflector is shutting down too
            self._stop.set()

    def _relist(self) -> str:
        items, rv = self.client.list(self.path)
        self.relists += 1
        WATCH_RELISTS.inc(labels={"transport": "k8s"})
        fresh = {self._key(o): o for o in items}
        # Replace semantics: everything current is an upsert (the
        # watcher's resourceVersion dedup drops no-ops), everything
        # we knew that vanished while we weren't watching is a delete
        for key, obj in fresh.items():
            self._feed("modified" if key in self._known else "added",
                       obj)
        for key, obj in list(self._known.items()):
            if key not in fresh:
                self._feed("deleted", obj)
        self._known = fresh
        self.synced.set()
        return rv

    def _run(self) -> None:
        failures = 0
        rv: Optional[str] = None
        while not self._stop.is_set():
            if not self.breaker.allow():
                # open: one probe per bounded interval, nothing else
                self._stop.wait(max(self.breaker.retry_in(), 0.02))
                continue
            try:
                if rv is None:
                    rv = self._relist()
                    self.breaker.record_success()
                self.rewatches += 1
                for etype, obj in self.client.watch(
                        self.path, rv, register=self._register_conn):
                    if self._stop.is_set():
                        break
                    self.breaker.record_success()
                    action = etype.lower()
                    if action not in ("added", "modified", "deleted"):
                        continue  # e.g. BOOKMARK
                    key = self._key(obj)
                    if action == "deleted":
                        self._known.pop(key, None)
                    else:
                        self._known[key] = obj
                    self._feed(action, obj)
                    new_rv = obj.get("metadata", {}) \
                        .get("resourceVersion")
                    if new_rv is not None:
                        rv = new_rv
                    failures = 0
                # clean stream end: re-watch from the last version
            except GoneError:
                # compacted: full relist is the ONLY correct recovery
                # (not a transport failure — the breaker stays closed)
                rv = None
            except AttributeError:
                # http.client nulls resp.fp when stop() closes the
                # connection under a blocked reader; ONLY during stop
                # is that a dead stream — otherwise it's a real bug
                if not self._stop.is_set():
                    raise
            except (OSError, http.client.HTTPException):
                # HTTPException covers NotConnected from a conn the
                # stop path tore down (auto_open cleared) and
                # IncompleteRead from a stream cut mid-chunk
                self.breaker.record_failure()
                failures += 1
                self._stop.wait(min(self.backoff_base * (2 ** failures),
                                    self.backoff_max))
        # loop exits on stop()


class K8sTransport:
    """All eight reflectors against one apiserver, feeding one
    K8sWatcher (daemon/k8s_watcher.go EnableK8sWatcher analog)."""

    def __init__(self, watcher, base_url: str,
                 resources: Optional[Dict[str, str]] = None):
        self.client = K8sClient(base_url)
        self.reflectors = [
            Reflector(self.client, path, kind, watcher)
            for path, kind in (resources or WATCHED_RESOURCES).items()]

    def start(self) -> "K8sTransport":
        for r in self.reflectors:
            r.start()
        return self

    def wait_synced(self, timeout: float = 10.0) -> bool:
        deadline = time.time() + timeout
        for r in self.reflectors:
            if not r.synced.wait(max(0.0, deadline - time.time())):
                return False
        return True

    def stop(self) -> None:
        for r in self.reflectors:
            r._stop.set()
        for r in self.reflectors:
            r.stop()
