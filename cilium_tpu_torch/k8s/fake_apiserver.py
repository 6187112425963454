"""In-repo fake Kubernetes apiserver speaking the real list/watch wire.

Reference: the agent's informers talk HTTP to a real apiserver
(daemon/k8s_watcher.go:70-78 builds client-go informers).  This
environment has zero egress, so the transport is tested against this
fake instead: a threaded HTTP server implementing the protocol subset
client-go's Reflector actually uses —

- ``GET <prefix>/<resource>``: list; returns ``{"kind": ..., "items":
  [...], "metadata": {"resourceVersion": "<R>"}}`` where R is the
  store's current global version;
- ``GET <prefix>/<resource>?watch=true&resourceVersion=<R>``: a
  chunked, newline-delimited JSON stream of ``{"type": "ADDED" |
  "MODIFIED" | "DELETED", "object": {...}}`` events with version > R,
  held open until the client or the server drops it;
- **410 Gone**: the event history is bounded (and compactable on
  demand); a watch from a compacted-away version streams one
  ``{"type": "ERROR", "object": {"kind": "Status", "code": 410}}``
  event — the reflector must full-relist (client-go's
  ``resourceVersion too old`` path).

The Python-level control surface (``upsert``/``delete``/
``disconnect_watchers``/``compact``) is the test's hand on the cluster:
existing replay fixtures become scripts driving it.

A whole copy of ``cilium_tpu/k8s/fake_apiserver.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

# resource path -> canonical resource name; mirrors the group/version
# layout the reference watches (daemon/k8s_watcher.go:549-560)
RESOURCE_PATHS = {
    "/apis/cilium.io/v2/ciliumnetworkpolicies": "ciliumnetworkpolicies",
    "/apis/networking.k8s.io/v1/networkpolicies": "networkpolicies",
    "/api/v1/services": "services",
    "/api/v1/endpoints": "endpoints",
    "/api/v1/pods": "pods",
    "/api/v1/nodes": "nodes",
    "/api/v1/namespaces": "namespaces",
    "/apis/networking.k8s.io/v1/ingresses": "ingresses",
}

LIST_KINDS = {
    "ciliumnetworkpolicies": "CiliumNetworkPolicyList",
    "networkpolicies": "NetworkPolicyList",
    "services": "ServiceList",
    "endpoints": "EndpointsList",
    "pods": "PodList",
    "nodes": "NodeList",
    "namespaces": "NamespaceList",
    "ingresses": "IngressList",
}


class _Store:
    """One resource's objects + the shared event history."""

    def __init__(self):
        self.objects: Dict[Tuple[str, str], Dict] = {}


class FakeAPIServer:
    """Threaded fake apiserver; start() binds an ephemeral port."""

    def __init__(self, history_limit: int = 1024):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rv = 0
        self._stores: Dict[str, _Store] = {
            name: _Store() for name in RESOURCE_PATHS.values()}
        # (rv, resource, type, object snapshot); bounded
        self._history: List[Tuple[int, str, str, Dict]] = []
        self._history_limit = history_limit
        self._oldest_rv = 0      # lowest rv still replayable
        self._watch_epoch = 0    # bump = kill live watch streams
        self.watch_requests = 0
        self.list_requests = 0
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        httpd.fake = self
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True, name="fake-apiserver")

    # ------------------------------------------------------- lifecycle

    def start(self) -> "FakeAPIServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        with self._cond:
            self._watch_epoch += 1
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # --------------------------------------------------- control plane

    def upsert(self, resource: str, obj: Dict) -> int:
        """Create or replace an object; stamps metadata.resourceVersion
        and records an ADDED/MODIFIED event.  Returns the new rv."""
        meta = obj.setdefault("metadata", {})
        key = (meta.get("namespace", ""), meta.get("name", ""))
        with self._cond:
            self._rv += 1
            meta["resourceVersion"] = str(self._rv)
            store = self._stores[resource]
            etype = "MODIFIED" if key in store.objects else "ADDED"
            snapshot = json.loads(json.dumps(obj))
            store.objects[key] = snapshot
            self._append_history(resource, etype, snapshot)
            self._cond.notify_all()
            return self._rv

    def delete(self, resource: str, namespace: str, name: str) -> bool:
        with self._cond:
            store = self._stores[resource]
            obj = store.objects.pop((namespace, name), None)
            if obj is None:
                return False
            self._rv += 1
            # deep copy: the popped snapshot's metadata dict is shared
            # with the history's ADDED/MODIFIED entries — stamping the
            # delete rv in place would corrupt their recorded versions
            obj = json.loads(json.dumps(obj))
            obj.setdefault("metadata", {})["resourceVersion"] = \
                str(self._rv)
            self._append_history(resource, "DELETED", obj)
            self._cond.notify_all()
            return True

    def disconnect_watchers(self) -> None:
        """Drop every live watch stream (network blip / apiserver
        restart simulation).  Clients must reconnect from their last
        seen resourceVersion."""
        with self._cond:
            self._watch_epoch += 1
            self._cond.notify_all()

    def compact(self) -> None:
        """Discard the whole event history: any watch from a version
        before now gets 410 Gone (etcd compaction analog)."""
        with self._cond:
            self._history.clear()
            self._oldest_rv = self._rv
            self._cond.notify_all()

    def _append_history(self, resource, etype, obj) -> None:
        self._history.append((self._rv, resource, etype, obj))
        if len(self._history) > self._history_limit:
            drop = len(self._history) - self._history_limit
            self._oldest_rv = self._history[drop - 1][0]
            del self._history[:drop]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):  # noqa: N802 — http.server contract
        fake: FakeAPIServer = self.server.fake
        url = urlparse(self.path)
        resource = RESOURCE_PATHS.get(url.path)
        if resource is None:
            self._json(404, {"kind": "Status", "code": 404,
                             "message": f"unknown path {url.path}"})
            return
        qs = parse_qs(url.query)
        if qs.get("watch", ["false"])[0] in ("true", "1"):
            self._watch(fake, resource, qs)
        else:
            self._list(fake, resource)

    # ------------------------------------------------------------ list

    def _list(self, fake: FakeAPIServer, resource: str) -> None:
        with fake._cond:
            fake.list_requests += 1
            items = list(fake._stores[resource].objects.values())
            rv = fake._rv
        self._json(200, {"kind": LIST_KINDS[resource],
                         "apiVersion": "v1",
                         "metadata": {"resourceVersion": str(rv)},
                         "items": items})

    # ----------------------------------------------------------- watch

    def _watch(self, fake: FakeAPIServer, resource: str, qs) -> None:
        try:
            since = int(qs.get("resourceVersion", ["0"])[0])
        except ValueError:
            since = 0
        with fake._cond:
            fake.watch_requests += 1
            gone = since < fake._oldest_rv
            epoch = fake._watch_epoch
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        if gone:
            # client-go's "resourceVersion too old": one ERROR event,
            # then the stream ends; the reflector must relist
            self._chunk({"type": "ERROR",
                         "object": {"kind": "Status", "code": 410,
                                    "reason": "Expired",
                                    "message": "resourceVersion too "
                                               "old"}})
            self._chunk_end()
            return
        cursor = since
        try:
            while True:
                with fake._cond:
                    idle = False
                    while True:
                        if fake._watch_epoch != epoch:
                            raise ConnectionAbortedError
                        pending = [
                            (rv, et, obj)
                            for rv, res, et, obj in fake._history
                            if res == resource and rv > cursor]
                        if pending:
                            break
                        if not fake._cond.wait(timeout=0.5):
                            idle = True
                            break
                    rv_now = fake._rv
                if idle:
                    # heartbeat on idle ticks (watch BOOKMARK analog,
                    # mirroring mini_etcd's progress notify): the
                    # write is what surfaces an abandoned client as
                    # BrokenPipeError so this handler thread exits
                    # instead of spinning on cond.wait forever
                    self._chunk({"type": "BOOKMARK", "object": {
                        "metadata": {"resourceVersion": str(rv_now)}}})
                    continue
                for rv, etype, obj in pending:
                    self._chunk({"type": etype, "object": obj})
                    cursor = rv
        except (ConnectionAbortedError, BrokenPipeError, OSError):
            try:
                self._chunk_end()
            except OSError:
                pass
            # tell http.server not to reuse the half-dead stream
            self.close_connection = True

    # ------------------------------------------------------------ util

    def _chunk(self, obj: Dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def _chunk_end(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _json(self, code: int, obj: Dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
