"""Container-runtime workload watchers.

The port's copy of the container watchers of ``cilium_tpu/workloads.py``
(``WorkloadWatcher``, ``DockerClient``, ``DockerEventWatcher``).  The
port's ``workloads.py`` is its bench-workload module, so the watchers
live here under another name.

Reference: pkg/workloads — docker/containerd/CRI-O event watchers keep
endpoint labels in sync with container state (start events create or
relabel endpoints, die events clean them up).

Two layers, like the reference's split between the runtime client and
the workload logic:

- ``WorkloadWatcher``: the pluggable sink — any source pushes
  ``start``/``stop`` events with container metadata; it drives the
  daemon's endpoint lifecycle and allocates IPs through IPAM.
- ``DockerClient`` + ``DockerEventWatcher``: the real runtime client
  (pkg/workloads/docker.go analog) — Docker Engine API over the
  dockerd unix socket: initial ``GET /containers/json`` sync, then a
  streaming ``GET /events`` subscription (chunked newline-delimited
  JSON), inspecting containers on ``start`` and cleaning up on
  ``die``, reconnecting with backoff when the stream drops.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
from typing import Callable, Dict, Iterator, List, Optional

from .ipam import HostScopeIPAM, IPAMError
from .utils.netio import teardown_http_conn


class WorkloadWatcher:
    """Container events -> endpoint lifecycle."""

    def __init__(self, daemon, ipam: Optional[HostScopeIPAM] = None,
                 label_prefix: str = "container"):
        self.daemon = daemon
        self.ipam = ipam
        self.label_prefix = label_prefix
        self._lock = threading.Lock()
        self._by_container: Dict[str, int] = {}
        self._next_ep_id = 1000
        self.events = 0

    def _labels_of(self, container: Dict) -> List[str]:
        return [f"{self.label_prefix}:{k}={v}"
                for k, v in sorted((container.get("labels") or {}).items())]

    def on_start(self, container: Dict) -> int:
        """Container started (workloads processCreateWorkload): create
        or relabel its endpoint. ``container``: {id, name, labels}."""
        cid = container["id"]
        with self._lock:
            self.events += 1
            ep_id = self._by_container.get(cid)
            if ep_id is None:
                ep_id = self._next_ep_id
                self._next_ep_id += 1
                self._by_container[cid] = ep_id
                create = True
            else:
                create = False
        labels = self._labels_of(container)
        if create:
            ipv4 = ""
            if self.ipam is not None:
                try:
                    ipv4 = self.ipam.allocate_next(owner=cid)
                except IPAMError:
                    ipv4 = ""
            self.daemon.endpoint_create(
                ep_id, ipv4=ipv4, container_name=container.get("name", cid),
                labels=labels)
        else:
            self.daemon.endpoint_update_labels(ep_id, labels)
        return ep_id

    def on_stop(self, container_id: str) -> bool:
        """Container died: tear the endpoint down."""
        with self._lock:
            self.events += 1
            ep_id = self._by_container.pop(container_id, None)
        if ep_id is None:
            return False
        ep = self.daemon.endpoints.lookup(ep_id)
        ip = ep.ipv4 if ep else ""
        ok = self.daemon.endpoint_delete(ep_id)
        if ok and ip and self.ipam is not None:
            self.ipam.release(ip)
        return ok

    def endpoint_of(self, container_id: str) -> Optional[int]:
        with self._lock:
            return self._by_container.get(container_id)

    def containers(self) -> List[str]:
        """Container ids with live endpoints (resync diff base)."""
        with self._lock:
            return list(self._by_container)

    def __len__(self):
        with self._lock:
            return len(self._by_container)


# ---------------------------------------------------------------------------
# Docker runtime client (pkg/workloads/docker.go analog)

class UnixHTTPConnection(http.client.HTTPConnection):
    """HTTP over an AF_UNIX socket (the dockerd transport)."""

    def __init__(self, path: str, timeout: float = 10.0):
        super().__init__("localhost", timeout=timeout)
        self.unix_path = path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self.unix_path)
        self.sock = s


class DockerError(RuntimeError):
    pass


class DockerClient:
    """Minimal Docker Engine API client over the daemon socket."""

    def __init__(self, socket_path: str = "/var/run/docker.sock",
                 timeout: float = 10.0):
        self.socket_path = socket_path
        self.timeout = timeout

    def _request(self, path: str) -> Dict:
        conn = UnixHTTPConnection(self.socket_path, self.timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise DockerError(f"{path}: HTTP {resp.status}")
            return json.loads(data)
        except (OSError, ValueError) as e:
            raise DockerError(f"{path}: {e}") from e
        finally:
            conn.close()

    def ping(self) -> bool:
        try:
            self._request("/containers/json?limit=1")
            return True
        except DockerError:
            return False

    def list_containers(self) -> List[Dict]:
        """Running containers (GET /containers/json)."""
        return self._request("/containers/json")

    def inspect(self, container_id: str) -> Dict:
        """GET /containers/{id}/json."""
        return self._request(f"/containers/{container_id}/json")

    def events(self, register: Optional[Callable] = None
               ) -> "_EventStream":
        """Subscribe to container events (GET /events): newline-
        delimited JSON over a chunked response held open by dockerd.

        The subscription is established EAGERLY (request sent,
        response headers read) before this returns — the caller can
        list containers afterwards knowing no event falls between the
        list and the stream (docker.go subscribes before syncing for
        the same reason).  ``register(conn)`` hands the live
        connection to the caller's stop path."""
        return _EventStream(self, register)


class _EventStream:
    """One live /events subscription; iterate for events."""

    def __init__(self, client: DockerClient,
                 register: Optional[Callable]):
        self._conn = UnixHTTPConnection(client.socket_path,
                                        client.timeout)
        try:
            self._conn.connect()
            if register is not None:
                register(self._conn)
            self._conn.request("GET", "/events?type=container")
            self._resp = self._conn.getresponse()
            if self._resp.status != 200:
                raise DockerError(
                    f"/events: HTTP {self._resp.status}")
            self._conn.sock.settimeout(None)
        except DockerError:
            teardown_http_conn(self._conn)
            raise
        except (OSError, http.client.HTTPException) as e:
            teardown_http_conn(self._conn)
            raise DockerError(f"/events: {e}") from e

    def __iter__(self) -> Iterator[Dict]:
        try:
            for raw in self._resp:
                line = raw.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    raise DockerError("/events: bad frame")
        except (OSError, http.client.HTTPException,
                ValueError, AttributeError) as e:
            # ValueError/AttributeError: http.client artifacts of the
            # stop path cutting the socket mid-chunk / nulling resp.fp
            raise DockerError(f"/events: {e}") from e
        finally:
            self.close()

    def close(self) -> None:
        teardown_http_conn(self._conn)


def _container_meta(inspect: Dict) -> Dict:
    """Inspect result -> the pluggable watcher's container dict."""
    return {
        "id": inspect.get("Id", ""),
        "name": (inspect.get("Name") or "").lstrip("/"),
        "labels": (inspect.get("Config") or {}).get("Labels") or {},
    }


class DockerEventWatcher:
    """dockerd events -> the pluggable WorkloadWatcher.

    Reference flow (pkg/workloads/docker.go EnableEventListener):
    list running containers first (processes started while the agent
    was down), then consume the event stream; ``start`` inspects and
    creates/relabels, ``die`` tears down.  Stream loss reconnects with
    backoff and RESYNCS (a container that died during the gap must not
    leak its endpoint)."""

    def __init__(self, client: DockerClient, sink: WorkloadWatcher,
                 backoff_base: float = 0.1, backoff_max: float = 5.0):
        self.client = client
        self.sink = sink
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._stop = threading.Event()
        self._conn_lock = threading.Lock()
        self._conn = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="docker-events")
        self.synced = threading.Event()
        self.resyncs = 0

    def start(self) -> "DockerEventWatcher":
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        with self._conn_lock:
            if self._conn is not None:
                teardown_http_conn(self._conn)
        # the thread may be inside a list/inspect call on its own
        # connection (bounded by client.timeout) — wait that out, and
        # the sink calls re-check _stop so a stalled dockerd can't
        # drive endpoint churn after stop() returns
        self._thread.join(timeout=self.client.timeout + 2.0
                          if timeout is None else timeout)

    def _register(self, conn) -> None:
        with self._conn_lock:
            self._conn = conn
        if self._stop.is_set():
            teardown_http_conn(conn)

    def _sync(self) -> None:
        """Reconcile against the runtime's current truth."""
        running = {}
        for c in self.client.list_containers():
            cid = c.get("Id", "")
            if not cid:
                continue
            running[cid] = {
                "id": cid,
                "name": (c.get("Names") or ["/"])[0].lstrip("/"),
                "labels": c.get("Labels") or {},
            }
        known = set(self.sink.containers())
        for cid, meta in running.items():
            self.sink.on_start(meta)
        for cid in known - set(running):
            self.sink.on_stop(cid)
        self.resyncs += 1
        self.synced.set()

    def _run(self) -> None:
        failures = 0
        while not self._stop.is_set():
            stream = None
            try:
                # subscribe FIRST, then sync: an event landing between
                # the container list and the stream open would
                # otherwise be lost forever (the stream buffers it)
                stream = self.client.events(register=self._register)
                self._sync()
                failures = 0  # subscribed + synced = healthy again
                for ev in stream:
                    if self._stop.is_set():
                        break
                    if ev.get("Type", "container") != "container":
                        continue
                    action = ev.get("Action") or ev.get("status", "")
                    cid = (ev.get("Actor") or {}).get("ID") \
                        or ev.get("id", "")
                    if not cid:
                        continue
                    if action == "start":
                        try:
                            meta = _container_meta(
                                self.client.inspect(cid))
                        except DockerError:
                            # transient inspect failure (timeout, or
                            # raced a fast die): fall back to the
                            # event's own Actor.Attributes — docker
                            # carries the container labels there —
                            # rather than leaving the container
                            # endpoint-less until the next resync
                            attrs = dict((ev.get("Actor") or {})
                                         .get("Attributes") or {})
                            name = attrs.pop("name", cid[:12])
                            attrs.pop("image", None)
                            meta = {"id": cid, "name": name,
                                    "labels": attrs}
                        if self._stop.is_set():
                            break
                        self.sink.on_start(meta)
                    elif action in ("die", "stop", "destroy"):
                        if self._stop.is_set():
                            break
                        self.sink.on_stop(cid)
            except DockerError:
                failures += 1
            finally:
                if stream is not None:
                    stream.close()  # a failed _sync must not leak the
                    #                 live subscription for the backoff
            if self._stop.is_set():
                return
            # back off before re-subscribing even on a CLEAN stream
            # end (dockerd restart phases close streams politely — a
            # no-wait loop would hammer it with connect+resync);
            # exponent clamped so a long outage can't overflow
            self._stop.wait(min(
                self.backoff_base * (2 ** min(failures, 8)),
                self.backoff_max))
