"""Backend interface for the control-plane kvstore.

A whole copy of ``cilium_tpu/kvstore/backend.py``.

Mirrors the operation set of the reference's ``BackendOperations``
(pkg/kvstore/backend.go:86-146): plain gets/sets, atomic CreateOnly /
CreateIfExists, prefix listing, lease-backed keys that vanish when their
owner dies, prefix watches, and distributed locks.  Values are ``bytes``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

# Watch event types (reference: pkg/kvstore/events.go).
EVENT_CREATE = "create"
EVENT_MODIFY = "modify"
EVENT_DELETE = "delete"
EVENT_LIST_DONE = "list-done"  # initial listing finished


@dataclass(frozen=True)
class Event:
    """One watch notification."""

    typ: str
    key: str = ""
    value: bytes = b""


class KVLockError(RuntimeError):
    """Raised when a distributed lock cannot be acquired in time."""


class Watcher:
    """A prefix watch: iterate events until ``stop()``.

    Reference: pkg/kvstore/watcher.go — events are queued so slow
    consumers never block writers.
    """

    def __init__(self, prefix: str, backend: "BackendOperations"):
        self.prefix = prefix
        self._backend = backend
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._stopped = threading.Event()

    def _emit(self, event: Event) -> None:
        if not self._stopped.is_set():
            self._queue.put(event)

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event or None on stop/timeout."""
        if self._stopped.is_set() and self._queue.empty():
            return None
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def __iter__(self) -> Iterator[Event]:
        while True:
            ev = self._queue.get()
            if ev is None:
                return
            yield ev

    def stop(self) -> None:
        self._stopped.set()
        self._backend._remove_watcher(self)
        self._queue.put(None)


class Lock:
    """Handle for a held distributed lock; ``unlock()`` or context-manage."""

    def __init__(self, backend: "BackendOperations", path: str, token: str):
        self._backend = backend
        self.path = path
        self.token = token

    def unlock(self) -> None:
        self._backend._unlock(self.path, self.token)

    def __enter__(self) -> "Lock":
        return self

    def __exit__(self, *exc) -> None:
        self.unlock()


class BackendOperations:
    """Abstract kvstore backend (reference: pkg/kvstore/backend.go:86)."""

    name = "abstract"

    # Optional liveness hook: transports with a background lease
    # keepalive loop (etcd, remote) call ``keepalive_listener(ok)``
    # after each keepalive attempt when set — the outage detector's
    # passive signal (kvstore/outage.py) for a control plane that died
    # with no foreground op in flight.
    keepalive_listener: "Optional[callable]" = None

    # -- plain ops ---------------------------------------------------------
    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> Optional[bytes]:
        """Value of the first key matching the prefix."""
        raise NotImplementedError

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    # -- atomic ops (the allocator protocol depends on these) --------------
    def create_only(self, key: str, value: bytes,
                    lease: bool = False) -> bool:
        """Create iff absent; True on success."""
        raise NotImplementedError

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        """Create ``key`` iff ``cond_key`` exists (atomically)."""
        raise NotImplementedError

    # -- listing / watching ------------------------------------------------
    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def watch(self, prefix: str) -> Watcher:
        """Stream future events under prefix."""
        raise NotImplementedError

    def list_and_watch(self, prefix: str) -> Watcher:
        """EVENT_CREATE for every existing key, EVENT_LIST_DONE, then
        live events (reference: ListAndWatch, backend.go:144)."""
        raise NotImplementedError

    # -- locks / liveness --------------------------------------------------
    def lock_path(self, path: str, timeout: float = 30.0) -> Lock:
        raise NotImplementedError

    def renew_lease(self) -> None:
        """Keepalive for this client's lease (no-op where implicit)."""

    def close(self) -> None:
        pass

    def status(self) -> str:
        return f"{self.name}: ok"

    # hooks used by Watcher/Lock
    def _remove_watcher(self, watcher: Watcher) -> None:
        raise NotImplementedError

    def _unlock(self, path: str, token: str) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Module-level client (reference: pkg/kvstore/client.go Get/setup pattern).

_registry: Dict[str, type] = {}
_client: Optional[BackendOperations] = None
_client_lock = threading.Lock()


def register_backend(name: str, cls: type) -> None:
    _registry[name] = cls


def setup_client(backend_name: str, **opts) -> BackendOperations:
    """Select and instantiate the process-global kvstore client."""
    global _client
    with _client_lock:
        if _client is not None:
            _client.close()
        cls = _registry[backend_name]
        _client = cls(**opts)
        return _client


def setup_dummy() -> BackendOperations:
    """In-process backend for tests (reference: dummy.go:18 SetupDummy)."""
    return setup_client("in-memory")


def get_client() -> BackendOperations:
    if _client is None:
        raise RuntimeError("kvstore client not configured; "
                           "call setup_client()/setup_dummy() first")
    return _client


def close_client() -> None:
    global _client
    with _client_lock:
        if _client is not None:
            _client.close()
            _client = None
