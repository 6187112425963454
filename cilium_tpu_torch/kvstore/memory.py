"""In-process kvstore backend.

A whole copy of ``cilium_tpu/kvstore/memory.py``.

Serves the role of the reference's dummy backend for tests
(pkg/kvstore/dummy.go:18) *and* of an etcd stand-in for single-host
multi-agent simulation: several ``InMemoryBackend`` clients may share one
``MemStore``, each with its own lease session, so lease expiry semantics
(dead node => its lease-backed keys vanish and watchers see deletes —
reference: pkg/kvstore/allocator/allocator.go:88-89) are testable without
a real etcd.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from .backend import (EVENT_CREATE, EVENT_DELETE, EVENT_LIST_DONE,
                      EVENT_MODIFY, BackendOperations, Event, KVLockError,
                      Lock, Watcher, register_backend)

# Reference etcd sessions are 15-minute leases kept alive by the client.
DEFAULT_LEASE_TTL = 900.0


class MemStore:
    """Shared state behind one or more InMemoryBackend clients."""

    def __init__(self):
        self.mu = threading.RLock()
        # key -> (value, owning session id or None)
        self.data: Dict[str, Tuple[bytes, Optional[str]]] = {}
        # session id -> expiry deadline (monotonic seconds)
        self.sessions: Dict[str, float] = {}
        self.watchers: List[Tuple[str, Watcher]] = []
        # lock path -> (token, session id)
        self.locks: Dict[str, Tuple[str, str]] = {}
        self.lock_cv = threading.Condition(self.mu)

    # All methods below assume self.mu is held.

    def _emit(self, event: Event) -> None:
        for prefix, watcher in list(self.watchers):
            if event.key.startswith(prefix):
                watcher._emit(event)

    def _put(self, key: str, value: bytes, session: Optional[str]) -> None:
        typ = EVENT_MODIFY if key in self.data else EVENT_CREATE
        self.data[key] = (value, session)
        self._emit(Event(typ, key, value))

    def _drop(self, key: str) -> None:
        if key in self.data:
            value, _ = self.data.pop(key)
            self._emit(Event(EVENT_DELETE, key, value))

    def expire_sessions(self, now: Optional[float] = None) -> None:
        """Reap dead sessions: their keys and locks evaporate."""
        now = time.monotonic() if now is None else now
        dead = [s for s, dl in self.sessions.items() if dl <= now]
        for session in dead:
            del self.sessions[session]
            for key in [k for k, (_, s) in self.data.items() if s == session]:
                self._drop(key)
            for path in [p for p, (_, s) in self.locks.items()
                         if s == session]:
                del self.locks[path]
        if dead:
            self.lock_cv.notify_all()


class InMemoryBackend(BackendOperations):
    """One client session over a (possibly shared) MemStore."""

    name = "in-memory"

    def __init__(self, store: Optional[MemStore] = None,
                 lease_ttl: float = DEFAULT_LEASE_TTL):
        self.store = store if store is not None else MemStore()
        self.lease_ttl = lease_ttl
        self.session = uuid.uuid4().hex
        with self.store.mu:
            self.store.sessions[self.session] = \
                time.monotonic() + lease_ttl

    def _lease_session(self) -> str:
        """Session id for lease-backed writes, revived if reaped.

        A client stalled past its TTL gets its session (and keys)
        reaped; without revival its later keepalives would silently
        no-op and new lease-backed keys would belong to a session id
        absent from the sessions map — unreapable forever.  Assumes
        store.mu is held.
        """
        if self.session not in self.store.sessions:
            self.store.sessions[self.session] = \
                time.monotonic() + self.lease_ttl
        return self.session

    # -- plain ops ---------------------------------------------------------
    def get(self, key: str) -> Optional[bytes]:
        with self.store.mu:
            self.store.expire_sessions()
            entry = self.store.data.get(key)
            return entry[0] if entry else None

    def get_prefix(self, prefix: str) -> Optional[bytes]:
        with self.store.mu:
            self.store.expire_sessions()
            for key in sorted(self.store.data):
                if key.startswith(prefix):
                    return self.store.data[key][0]
        return None

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        with self.store.mu:
            self.store.expire_sessions()
            self.store._put(key, value,
                            self._lease_session() if lease else None)

    def delete(self, key: str) -> None:
        with self.store.mu:
            self.store.expire_sessions()
            self.store._drop(key)

    def delete_prefix(self, prefix: str) -> None:
        with self.store.mu:
            self.store.expire_sessions()
            for key in [k for k in self.store.data if k.startswith(prefix)]:
                self.store._drop(key)

    # -- atomic ops --------------------------------------------------------
    def create_only(self, key: str, value: bytes,
                    lease: bool = False) -> bool:
        with self.store.mu:
            self.store.expire_sessions()
            if key in self.store.data:
                return False
            self.store._put(key, value,
                            self._lease_session() if lease else None)
            return True

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        with self.store.mu:
            self.store.expire_sessions()
            if cond_key not in self.store.data or key in self.store.data:
                return False
            self.store._put(key, value,
                            self._lease_session() if lease else None)
            return True

    # -- listing / watching ------------------------------------------------
    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        with self.store.mu:
            self.store.expire_sessions()
            return {k: v for k, (v, _) in self.store.data.items()
                    if k.startswith(prefix)}

    def watch(self, prefix: str) -> Watcher:
        watcher = Watcher(prefix, self)
        with self.store.mu:
            self.store.watchers.append((prefix, watcher))
        return watcher

    def list_and_watch(self, prefix: str) -> Watcher:
        watcher = Watcher(prefix, self)
        with self.store.mu:
            self.store.expire_sessions()
            for key in sorted(self.store.data):
                if key.startswith(prefix):
                    watcher._emit(
                        Event(EVENT_CREATE, key, self.store.data[key][0]))
            watcher._emit(Event(EVENT_LIST_DONE))
            self.store.watchers.append((prefix, watcher))
        return watcher

    def _remove_watcher(self, watcher: Watcher) -> None:
        with self.store.mu:
            self.store.watchers = [(p, w) for p, w in self.store.watchers
                                   if w is not watcher]

    # -- locks / liveness --------------------------------------------------
    def lock_path(self, path: str, timeout: float = 30.0) -> Lock:
        token = uuid.uuid4().hex
        deadline = time.monotonic() + timeout
        with self.store.mu:
            while True:
                self.store.expire_sessions()
                if path not in self.store.locks:
                    self.store.locks[path] = (token, self.session)
                    return Lock(self, path, token)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise KVLockError(f"lock {path!r}: timeout")
                self.store.lock_cv.wait(min(remaining, 0.05))

    def _unlock(self, path: str, token: str) -> None:
        with self.store.mu:
            held = self.store.locks.get(path)
            if held and held[0] == token:
                del self.store.locks[path]
                self.store.lock_cv.notify_all()

    def renew_lease(self) -> None:
        with self.store.mu:
            # revives a reaped session (see _lease_session): a client
            # that stalled past its TTL must regain liveness rather
            # than keep "renewing" a session that no longer exists
            self.store.sessions[self._lease_session()] = \
                time.monotonic() + self.lease_ttl

    def expire_now(self) -> None:
        """Test hook: this client's lease dies immediately (node failure)."""
        with self.store.mu:
            if self.session in self.store.sessions:
                self.store.sessions[self.session] = 0.0
            self.store.expire_sessions()

    def close(self) -> None:
        self.expire_now()

    def status(self) -> str:
        with self.store.mu:
            return (f"{self.name}: {len(self.store.data)} keys, "
                    f"{len(self.store.sessions)} sessions")


register_backend(InMemoryBackend.name, InMemoryBackend)
