"""Distributed ID allocation over the kvstore.

A whole copy of ``cilium_tpu/kvstore/allocator.py``: IDs are drawn
with Python's ``random.Random(seed)``, so a seeded allocator hands out
the reference's IDs in the reference's order.

Implements the reference's allocator protocol
(pkg/kvstore/allocator/allocator.go:51-135):

- master key ``<prefix>/id/<ID>`` -> key, created atomically (CreateOnly)
  by the first node to claim the ID;
- per-node lease-protected slave key ``<prefix>/value/<key>/<node>`` -> ID,
  marking the node's use of the key (the lease reaps it if the node dies);
- allocate: local-refcount hit, else reuse the ID seen in the watched
  cache (slave key created *conditional on the master still existing*),
  else pick a free ID and CreateOnly the master;
- release: local refcount, on zero delete the slave key;
- GC: delete master keys with no remaining slave keys;
- a watch on ``id/`` feeds every node's cache (and remote clusters').
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, Optional, Tuple

from .backend import (EVENT_CREATE, EVENT_DELETE, EVENT_LIST_DONE,
                      EVENT_MODIFY, BackendOperations)

MAX_ALLOCATE_ATTEMPTS = 16


class AllocatorError(RuntimeError):
    pass


class Allocator:
    """Generic distributed key<->ID allocator (keys are opaque strings)."""

    def __init__(self, backend: BackendOperations, prefix: str, node: str,
                 min_id: int, max_id: int,
                 on_event: Optional[Callable[[str, int, str], None]] = None,
                 seed: Optional[int] = None):
        self.backend = backend
        self.prefix = prefix.rstrip("/")
        self.node = node
        self.min_id = min_id
        self.max_id = max_id
        self._rng = random.Random(seed)
        self._mu = threading.RLock()
        # local refcounts: key -> (id, refcount)  (reference: localkeys.go)
        self._local: Dict[str, Tuple[int, int]] = {}
        # watch-fed global cache
        self._id_to_key: Dict[int, str] = {}
        self._key_to_id: Dict[str, int] = {}
        self._on_event = on_event  # (typ, id, key)
        self._synced = threading.Event()
        self._watcher = backend.list_and_watch(self._id_prefix())
        self._thread = threading.Thread(target=self._watch_loop, daemon=True)
        self._thread.start()
        self._synced.wait(5.0)

    # -- key layout --------------------------------------------------------
    def _id_prefix(self) -> str:
        return f"{self.prefix}/id/"

    def _master_key(self, id_: int) -> str:
        return f"{self.prefix}/id/{id_}"

    def _slave_prefix(self, key: str) -> str:
        return f"{self.prefix}/value/{key}/"

    def _slave_key(self, key: str) -> str:
        return self._slave_prefix(key) + self.node

    # -- watch -> cache ----------------------------------------------------
    def _watch_loop(self) -> None:
        for event in self._watcher:
            if event.typ == EVENT_LIST_DONE:
                self._synced.set()
                continue
            try:
                id_ = int(event.key.rsplit("/", 1)[1])
            except ValueError:
                continue
            key = event.value.decode()
            with self._mu:
                if event.typ in (EVENT_CREATE, EVENT_MODIFY):
                    self._id_to_key[id_] = key
                    self._key_to_id[key] = id_
                else:
                    stale = self._id_to_key.pop(id_, None)
                    if stale is not None and \
                            self._key_to_id.get(stale) == id_:
                        del self._key_to_id[stale]
                    key = stale if stale is not None else key
            if self._on_event:
                typ = {EVENT_CREATE: "add", EVENT_MODIFY: "modify",
                       EVENT_DELETE: "delete"}[event.typ]
                self._on_event(typ, id_, key)

    # -- allocation --------------------------------------------------------
    def _select_free_id(self) -> int:
        """Random probe into the ID space avoiding known-used IDs
        (reference: idpool.go draws from a pool; random probing gives the
        same low-collision behavior without materializing the pool)."""
        span = self.max_id - self.min_id + 1
        used = self._id_to_key
        if len(used) >= span:
            raise AllocatorError("ID space exhausted")
        for _ in range(64):
            cand = self.min_id + self._rng.randrange(span)
            if cand not in used:
                return cand
        for cand in range(self.min_id, self.max_id + 1):  # dense fallback
            if cand not in used:
                return cand
        raise AllocatorError("ID space exhausted")

    def _lookup_no_cache(self, key: str) -> Optional[int]:
        """Authoritative key->ID lookup straight from the kvstore (the
        watch cache may lag a concurrent allocation on another node)."""
        for raw in self.backend.list_prefix(self._slave_prefix(key)).values():
            try:
                return int(raw.decode())
            except ValueError:
                continue
        for mkey, raw in self.backend.list_prefix(self._id_prefix()).items():
            if raw.decode() == key:
                try:
                    return int(mkey.rsplit("/", 1)[1])
                except ValueError:
                    continue
        return None

    def allocate(self, key: str) -> Tuple[int, bool]:
        """Return (id, is_new_master). Reference: allocator.go Allocate."""
        with self._mu:
            held = self._local.get(key)
            if held is not None:
                id_, ref = held
                self._local[key] = (id_, ref + 1)
                return id_, False
        # Slow path under a per-key distributed lock (the reference locks
        # the key during first allocation so concurrent nodes converge on
        # one master).
        with self.backend.lock_path(f"{self.prefix}/locks/{key}",
                                    timeout=30.0):
            return self._allocate_locked(key)

    def _allocate_locked(self, key: str) -> Tuple[int, bool]:
        for _ in range(MAX_ALLOCATE_ATTEMPTS):
            # Reuse an ID another node already bound to this key: slave
            # key creation is conditional on the master still existing.
            with self._mu:
                existing = self._key_to_id.get(key)
            if existing is None:
                existing = self._lookup_no_cache(key)
            if existing is not None:
                if self.backend.create_if_exists(
                        self._master_key(existing), self._slave_key(key),
                        str(existing).encode(), lease=True):
                    with self._mu:
                        self._local[key] = (existing, 1)
                        self._id_to_key[existing] = key
                        self._key_to_id[key] = existing
                    return existing, False
                if self.backend.get(self._master_key(existing)) is not None:
                    # master exists but our slave key already did: adopt it
                    with self._mu:
                        self._local[key] = (existing, 1)
                    return existing, False
                with self._mu:  # stale cache entry; retry fresh
                    if self._key_to_id.get(key) == existing:
                        del self._key_to_id[key]
                        self._id_to_key.pop(existing, None)
                continue
            with self._mu:
                cand = self._select_free_id()
            if not self.backend.create_only(self._master_key(cand),
                                            key.encode()):
                continue  # raced with another node; retry
            self.backend.create_only(self._slave_key(key),
                                     str(cand).encode(), lease=True)
            with self._mu:
                self._local[key] = (cand, 1)
                self._id_to_key[cand] = key
                self._key_to_id[key] = cand
            return cand, True
        raise AllocatorError(f"allocation of {key!r} kept racing")

    def adopt_cached(self, key: str) -> Optional[int]:
        """Degraded-mode reuse of a watch-cached binding: take a local
        ref on the ID the cluster already bound to ``key`` without the
        lock/lookup kvstore round-trips (the kvstore is down — the
        cache IS last-known-good truth).  The slave key marking our
        use is created through the backend, which journals it while
        degraded and replays it on reconnect.  Returns the adopted ID,
        or None when the cache has no binding (the caller falls back
        to a node-local ephemeral identity)."""
        with self._mu:
            held = self._local.get(key)
            if held is not None:
                id_, ref = held
                self._local[key] = (id_, ref + 1)
                return id_
            existing = self._key_to_id.get(key)
        if existing is None:
            return None
        try:
            self.backend.create_if_exists(
                self._master_key(existing), self._slave_key(key),
                str(existing).encode(), lease=True)
        except Exception:  # noqa: BLE001 — the local ref is what
            pass           # matters; the journal/reconcile repairs it
        with self._mu:
            self._local[key] = (existing, 1)
        return existing

    def release(self, key: str) -> bool:
        """Drop one local reference; on zero delete our slave key.
        Returns True when the local use count hit zero."""
        with self._mu:
            held = self._local.get(key)
            if held is None:
                return False
            id_, ref = held
            if ref > 1:
                self._local[key] = (id_, ref - 1)
                return False
            del self._local[key]
        self.backend.delete(self._slave_key(key))
        return True

    def run_gc(self) -> int:
        """Reclaim masterless IDs: a master key whose slave-key set is
        empty (all users released or their leases expired) is deleted.
        Reference: allocator.go RunGC. Returns number reclaimed."""
        reclaimed = 0
        for mkey, raw in self.backend.list_prefix(self._id_prefix()).items():
            key = raw.decode()
            if not self.backend.list_prefix(self._slave_prefix(key)):
                with self.backend.lock_path(f"{self.prefix}/locks/{key}",
                                            timeout=5.0):
                    if not self.backend.list_prefix(
                            self._slave_prefix(key)):
                        self.backend.delete(mkey)
                        reclaimed += 1
        return reclaimed

    # -- introspection -----------------------------------------------------
    def get(self, key: str) -> Optional[int]:
        with self._mu:
            return self._key_to_id.get(key)

    def get_by_id(self, id_: int) -> Optional[str]:
        with self._mu:
            return self._id_to_key.get(id_)

    def snapshot(self) -> Dict[int, str]:
        with self._mu:
            return dict(self._id_to_key)

    def close(self) -> None:
        self._watcher.stop()
        self._thread.join(timeout=1.0)
