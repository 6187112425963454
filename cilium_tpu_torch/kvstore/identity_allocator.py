"""Kvstore-backed (distributed) security-identity allocator.

A whole copy of ``cilium_tpu/kvstore/identity_allocator.py``.

Binds the generic master/slave-key allocator to the identity model:
same labels -> same numeric ID on every node of the cluster, refcounted
via per-node lease-protected slave keys, reclaimed by GC.

Reference: pkg/identity/allocator.go:73 (InitIdentityAllocator),
:124 (AllocateIdentity), :161 (Release); kvstore path
``cilium/state/identities/v1`` (allocator.go:57); cluster-ID bits shifted
above bit 16 (allocator.go:93).
"""

from __future__ import annotations

import base64
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..identity import (CLUSTER_ID_SHIFT, LOCAL_SCOPE_IDENTITY_BASE,
                        MAX_NUMERIC_IDENTITY, MINIMAL_NUMERIC_IDENTITY,
                        Identity, is_local_scope_identity,
                        is_reserved_identity, look_up_reserved_identity,
                        look_up_reserved_identity_by_labels)
from ..labels import Labels, parse_label
from .allocator import Allocator
from .backend import BackendOperations

IDENTITY_PREFIX = "cilium/state/identities/v1"


def encode_labels(labels: Labels) -> str:
    """Labels -> allocator key. Base64url keeps '/' (CIDR labels) out of
    the kvstore path structure."""
    return base64.urlsafe_b64encode(labels.sorted_list()).decode()


def decode_labels(key: str) -> Labels:
    raw = base64.urlsafe_b64decode(key.encode()).decode()
    return Labels.from_labels(
        parse_label(part) for part in raw.split(";") if part)


class DistributedIdentityAllocator:
    """Drop-in for LocalIdentityAllocator backed by the shared kvstore."""

    def __init__(self, backend: BackendOperations, node: str,
                 cluster_id: int = 0,
                 on_change: Optional[Callable[[str, Identity], None]] = None,
                 prefix: str = IDENTITY_PREFIX,
                 seed: Optional[int] = None):
        self.cluster_id = cluster_id
        self._on_change = on_change
        self._alloc = Allocator(backend, prefix, node,
                                MINIMAL_NUMERIC_IDENTITY,
                                MAX_NUMERIC_IDENTITY,
                                on_event=self._event, seed=seed)

    def _numeric(self, local_id: int) -> int:
        return (self.cluster_id << CLUSTER_ID_SHIFT) | local_id

    def _event(self, typ: str, local_id: int, key: str) -> None:
        if self._on_change is None:
            return
        try:
            labels = decode_labels(key)
        except ValueError:
            return
        self._on_change("add" if typ in ("add", "modify") else "delete",
                        Identity(id=self._numeric(local_id), labels=labels))

    # -- LocalIdentityAllocator-compatible interface -----------------------
    def allocate(self, labels: Labels) -> Tuple[Identity, bool]:
        reserved = look_up_reserved_identity_by_labels(labels)
        if reserved is not None:
            return reserved, False
        local_id, is_new = self._alloc.allocate(encode_labels(labels))
        return Identity(id=self._numeric(local_id),
                        labels=Labels(labels)), is_new

    def release(self, ident: Identity) -> bool:
        if is_reserved_identity(ident.id):
            return False
        return self._alloc.release(encode_labels(ident.labels))

    def snapshot_identities(self) -> List[Identity]:
        out = []
        for local_id, key in self._alloc.snapshot().items():
            try:
                labels = decode_labels(key)
            except ValueError:
                continue
            out.append(Identity(id=self._numeric(local_id), labels=labels))
        return out

    def lookup_by_id(self, numeric_id: int) -> Optional[Identity]:
        reserved = look_up_reserved_identity(numeric_id)
        if reserved is not None:
            return reserved
        local_id = numeric_id & ((1 << CLUSTER_ID_SHIFT) - 1)
        key = self._alloc.get_by_id(local_id)
        if key is None:
            return None
        return Identity(id=numeric_id, labels=decode_labels(key))

    def lookup_by_labels(self, labels: Labels) -> Optional[Identity]:
        reserved = look_up_reserved_identity_by_labels(labels)
        if reserved is not None:
            return reserved
        local_id = self._alloc.get(encode_labels(labels))
        if local_id is None:
            return None
        return Identity(id=self._numeric(local_id), labels=Labels(labels))

    def adopt_cached(self, labels: Labels) -> Optional[Identity]:
        """Degraded-mode reuse: if the watch cache already binds these
        labels to a cluster ID, adopt it (local ref + journaled slave
        key) without any kvstore round-trip.  None on a cache miss."""
        local_id = self._alloc.adopt_cached(encode_labels(labels))
        if local_id is None:
            return None
        return Identity(id=self._numeric(local_id),
                        labels=Labels(labels))

    def run_gc(self) -> int:
        return self._alloc.run_gc()

    def close(self) -> None:
        self._alloc.close()

    def __len__(self):
        return len(self._alloc.snapshot())


class FallbackIdentityAllocator:
    """Outage-surviving shell around the distributed allocator.

    While the kvstore is healthy every call delegates.  When the
    cluster allocator is unreachable (the outage guard is degraded, or
    an op fails outage-class), ``allocate`` degrades in two steps that
    mirror the reference's local-scope (CIDR) identity semantics:

    1. labels the cluster already bound (visible in the watch cache)
       are **adopted** — same numeric ID as every other node, with the
       slave key journaled for reconnect replay;
    2. genuinely new label sets get a node-local ephemeral identity
       from ``LOCAL_SCOPE_IDENTITY_BASE`` (bit 24 — disjoint from
       every cluster-scope ID), refcounted like any other identity and
       never published.

    On reconnect the daemon promotes local identities to cluster scope
    through the normal allocate path and re-keys only the endpoints
    that actually hold them (kvstore/outage.py is the detector;
    daemon._promote_local_identities is the driver).
    """

    # errors that mean "the control plane is unreachable", not "the
    # caller did something wrong": kvstore transport errors, lock
    # timeouts, the guard's fail-fast degraded error, allocator races
    # that exhausted their kvstore attempts
    OUTAGE_ERRORS = (RuntimeError, OSError)

    def __init__(self, distributed: DistributedIdentityAllocator,
                 guard=None,
                 on_change: Optional[Callable[[str, Identity],
                                              None]] = None):
        self._dist = distributed
        self._guard = guard  # kvstore.outage.OutageGuard (mode oracle)
        self._on_change = on_change
        self._mu = threading.RLock()
        # sha -> [Identity, refcount]
        self._by_sha: Dict[str, list] = {}
        self._by_id: Dict[int, Identity] = {}
        self._next = 0
        self.fallback_allocations = 0
        self.adoptions = 0
        self.promotions = 0

    @property
    def cluster_id(self) -> int:
        return self._dist.cluster_id

    def _degraded(self) -> bool:
        return self._guard is not None and self._guard.mode != "ok"

    # ------------------------------------------------------- allocate

    def allocate(self, labels: Labels) -> Tuple[Identity, bool]:
        reserved = look_up_reserved_identity_by_labels(labels)
        if reserved is not None:
            return reserved, False
        if self._degraded():
            return self._allocate_degraded(labels)
        try:
            return self._dist.allocate(labels)
        except self.OUTAGE_ERRORS:
            if self._guard is None:
                raise
            return self._allocate_degraded(labels)

    def _allocate_degraded(self, labels: Labels) -> Tuple[Identity, bool]:
        # step 1: adopt the cluster's cached binding when one exists
        try:
            adopted = self._dist.adopt_cached(labels)
        except self.OUTAGE_ERRORS:
            adopted = None
        if adopted is not None:
            self.adoptions += 1
            return adopted, False
        # step 2: node-local ephemeral identity
        sha = labels.sha256_sum()
        with self._mu:
            held = self._by_sha.get(sha)
            if held is not None:
                held[1] += 1
                return held[0], False
            self._next += 1
            ident = Identity(id=LOCAL_SCOPE_IDENTITY_BASE + self._next,
                             labels=Labels(labels))
            self._by_sha[sha] = [ident, 1]
            self._by_id[ident.id] = ident
            self.fallback_allocations += 1
        if self._on_change:
            self._on_change("add", ident)
        return ident, True

    def release(self, ident: Identity) -> bool:
        if is_reserved_identity(ident.id):
            return False
        if is_local_scope_identity(ident.id):
            freed = False
            with self._mu:
                held = self._by_sha.get(ident.labels.sha256_sum())
                if held is None or held[0].id != ident.id:
                    return False
                held[1] -= 1
                if held[1] <= 0:
                    del self._by_sha[ident.labels.sha256_sum()]
                    del self._by_id[ident.id]
                    freed = True
            if freed and self._on_change:
                self._on_change("delete", ident)
            return freed
        # cluster-scope: the slave-key delete goes through the guarded
        # backend, which journals it while degraded
        return self._dist.release(ident)

    # ------------------------------------------------------ promotion

    def local_count(self) -> int:
        with self._mu:
            return len(self._by_id)

    def local_identities(self) -> List[Identity]:
        with self._mu:
            return list(self._by_id.values())

    # ------------------------------------------------------- lookups

    def lookup_by_id(self, numeric_id: int) -> Optional[Identity]:
        if is_local_scope_identity(numeric_id):
            with self._mu:
                return self._by_id.get(numeric_id)
        return self._dist.lookup_by_id(numeric_id)

    def lookup_by_labels(self, labels: Labels) -> Optional[Identity]:
        ident = self._dist.lookup_by_labels(labels)
        if ident is not None:
            return ident
        with self._mu:
            held = self._by_sha.get(labels.sha256_sum())
            return held[0] if held is not None else None

    def snapshot_identities(self) -> List[Identity]:
        out = self._dist.snapshot_identities()
        with self._mu:
            out.extend(self._by_id.values())
        return out

    def run_gc(self) -> int:
        return self._dist.run_gc()

    def close(self) -> None:
        self._dist.close()

    def __len__(self):
        with self._mu:
            local = len(self._by_id)
        return len(self._dist) + local
