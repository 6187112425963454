"""Security identities: numeric IDs, reserved ranges, the identity cache.

A whole copy of ``cilium_tpu/identity.py``.

Semantics follow the reference's ``pkg/identity`` (numericidentity.go,
identity.go, allocator.go): a security identity is a ``uint32`` derived from
a set of security-relevant labels; IDs < 256 are reserved, dynamic IDs live
in [256, 65535] with cluster bits shifted above bit 16.

Distributed allocation (the kvstore master/slave-key protocol) lives in
the kvstore allocator, not part of the port; this module is the pure model plus a
local in-process allocator used by tests and single-node operation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import labels as lbl
from .labels import Label, LabelArray, Labels

# Reference: pkg/identity/numericidentity.go:27-39
MINIMAL_NUMERIC_IDENTITY = 256
USER_RESERVED_NUMERIC_IDENTITY = 128
INVALID_IDENTITY = 0

# Reference: pkg/identity/allocator.go:79-80 — dynamic ID space.
MAX_NUMERIC_IDENTITY = 65535

# Cluster ID is encoded above bit 16 (reference: identity/allocator.go:93).
CLUSTER_ID_SHIFT = 16

# Node-local ephemeral identity scope (reference: identity.
# IdentityScopeLocal — CIDR identities carry bit 24).  Identities
# allocated here never leave the node: the kvstore-outage fallback
# allocates endpoint identities from this range while the cluster
# allocator is unreachable, and they are promoted to cluster-scope IDs
# on reconnect (kvstore/identity_allocator.FallbackIdentityAllocator).
LOCAL_SCOPE_IDENTITY_BASE = 1 << 24


def is_local_scope_identity(numeric_id: int) -> bool:
    """True for node-local ephemeral identities (never published to
    the cluster; promoted to cluster scope on kvstore reconnect)."""
    return numeric_id >= LOCAL_SCOPE_IDENTITY_BASE

# Reserved numeric identities (reference: numericidentity.go:42-104).
IDENTITY_UNKNOWN = 0
RESERVED_HOST = 1
RESERVED_WORLD = 2
RESERVED_UNMANAGED = 3
RESERVED_HEALTH = 4
RESERVED_INIT = 5

# Well-known cluster components (reference: numericidentity.go:63-78).
RESERVED_ETCD_OPERATOR = 100
RESERVED_CILIUM_KVSTORE = 101
RESERVED_KUBE_DNS = 102
RESERVED_EKS_KUBE_DNS = 103
RESERVED_CORE_DNS = 104

RESERVED_IDENTITY_NAMES: Dict[int, str] = {
    IDENTITY_UNKNOWN: lbl.ID_NAME_UNKNOWN,
    RESERVED_HOST: lbl.ID_NAME_HOST,
    RESERVED_WORLD: lbl.ID_NAME_WORLD,
    RESERVED_UNMANAGED: lbl.ID_NAME_UNMANAGED,
    RESERVED_HEALTH: lbl.ID_NAME_HEALTH,
    RESERVED_INIT: lbl.ID_NAME_INIT,
}

RESERVED_IDENTITIES: Dict[str, int] = {
    v: k for k, v in RESERVED_IDENTITY_NAMES.items() if k != IDENTITY_UNKNOWN
}


def get_reserved_id(name: str) -> int:
    """Name -> reserved numeric identity (0 == unknown)."""
    return RESERVED_IDENTITIES.get(name, IDENTITY_UNKNOWN)


def is_reserved_identity(numeric_id: int) -> bool:
    """IDs below the unmanaged boundary are reserved infrastructure IDs
    (reference: bpf/lib/policy.h identity_is_reserved uses < UNMANAGED_ID;
    the full reserved block is < MinimalNumericIdentity)."""
    return 0 < numeric_id < MINIMAL_NUMERIC_IDENTITY


@dataclass(frozen=True)
class Identity:
    """A security identity: numeric ID + the labels it stands for.

    Reference: pkg/identity/identity.go:27.
    """

    id: int
    labels: Labels

    @property
    def label_array(self) -> LabelArray:
        return self.labels.to_array()

    @property
    def labels_sha256(self) -> str:
        return self.labels.sha256_sum()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, Identity) and self.id == other.id


def _reserved_identity_cache() -> Dict[int, Identity]:
    cache: Dict[int, Identity] = {}
    for num, name in RESERVED_IDENTITY_NAMES.items():
        if num == IDENTITY_UNKNOWN:
            continue
        labels = Labels.from_labels([lbl.reserved_label(name)])
        cache[num] = Identity(id=num, labels=labels)
    return cache


RESERVED_IDENTITY_CACHE = _reserved_identity_cache()


def look_up_reserved_identity(numeric_id: int) -> Optional[Identity]:
    return RESERVED_IDENTITY_CACHE.get(numeric_id)


def look_up_reserved_identity_by_labels(labels: Labels) -> Optional[Identity]:
    """Single reserved label -> reserved identity (reference:
    identity/identity.go LookupReservedIdentity path)."""
    if len(labels) != 1:
        return None
    (only,) = labels.values()
    if only.source != lbl.SOURCE_RESERVED:
        return None
    rid = get_reserved_id(only.key)
    if rid == IDENTITY_UNKNOWN:
        return None
    return RESERVED_IDENTITY_CACHE[rid]


class IdentityCache(Dict[int, LabelArray]):
    """Snapshot map numeric-ID -> LabelArray used during policy resolution.

    Reference: pkg/identity/cache.go (GetIdentityCache) — policy
    recomputation iterates this cache to materialize per-identity verdicts.
    """

    @classmethod
    def snapshot(cls, allocator) -> "IdentityCache":
        """Works with any allocator exposing ``snapshot_identities()``."""
        cache = cls()
        for num, ident in RESERVED_IDENTITY_CACHE.items():
            cache[num] = ident.label_array
        for ident in allocator.snapshot_identities():
            cache[ident.id] = ident.label_array
        return cache


class LocalIdentityAllocator:
    """In-process identity allocator with refcounting.

    Mirrors the allocation contract of the reference's kvstore-backed
    allocator (pkg/identity/allocator.go:124 AllocateIdentity /
    :161 Release) without the distribution: same labels -> same ID,
    refcounted release, IDs from [256, 65535], cluster bits shifted in.
    A kvstore-backed distributed allocator would plug in behind the same interface.
    """

    def __init__(self, cluster_id: int = 0,
                 on_change: Optional[Callable[[str, Identity], None]] = None):
        self.cluster_id = cluster_id
        self._lock = threading.RLock()
        self._by_sha: Dict[str, Identity] = {}
        self._by_id: Dict[int, Identity] = {}
        self._refcount: Dict[int, int] = {}
        self._next = MINIMAL_NUMERIC_IDENTITY
        self._on_change = on_change  # ("add"|"delete", identity)

    def _pick_free_id(self) -> int:
        """Returns a full numeric ID (cluster bits included) not in use."""
        start = self._next
        while True:
            cand = self._next
            self._next += 1
            if self._next > MAX_NUMERIC_IDENTITY:
                self._next = MINIMAL_NUMERIC_IDENTITY
            numeric = (self.cluster_id << CLUSTER_ID_SHIFT) | cand
            if numeric not in self._by_id:
                return numeric
            if self._next == start:
                raise RuntimeError("identity space exhausted")

    def allocate(self, labels: Labels) -> Tuple[Identity, bool]:
        """Return (identity, is_new). Reserved labels short-circuit."""
        reserved = look_up_reserved_identity_by_labels(labels)
        if reserved is not None:
            return reserved, False
        sha = labels.sha256_sum()
        with self._lock:
            existing = self._by_sha.get(sha)
            if existing is not None:
                self._refcount[existing.id] += 1
                return existing, False
            numeric = self._pick_free_id()
            ident = Identity(id=numeric, labels=Labels(labels))
            self._by_sha[sha] = ident
            self._by_id[numeric] = ident
            self._refcount[numeric] = 1
        if self._on_change:
            self._on_change("add", ident)
        return ident, True

    def release(self, ident: Identity) -> bool:
        """Decrement refcount; free on zero. Returns True if freed."""
        if is_reserved_identity(ident.id):
            return False
        freed = False
        with self._lock:
            if ident.id not in self._refcount:
                return False
            self._refcount[ident.id] -= 1
            if self._refcount[ident.id] <= 0:
                del self._refcount[ident.id]
                del self._by_id[ident.id]
                self._by_sha.pop(ident.labels.sha256_sum(), None)
                freed = True
        if freed and self._on_change:
            self._on_change("delete", ident)
        return freed

    def snapshot_identities(self) -> List[Identity]:
        """Point-in-time list of live dynamic identities (the allocator
        interface consumed by IdentityCache.snapshot)."""
        with self._lock:
            return list(self._by_id.values())

    def lookup_by_id(self, numeric_id: int) -> Optional[Identity]:
        reserved = look_up_reserved_identity(numeric_id)
        if reserved is not None:
            return reserved
        with self._lock:
            return self._by_id.get(numeric_id)

    def lookup_by_labels(self, labels: Labels) -> Optional[Identity]:
        reserved = look_up_reserved_identity_by_labels(labels)
        if reserved is not None:
            return reserved
        with self._lock:
            return self._by_sha.get(labels.sha256_sum())

    def __len__(self):
        with self._lock:
            return len(self._by_id)
