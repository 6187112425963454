"""The IP/CIDR -> identity table with source precedence.

A whole copy of ``cilium_tpu/ipcache/ipcache.py``.

Reference: pkg/ipcache/ipcache.go — ``Upsert`` (:217) applies
source-precedence overwrite rules (:183 AllowOverwrite), listeners get
``OnIPIdentityCacheChange`` callbacks, and the datapath consumes the
result as the 512k-entry LPM map (pkg/maps/ipcache).
"""

from __future__ import annotations

import ipaddress
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# Sources ordered by precedence, low to high (reference:
# pkg/ipcache/ipcache.go:183 — a lower-precedence source may not
# overwrite a mapping installed by a higher-precedence one).
SOURCE_GENERATED = "generated"
SOURCE_K8S = "k8s"
SOURCE_CUSTOM_RESOURCE = "custom-resource"
SOURCE_KVSTORE = "kvstore"
SOURCE_AGENT_LOCAL = "agent-local"
SOURCE_LOCAL = "local"  # reserved for the node's own addresses

_PRECEDENCE = {
    SOURCE_GENERATED: 0,
    SOURCE_K8S: 1,
    SOURCE_CUSTOM_RESOURCE: 2,
    SOURCE_KVSTORE: 3,
    SOURCE_AGENT_LOCAL: 4,
    SOURCE_LOCAL: 5,
}

UPSERT = "upsert"
DELETE = "delete"


def normalize_prefix(ip_or_cidr: str) -> str:
    """'10.0.0.1' -> '10.0.0.1/32'; CIDRs pass through canonicalized."""
    if "/" in ip_or_cidr:
        net = ipaddress.ip_network(ip_or_cidr, strict=False)
        return str(net)
    addr = ipaddress.ip_address(ip_or_cidr)
    return f"{addr}/{addr.max_prefixlen}"


@dataclass(frozen=True)
class IPIdentityPair:
    """One mapping (reference: identity.IPIdentityPair serialized to the
    kvstore at cilium/state/ip/v1)."""

    prefix: str
    identity: int
    source: str
    host_ip: Optional[str] = None  # tunnel endpoint for remote entries
    metadata: str = ""


class IPCache:
    """Source-precedence IP->identity cache with change listeners."""

    def __init__(self):
        self._lock = threading.RLock()
        self._by_prefix: Dict[str, IPIdentityPair] = {}
        # identity -> set of prefixes (reference keeps the reverse map
        # for identity-based deletion)
        self._by_identity: Dict[int, set] = {}
        self._listeners: List[Callable[[str, IPIdentityPair,
                                        Optional[int]], None]] = []

    # ---------------------------------------------------------- listeners

    def add_listener(self, fn: Callable[[str, IPIdentityPair,
                                         Optional[int]], None],
                     replay: bool = True) -> None:
        """Register ``fn(mod_type, pair, old_identity)``; with
        ``replay`` the current table is replayed as upserts first
        (reference: listeners get an initial dump)."""
        with self._lock:
            self._listeners.append(fn)
            pairs = list(self._by_prefix.values()) if replay else []
        for p in pairs:
            fn(UPSERT, p, None)

    def _notify(self, mod: str, pair: IPIdentityPair,
                old_id: Optional[int]) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(mod, pair, old_id)

    # ------------------------------------------------------------- upsert

    def upsert(self, ip_or_cidr: str, identity: int, source: str,
               host_ip: Optional[str] = None, metadata: str = "") -> bool:
        """Insert/update a mapping; returns False when blocked by
        precedence (reference: ipcache.go:217 Upsert + :183
        AllowOverwrite)."""
        if source not in _PRECEDENCE:
            raise ValueError(f"unknown source {source!r}")
        prefix = normalize_prefix(ip_or_cidr)
        pair = IPIdentityPair(prefix=prefix, identity=identity,
                              source=source, host_ip=host_ip,
                              metadata=metadata)
        with self._lock:
            existing = self._by_prefix.get(prefix)
            if existing is not None and \
                    _PRECEDENCE[source] < _PRECEDENCE[existing.source]:
                return False
            if existing is not None and existing == pair:
                return True  # no-op
            self._by_prefix[prefix] = pair
            if existing is not None:
                ids = self._by_identity.get(existing.identity)
                if ids is not None:
                    ids.discard(prefix)
                    if not ids:
                        del self._by_identity[existing.identity]
            self._by_identity.setdefault(identity, set()).add(prefix)
            old_id = existing.identity if existing else None
        self._notify(UPSERT, pair, old_id)
        return True

    def delete(self, ip_or_cidr: str, source: str) -> bool:
        """Remove a mapping; lower-precedence sources cannot delete a
        higher-precedence entry."""
        prefix = normalize_prefix(ip_or_cidr)
        with self._lock:
            existing = self._by_prefix.get(prefix)
            if existing is None:
                return False
            if _PRECEDENCE[source] < _PRECEDENCE[existing.source]:
                return False
            del self._by_prefix[prefix]
            ids = self._by_identity.get(existing.identity)
            if ids is not None:
                ids.discard(prefix)
                if not ids:
                    del self._by_identity[existing.identity]
        self._notify(DELETE, existing, None)
        return True

    # ------------------------------------------------------------- lookup

    def lookup_by_ip(self, ip_or_cidr: str) -> Optional[int]:
        """Exact-prefix lookup (LPM semantics live in the datapath
        tables; reference: LookupByIP)."""
        with self._lock:
            pair = self._by_prefix.get(normalize_prefix(ip_or_cidr))
            return pair.identity if pair else None

    def lookup_longest_prefix(self, ip: str) -> Optional[int]:
        """Host-side LPM match over the cache (used by trace/debug
        surfaces; the hot path uses the compiled device LPM)."""
        addr = ipaddress.ip_address(ip)
        with self._lock:
            best, best_len = None, -1
            for prefix, pair in self._by_prefix.items():
                net = ipaddress.ip_network(prefix)
                if addr.version == net.version and addr in net and \
                        net.prefixlen > best_len:
                    best, best_len = pair.identity, net.prefixlen
            return best

    def lookup_by_identity(self, identity: int) -> List[str]:
        with self._lock:
            return sorted(self._by_identity.get(identity, ()))

    def dump(self) -> List[IPIdentityPair]:
        with self._lock:
            return sorted(self._by_prefix.values(),
                          key=lambda p: p.prefix)

    def to_lpm_prefixes(self, family: int = 4) -> Dict[str, int]:
        """{prefix: identity} for compiler.lpm.compile_lpm /
        compile_lpm6 — the bridge into the datapath ipcache LPM
        tensors, one per address family."""
        return self.to_lpm_prefix_families()[0 if family == 4 else 1]

    def to_lpm_prefix_families(self
                               ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """One pass over the cache: ({v4 prefix: id}, {v6 prefix: id}).
        Family is decided by the prefix string (normalized at upsert),
        so no CIDR parsing here."""
        with self._lock:
            v4: Dict[str, int] = {}
            v6: Dict[str, int] = {}
            for p in self._by_prefix.values():
                (v6 if ":" in p.prefix else v4)[p.prefix] = p.identity
            return v4, v6

    def __len__(self):
        with self._lock:
            return len(self._by_prefix)
