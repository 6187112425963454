"""CIDR -> local security identities for policy prefixes.

A whole copy of ``cilium_tpu/ipcache/cidr.py``.

Reference: pkg/ipcache/cidr.go — when a policy references CIDRs, each
prefix gets an identity allocated from its cidr: label so the datapath
can classify world traffic per-prefix; the mapping is upserted into the
ipcache with source=generated and released when the policy goes away.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from ..identity import Identity
from ..labels import Labels, get_cidr_labels
from .ipcache import SOURCE_GENERATED, IPCache, normalize_prefix


def allocate_cidr_identities(allocator, cache: IPCache,
                             prefixes: Iterable[str]
                             ) -> Dict[str, Identity]:
    """Allocate (or ref) an identity per prefix and upsert the mapping.

    Reference: cidr.go AllocateCIDRs → ipcache upserts. Works with any
    allocator exposing ``allocate(labels)``.
    """
    out: Dict[str, Identity] = {}
    for raw in prefixes:
        prefix = normalize_prefix(raw)
        labels = Labels.from_labels(get_cidr_labels(prefix))
        ident, _ = allocator.allocate(labels)
        cache.upsert(prefix, ident.id, SOURCE_GENERATED,
                     metadata="cidr-policy")
        out[prefix] = ident
    return out


def release_cidr_identities(allocator, cache: IPCache,
                            identities: Dict[str, Identity]) -> int:
    """Release refs taken by allocate_cidr_identities; prefixes whose
    identity is freed are removed from the cache. Returns freed count."""
    freed = 0
    for prefix, ident in identities.items():
        if allocator.release(ident):
            cache.delete(prefix, SOURCE_GENERATED)
            freed += 1
    return freed
