"""Keyed tables as columns of tensors: matching keys by sorting, and the
comparison of two such tables entry by entry.

A table is a dict of [M] int64 columns.  Its key is two int64 words per
entry (``words``), made from the key's fields without loss, so two
entries have equal keys exactly when their words are equal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .hashing import u32

Table = Dict[str, torch.Tensor]


def pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two 32-bit values (any sign) as one int64 word, without loss."""
    return (u32(hi) - (1 << 31)) * (1 << 32) + u32(lo)


def group_ids(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n] int64: one number per distinct (a, b) pair, the same for equal
    pairs, each below n."""
    n = a.shape[0]
    order = torch.argsort(b, stable=True)
    order = order[torch.argsort(a[order], stable=True)]
    sa, sb = a[order], b[order]
    first = torch.ones(n, dtype=torch.bool, device=a.device)
    first[1:] = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])
    ids = torch.empty(n, dtype=torch.int64, device=a.device)
    ids[order] = torch.cumsum(first.to(torch.int64), 0) - 1
    return ids


def owners(ids: torch.Tensor, n_entries: int) -> torch.Tensor:
    """[len(ids)] int64: for each id, the entry (one of the first
    ``n_entries`` positions) that holds it, -1 where none does."""
    own = torch.full((ids.shape[0],), -1, dtype=torch.int64,
                     device=ids.device)
    own[ids[:n_entries]] = torch.arange(n_entries, device=ids.device)
    return own


def select(table: Table, keep: torch.Tensor) -> Table:
    return {k: v[keep] for k, v in table.items()}


def concat(a: Table, b: Table) -> Table:
    return {k: torch.cat([a[k], b[k].to(a[k].device)]) for k in a}


def mismatched(words_a: Tuple[torch.Tensor, torch.Tensor],
               values_a: torch.Tensor,
               words_b: Tuple[torch.Tensor, torch.Tensor],
               values_b: torch.Tensor) -> int:
    """Entries of two keyed tables that do not agree: keys held by one
    side only, keys held twice on one side, and keys whose [M, v] values
    differ."""
    dev = values_a.device
    ma, mb = values_a.shape[0], values_b.shape[0]
    ids = group_ids(torch.cat([words_a[0], words_b[0].to(dev)]),
                    torch.cat([words_a[1], words_b[1].to(dev)]))
    n = ma + mb
    ia = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ib = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ia[ids[:ma]] = torch.arange(ma, device=dev)
    ib[ids[ma:]] = torch.arange(mb, device=dev)
    has_a, has_b = ia >= 0, ib >= 0
    twice = (ma - int(has_a.sum())) + (mb - int(has_b.sum()))
    only = int((has_a ^ has_b).sum()) + twice
    if ma == 0 or mb == 0:
        return only
    differ = has_a & has_b & (values_a[ia.clamp(min=0)] !=
                              values_b.to(dev)[ib.clamp(min=0)]).any(dim=1)
    return only + int(differ.sum())


def stack(table: Table, names: Sequence[str]) -> torch.Tensor:
    return torch.stack([table[k] for k in names], dim=1)
