"""Two-choice bucketed hash tables: the at-scale policy-map layout.

Copy of ``cilium_tpu/compiler/bucket_tables.py`` (host numpy).  Every key
has exactly two candidate buckets of W contiguous slots each, so a
batched lookup is 2 row-gathers + 2W lane compares per stage, whatever
the endpoint count, rule count and load.  Insertion places each key in
the emptier of its two buckets; an overflow raises inside the builder
and the bucket count doubles.

Layout: [E * NB, W] int32 arrays (key word A, key word B, value), where
NB = buckets per endpoint (a power of two).  key_b == 0 marks empty
slots, as in ``compiler/hashtab.py``.  The device lookup is
``ops/bucket_ops.py``, in lockstep with the hashes here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .hashtab import _next_pow2, hash_mix
from .policy_tables import pack_key

BUCKET_WIDTH = 8


def second_hash(ka: np.ndarray, kb: np.ndarray) -> np.ndarray:
    """Second bucket choice: the same mixer with the words swapped and
    a salt.  Must stay in lockstep with ``ops.bucket_ops.second_hash``."""
    return hash_mix(kb ^ np.uint32(0xA5A5A5A5), ka)


def bucket_pair(ka: np.ndarray, kb: np.ndarray,
                nb_mask: np.uint32) -> Tuple[np.ndarray, np.ndarray]:
    """Both candidate buckets for each key; b2 is nudged off b1 so the
    two choices are always distinct."""
    b1 = hash_mix(ka, kb) & nb_mask
    b2 = second_hash(ka, kb) & nb_mask
    b2 = np.where(b2 == b1, (b1 + np.uint32(1)) & nb_mask, b2)
    return b1.astype(np.int64), b2.astype(np.int64)


@dataclass
class BucketTables:
    """Stacked two-choice tables for E endpoints.

    key_a/key_b/value: [E * NB, W] int32 (int32 views of uint32 words).
    """

    key_a: np.ndarray
    key_b: np.ndarray
    value: np.ndarray
    num_endpoints: int
    buckets_per_ep: int
    width: int
    revision: int = 0

    def nbytes(self) -> int:
        return self.key_a.nbytes + self.key_b.nbytes + self.value.nbytes

    def entry_count(self) -> int:
        return int((self.key_b != 0).sum())

    @property
    def slots_per_ep(self) -> int:
        return self.buckets_per_ep * self.width


class BucketOverflow(RuntimeError):
    pass


def build_bucket_tables(ep: np.ndarray, key_a: np.ndarray,
                        key_b: np.ndarray, value: np.ndarray,
                        num_endpoints: int,
                        buckets_per_ep: Optional[int] = None,
                        width: int = BUCKET_WIDTH,
                        max_load: float = 0.5,
                        revision: int = 0) -> BucketTables:
    """Vectorized build from flat entry arrays.

    ep: [N] endpoint index per entry; key_a/key_b: [N] uint32 key words
    (key_b must be non-zero); value: [N] int32.  Keys must be unique per
    endpoint: the lookup's masked-sum select would add the payloads of
    duplicates, so they raise here.  Retries with doubled buckets on a
    two-choice overflow.
    """
    ep = np.asarray(ep, np.int64)
    ka = np.asarray(key_a).astype(np.uint32)
    kb = np.asarray(key_b).astype(np.uint32)
    val = np.asarray(value, np.int32)
    if (kb == 0).any():
        raise ValueError("key_b == 0 is reserved for empty slots")
    n = len(ep)
    # one lexsort serves the duplicate check and deterministic placement
    order = np.lexsort((kb, ka, ep)) if n else np.empty(0, np.int64)
    if n:
        se, sa, sb = ep[order], ka[order], kb[order]
        dup = ((se[1:] == se[:-1]) & (sa[1:] == sa[:-1]) &
               (sb[1:] == sb[:-1]))
        if dup.any():
            raise ValueError(
                f"{int(dup.sum())} duplicate (endpoint, key) entries")
    if buckets_per_ep is None:
        per_ep_max = int(np.bincount(
            ep, minlength=num_endpoints).max()) if n else 0
        buckets_per_ep = _next_pow2(
            max(1, int(per_ep_max / (width * max_load)) + 1))
    # nb == 1 would put both choices on one row, and the masked-sum
    # select would count a hit twice
    buckets_per_ep = max(2, buckets_per_ep)
    while True:
        try:
            return _build_once(ep, ka, kb, val, num_endpoints,
                               buckets_per_ep, width, revision, order)
        except BucketOverflow:
            buckets_per_ep *= 2


def _build_once(ep, ka, kb, val, num_endpoints, nb, width,
                revision, order) -> BucketTables:
    nb_mask = np.uint32(nb - 1)
    n = len(ep)
    rows = num_endpoints * nb
    t_a = np.zeros((rows, width), np.uint32)
    t_b = np.zeros((rows, width), np.uint32)
    t_v = np.zeros((rows, width), np.int32)
    if n == 0:
        return BucketTables(key_a=t_a.view(np.int32),
                            key_b=t_b.view(np.int32), value=t_v,
                            num_endpoints=num_endpoints,
                            buckets_per_ep=nb, width=width,
                            revision=revision)
    b1, b2 = bucket_pair(ka, kb, nb_mask)
    r1 = ep * nb + b1
    r2 = ep * nb + b2
    # deterministic placement: entries go in sorted key order
    fill = np.zeros(rows, np.int64)
    pending = order.copy()
    while pending.size:
        f1 = fill[r1[pending]]
        f2 = fill[r2[pending]]
        tgt = np.where(f2 < f1, r2[pending], r1[pending])
        tfill = np.minimum(f1, f2)
        space = tfill < width
        if not space.any():
            raise BucketOverflow(
                f"both buckets full for {(~space).sum()} keys "
                f"(nb={nb}, width={width})")
        cand = pending[space]
        ctgt = tgt[space]
        # rank of each candidate within its target bucket this round
        sort_i = np.argsort(ctgt, kind="stable")
        st = ctgt[sort_i]
        group_start = np.r_[0, np.flatnonzero(st[1:] != st[:-1]) + 1]
        starts = np.zeros(len(st), np.int64)
        starts[group_start] = group_start
        np.maximum.accumulate(starts, out=starts)
        rank = np.arange(len(st)) - starts
        # at most 2 entries a bucket a round: with every fill at zero in
        # round one, unbounded intake would send all entries to their
        # first choice (single-choice hashing)
        cap = np.minimum(width - fill[st], 2)
        take = rank < cap
        winners = cand[sort_i][take]
        wrow = st[take]
        wslot = (fill[st] + rank)[take]
        t_a[wrow, wslot] = ka[winners]
        t_b[wrow, wslot] = kb[winners]
        t_v[wrow, wslot] = val[winners]
        fill += np.bincount(wrow, minlength=rows)
        placed = np.zeros(n, bool)
        placed[winners] = True
        pending = pending[~placed[pending]]
    return BucketTables(key_a=t_a.view(np.int32), key_b=t_b.view(np.int32),
                        value=t_v, num_endpoints=num_endpoints,
                        buckets_per_ep=nb, width=width, revision=revision)


def compile_states_bucketed(map_states, revision: int = 0,
                            **kw) -> BucketTables:
    """PolicyMapStates -> BucketTables (small scale; big callers build
    the flat arrays directly)."""
    eps, kas, kbs, vals = [], [], [], []
    for i, st in enumerate(map_states):
        for k, v in st.items():
            a, b = pack_key(k)
            eps.append(i)
            kas.append(a)
            kbs.append(b)
            vals.append(v.proxy_port)
    return build_bucket_tables(
        np.array(eps, np.int64), np.array(kas, np.uint32),
        np.array(kbs, np.uint32), np.array(vals, np.int32),
        num_endpoints=len(map_states), revision=revision, **kw)
