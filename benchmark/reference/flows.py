"""The Hubble flow table as a map from a flow's key to its counters,
stated entry by entry.

A key is (source identity, destination identity, destination port,
protocol, event); an entry holds packets and bytes (uint32, wrapping)
and the time it was last seen.  The table also counts every row it was
offered (``updates``) and every row it could not track (``lost``).  One
batch of rows at time ``now``:

1. A row whose key has an entry (as the table stood before the batch)
   is tracked by it.
2. On a claiming step (``claim_budget`` > 0), the first
   ``claim_budget`` rows, in row order, whose key has no entry and whose
   window still has a free place claim one.  The table has ``slots``
   places, a key may sit only in the ``max_probe`` places from
   ``hash_mix(hash_mix(src, dst), meta)`` onward (``meta`` the packed
   port, protocol and biased event word), and an entry never leaves
   its place.  Each claiming key picks the first free place of its
   window; where keys pick one place, the key whose last claiming row
   comes later takes it (last seen ``now``, counters 0) and the others
   try once more against the places then held.  Every claiming row of
   a key that took a place is tracked by its entry.
3. Every tracked row adds one packet and its length to its entry.
4. Last seen: of the batch's ``STRIPE`` equal blocks of rows (one block
   of all rows where the batch does not split evenly), the rows of block
   ``now mod STRIPE`` that are tracked set their entry's last seen to
   ``now``.
5. ``updates`` grows by the batch's rows, ``lost`` by its untracked
   rows.
"""

from __future__ import annotations

import torch

from . import keys as K
from .conntrack import place
from .hashing import hash_mix, i32

EVENT_BIAS = 200
# blocks of rows whose last-seen refresh rotates, one block a batch
STRIPE = 4
KEY = ("src", "dst", "meta")
VALUES = ("packets", "bytes", "last_seen")
COLUMNS = KEY + VALUES + ("place",)


def pack_meta(dport, proto, event) -> torch.Tensor:
    """The key's port, protocol and event as one word (int64 of its
    uint32 bits); the event byte is biased so that it is never 0."""
    return ((dport.to(torch.int64) & 0xFFFF) << 16) | \
        ((proto.to(torch.int64) & 0xFF) << 8) | \
        ((event.to(torch.int64) + EVENT_BIAS) & 0xFF)


def table_words(t: K.Table):
    return K.pair(t["src"], t["dst"]), t["meta"]


class FlowTable:
    def __init__(self, slots: int, max_probe: int, device="cpu"):
        self.slots, self.max_probe, self.device = slots, max_probe, device
        self.t = {k: torch.zeros(0, dtype=torch.int64, device=device)
                  for k in COLUMNS}
        self.lost = torch.zeros((), dtype=torch.int64, device=device)
        self.updates = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, table: K.Table) -> None:
        self.t = {k: table[k].to(self.device, torch.int64).clone()
                  for k in COLUMNS}
        self.lost = table["lost"].to(self.device, torch.int64).clone()
        self.updates = table["updates"].to(self.device,
                                           torch.int64).clone()

    def entries(self) -> K.Table:
        out = {k: v.clone() for k, v in self.t.items()}
        out["lost"], out["updates"] = self.lost.clone(), self.updates.clone()
        return out

    def step(self, src, dst, dport, proto, event, length, now: int,
             claim_budget: int) -> None:
        t = self.t
        m, b = t["meta"].shape[0], src.shape[0]
        dev = src.device
        src64, dst64 = src.to(torch.int64), dst.to(torch.int64)
        meta = pack_meta(dport, proto, event)
        have = table_words(t)
        ids = K.group_ids(torch.cat([have[0], K.pair(src64, dst64)]),
                          torch.cat([have[1], meta]))
        own = K.owners(ids, m)
        entry = own[ids[m:]]
        found = entry >= 0
        rows = torch.arange(b, device=dev)

        if claim_budget > 0:
            held = torch.zeros(self.slots, dtype=torch.bool, device=dev)
            held[t["place"]] = True
            starts = hash_mix(hash_mix(i32(src64), i32(dst64)),
                              i32(meta)).to(torch.int64) & \
                (self.slots - 1)
            win = (starts[:, None] + torch.arange(
                self.max_probe, device=dev)[None, :]) & (self.slots - 1)
            may = ~found & (~held[win]).any(dim=1)
            rank = torch.cumsum(may.to(torch.int64), 0) - 1
            claim = rows[may & (rank < claim_budget)]
            key_id = ids[m:]
            last = torch.full((m + b,), -1, dtype=torch.int64, device=dev)
            last.scatter_reduce_(0, key_id[claim], claim, "amax")
            prop = last[last >= 0]               # each key's last claim
            at = place(starts[prop], prop, held, self.max_probe)
            won = prop[at >= 0]
            new_idx = torch.full((m + b,), -1, dtype=torch.int64,
                                 device=dev)
            new_idx[key_id[won]] = m + torch.arange(won.shape[0],
                                                    device=dev)
            took = torch.zeros(b, dtype=torch.bool, device=dev)
            took[claim] = new_idx[key_id[claim]] >= 0
            entry = torch.where(took, new_idx[key_id], entry)
            found = found | took
            t = K.concat(t, {
                "src": src64[won], "dst": dst64[won], "meta": meta[won],
                "packets": torch.zeros_like(won),
                "bytes": torch.zeros_like(won),
                "last_seen": torch.full_like(won, now),
                "place": at[at >= 0]})

        n = t["meta"].shape[0]
        tracked = found
        e = entry[tracked]
        ones = torch.ones_like(e)
        t["packets"] = (t["packets"].index_add(0, e, ones)) & 0xFFFFFFFF
        t["bytes"] = (t["bytes"].index_add(
            0, e, length[tracked].to(torch.int64))) & 0xFFFFFFFF
        stripe = max(1, min(STRIPE, b))
        width = b // stripe if b % stripe == 0 else b
        block = torch.zeros(b, dtype=torch.bool, device=dev)
        lo = (now % stripe) * width if width < b else 0
        block[lo:lo + width] = True
        seen = entry[tracked & block]
        t["last_seen"] = t["last_seen"].index_fill(0, seen, now) \
            if n else t["last_seen"]
        self.t = t
        n_tracked = tracked.sum()
        self.updates = self.updates + b
        self.lost = self.lost + (b - n_tracked)
