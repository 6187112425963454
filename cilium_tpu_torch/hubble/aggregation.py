"""On-device flow aggregation: the Hubble flow table, in torch.

Port of ``cilium_tpu/hubble/aggregation.py``.  The step that produces the
verdict also reduces per-flow state: packet/byte counters and a
last-seen timestamp, keyed by (src identity, dst identity, dport, proto,
event code) packed into three exact words, so membership is an exact
compare.  New flows claim a free slot of their probe window; births are
capped at ``claim_budget`` rows a batch, and same-batch claim races are
resolved inside that small set (scatter, verify, retry on the next free
slot; two rounds).  Rows the table cannot track fold into a cumulative
``lost`` counter.  The host reads compact aggregates
(``FlowTable.snapshot``), never per-packet data.

State: ``keys`` [N+2, 4] int32 (src, dst, meta, last-seen) and
``counters`` [N+1, 2] int32 holding the uint32 packet and byte bits,
both updated in place.  Row N is the reference's sentinel, where masked
writes land and which is zeroed after each; row N+1 of ``keys`` carries
the cumulative (lost, updates) counters.  Where the reference drops a
scatter out of bounds, the port writes a discard entry of a buffer one
longer, because torch refuses an out-of-range index.

Where several claiming rows ``set`` one slot, JAX on the CPU keeps the
last row in every lane and CUDA ``index_put_`` any row, per lane; the
claim elects the highest row per slot (``conntrack._elect``) and writes
all four lanes from it.  Nothing here reads a device value on the host.
``flow_update_step`` is the span ``dp:flow`` (``observability/stages.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..datapath.conntrack import _elect
from ..device import DeviceLike, resolve_device
from ..observability.stages import spanned
from ..ops.hashtab_ops import hash_mix

# event' = event + EVENT_BIAS: maps every defined code (drops -136..-1,
# traces 0..6, headroom to -199/+55) to a nonzero byte, so meta == 0
# can only ever mean an empty slot (the occupancy convention).
EVENT_BIAS = 200

# lanes of the keys array
_SRC, _DST, _META, _LS = 0, 1, 2, 3


class FlowState(NamedTuple):
    """Device flow table: ``keys`` [N+2, 4] int32 (src, dst, meta,
    last-seen; row N the sentinel, row N+1 = (lost, updates, 0, 0)) and
    ``counters`` [N+1, 2] int32 of uint32 bits (packets, bytes)."""

    keys: torch.Tensor
    counters: torch.Tensor


def make_flow_state(slots: int, device: DeviceLike = None) -> FlowState:
    dev = resolve_device(device)
    return FlowState(
        keys=torch.zeros((slots + 2, 4), dtype=torch.int32, device=dev),
        counters=torch.zeros((slots + 1, 2), dtype=torch.int32,
                             device=dev))


def pack_flow_meta(dport, proto, event):
    """dport/proto/event key word; nonzero for every valid event (the
    biased event byte doubles as the occupancy marker)."""
    return ((dport & 0xFFFF) << 16) | ((proto & 0xFF) << 8) | \
        ((event + EVENT_BIAS) & 0xFF)


def _probe_idx(k0, k1, meta, slots: int, max_probe: int):
    h = hash_mix(hash_mix(k0, k1), meta)
    steps = torch.arange(max_probe, dtype=torch.int32, device=k0.device)
    return ((h & (slots - 1))[:, None] + steps[None, :]) & (slots - 1)


def _window_lookup(keys, idx, q):
    """(free [B, K], found [B], slot [B]) for queries q [B, 3] over the
    probe windows idx [B, K] (the last-seen lane stays out of the
    gather).  A query's meta word is never 0, so an empty slot never
    matches."""
    got_meta = keys[:, _META][idx]
    hit = (keys[:, _SRC][idx] == q[:, None, _SRC]) & \
        (keys[:, _DST][idx] == q[:, None, _DST]) & \
        (got_meta == q[:, None, _META])
    zero = torch.zeros((), dtype=torch.int32, device=idx.device)
    slot = torch.where(hit, idx, zero).sum(dim=1, dtype=torch.int32)
    return got_meta == 0, hit.any(dim=1), slot


def _first_rows(claim: torch.Tensor, budget: int) -> torch.Tensor:
    """The first ``budget`` row numbers where ``claim`` is set, ascending,
    padded with B (``jnp.nonzero(claim, size=budget, fill_value=B)``),
    from a running count and one scatter: no host read."""
    b = claim.shape[0]
    rank = torch.cumsum(claim.to(torch.int32), dim=0, dtype=torch.int32) - 1
    pos = torch.where(claim & (rank < budget), rank,
                      torch.full((), budget, dtype=torch.int32,
                                 device=claim.device))
    rows = torch.full((budget + 1,), b, dtype=torch.int32,
                      device=claim.device)
    rows[pos.long()] = torch.arange(b, dtype=torch.int32,
                                    device=claim.device)
    return rows[:budget]


@spanned("flow")
def flow_update_step(st: FlowState, src_id, dst_id, dport, proto,
                     event, length, now: torch.Tensor,
                     active: Optional[torch.Tensor] = None, *,
                     slots: int, max_probe: int,
                     claim_budget: int = 1024,
                     ls_stripe: int = 4) -> FlowState:
    """One batched flow-table update, in place; returns ``st``.

    Per-packet args are [B] int32, ``now`` a 0-d int32 tensor on their
    device, ``active`` [B] bool gates the rows that count (None: all).
    ``claim_budget`` caps new-flow births a batch; 0 leaves the claim
    out.  ``ls_stripe`` stripes the last-seen refresh: each batch
    rewrites last-seen for one rotating contiguous 1/stripe block of its
    rows (block ``now % stripe``); counters stay exact every batch, and
    stripe 1 makes last-seen exact too."""
    keys, counters = st
    dev = src_id.device
    sentinel = slots
    b = src_id.shape[0]
    budget = min(claim_budget, b)
    all_active = active is None
    if not all_active:
        active = active.to(torch.bool)
    k0 = src_id.to(torch.int32)
    k1 = dst_id.to(torch.int32)
    meta = pack_flow_meta(dport.to(torch.int32), proto.to(torch.int32),
                          event.to(torch.int32))
    q = torch.stack([k0, k1, meta], dim=1)                  # [B, 3]
    idx = _probe_idx(k0, k1, meta, slots, max_probe)        # [B, K]
    free, found, slot = _window_lookup(keys, idx, q)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    i_sentinel = torch.full((), sentinel, dtype=torch.int32, device=dev)

    if budget > 0:
        # capped claim: the claim and its races run on the <= budget
        # claiming rows, not on the batch
        claim = ~found & free.any(dim=1)
        if not all_active:
            claim = claim & active
        rows = _first_rows(claim, budget)
        valid = rows < b
        rix = torch.clamp(rows, 0, b - 1).long()
        q_c = q[rix]                                        # [C, 3]
        idx_c = idx[rix]                                    # [C, K]
        row_c = torch.cat([q_c, now.to(torch.int32).expand(budget, 1)],
                          dim=1)                            # [C, 4]
        taken = torch.zeros(budget, dtype=torch.bool, device=dev)
        slot_c = torch.full((budget,), sentinel, dtype=torch.int32,
                            device=dev)
        for _round in range(2):
            # free slots as of the current table, so a retry never
            # stomps an earlier winner
            free_c = keys[:, _META][idx_c] == 0
            first = free_c & (torch.cumsum(free_c.to(torch.int32), dim=1,
                                           dtype=torch.int32) == 1)
            cand = torch.where(first, idx_c, zero).sum(dim=1,
                                                       dtype=torch.int32)
            tgt = torch.where(valid & ~taken & free_c.any(dim=1), cand,
                              i_sentinel)
            keys[_elect(tgt, sentinel).long()] = row_c
            keys[sentinel] = 0
            # verify: racers that lost the slot retry next round (a
            # same-key sibling's win verifies here too)
            won = (keys[cand.long(), :3] == q_c).all(dim=1) & valid & \
                ~taken
            slot_c = torch.where(won, cand, slot_c)
            taken = taken | won
        # claimed slots back into the batch; row B is the discard entry
        claimed = torch.full((b + 1,), sentinel, dtype=torch.int32,
                             device=dev)
        claimed[torch.where(valid, rows, b).long()] = slot_c
        claimed = claimed[:b]
        tracked = found | (claimed != sentinel)
        target = torch.where(found, slot, claimed)
    else:
        tracked = found
        target = torch.where(found, slot, i_sentinel)
    if not all_active:
        tracked = tracked & active
        target = torch.where(tracked, target, i_sentinel)

    inc = torch.stack([tracked.to(torch.int32),
                       torch.where(tracked, length.to(torch.int32), zero)],
                      dim=1)                                # [B, 2]
    target = target.long()
    counters.index_add_(0, target, inc)
    counters[sentinel] = 0
    # striped last-seen refresh (claims already stamped ``now``)
    stripe = max(1, min(ls_stripe, b))
    width = b // stripe if b % stripe == 0 else b
    if width == b:
        ls_target = target
    else:
        phase = torch.remainder(now.to(torch.int32), stripe).long()
        ls_target = torch.index_select(target.view(stripe, width), 0,
                                       phase.view(1)).view(width)
    keys[:, _LS].index_put_((ls_target,),
                            now.to(torch.int32).expand(width))
    keys[sentinel] = 0
    n_tracked = tracked.sum(dtype=torch.int32)
    n_rows = torch.full((), b, dtype=torch.int32, device=dev) \
        if all_active else active.sum(dtype=torch.int32)
    # accounting row (slots + 1): cumulative (lost, updates)
    keys[slots + 1, :2] += torch.stack([n_rows - n_tracked, n_rows])
    return st


# ---------------------------------------------------------------------------
# Host wrapper + numpy oracle
# ---------------------------------------------------------------------------

def place_sharded(state: FlowState, mesh) -> FlowState:
    """Place the flow table where the mesh's step runs it
    (``parallel/mesh.py``): the mesh's first device, the column head
    whose step takes every batch whole (the reference replicates it
    across the mesh and reduces batch-sharded scatter-adds into it; one
    whole step gives the same table)."""
    dev = mesh.devices[0, 0]
    return FlowState(*(t.to(dev) for t in state))


class FlowTable:
    """Host owner of the device flow state (the Hubble flowmap analog)."""

    def __init__(self, slots: int = 1 << 12, max_probe: int = 8,
                 claim_budget: int = 1024, ls_stripe: int = 4,
                 device: DeviceLike = None):
        if slots <= 0 or slots & (slots - 1):
            raise ValueError(f"flow slots must be a power of two: {slots}")
        self.device = resolve_device(device)
        self.slots = slots
        self.max_probe = max_probe
        self.claim_budget = claim_budget
        self.ls_stripe = ls_stripe
        self.state = make_flow_state(slots, self.device)

    def update(self, src_id, dst_id, dport, proto, event, length,
               now: int) -> int:
        """Aggregate one host-side batch (the standalone path; the fused
        path runs inside the datapath step).  Returns the cumulative rows
        lost."""
        arr = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int32), device=self.device)
        self.state = flow_update_step(
            self.state, arr(src_id), arr(dst_id), arr(dport), arr(proto),
            arr(event), arr(length),
            torch.full((), now, dtype=torch.int32, device=self.device),
            slots=self.slots, max_probe=self.max_probe,
            claim_budget=self.claim_budget, ls_stripe=self.ls_stripe)
        return self.lost

    @property
    def lost(self) -> int:
        return int(self.state.keys[self.slots + 1, 0])

    @property
    def updates(self) -> int:
        return int(self.state.keys[self.slots + 1, 1])

    def snapshot(self, max_entries: int = 1 << 16) -> List[Dict]:
        """Decode live flows to host dicts (cilium bpf map dump analog)."""
        keys = self.state.keys.cpu().numpy()
        cnt = self.state.counters.cpu().numpy().view(np.uint32)
        # entry rows only: row N is the sentinel, row N+1 accounting
        idx = np.flatnonzero(keys[:self.slots, _META])[:max_entries]
        return [{
            "src-identity": int(keys[i, _SRC]),
            "dst-identity": int(keys[i, _DST]),
            "dport": int((keys[i, _META] >> 16) & 0xFFFF),
            "proto": int((keys[i, _META] >> 8) & 0xFF),
            "event": int(keys[i, _META] & 0xFF) - EVENT_BIAS,
            "packets": int(cnt[i, 0]), "bytes": int(cnt[i, 1]),
            "last-seen": int(keys[i, _LS])} for i in idx.tolist()]

    def entry_count(self) -> int:
        return int((self.state.keys[:self.slots, _META] != 0).sum())

    def stats(self) -> Dict:
        occupied = self.entry_count()
        return {"slots": self.slots, "occupied": occupied,
                "max-probe": self.max_probe,
                "load": round(occupied / self.slots, 4),
                "claim-budget": self.claim_budget,
                "updates": self.updates, "lost": self.lost}

    def reset(self) -> None:
        self.state = make_flow_state(self.slots, self.device)


def aggregate_oracle(src_id, dst_id, dport, proto, event, length,
                     now) -> Dict[Tuple[int, int, int, int, int],
                                  Tuple[int, int, int]]:
    """Host-side numpy oracle: per-flow-key (packets, bytes, last_seen)
    with the exact dtypes of the device table (uint32 counter wrap,
    int32 keys)."""
    src_id = np.asarray(src_id, np.int32)
    dst_id = np.asarray(dst_id, np.int32)
    dport = np.asarray(dport, np.int32)
    proto = np.asarray(proto, np.int32)
    event = np.asarray(event, np.int32)
    length = np.asarray(length, np.int32)
    out: Dict[Tuple[int, int, int, int, int], Tuple[int, int, int]] = {}
    for i in range(src_id.shape[0]):
        key = (int(src_id[i]), int(dst_id[i]),
               int(dport[i]) & 0xFFFF, int(proto[i]) & 0xFF,
               int(event[i]))
        p, b, ls = out.get(key, (0, 0, 0))
        out[key] = ((p + 1) & 0xFFFFFFFF,
                    (b + (int(length[i]) & 0xFFFFFFFF)) & 0xFFFFFFFF,
                    max(ls, int(now)))
    return out


def snapshot_to_oracle_form(snapshot: List[Dict]
                            ) -> Dict[Tuple[int, int, int, int, int],
                                      Tuple[int, int, int]]:
    """Reshape a FlowTable.snapshot() into the oracle's key space."""
    return {(f["src-identity"], f["dst-identity"], f["dport"],
             f["proto"], f["event"]):
            (f["packets"], f["bytes"], f["last-seen"])
            for f in snapshot}
