"""Batched connection tracking: a device-resident 5-tuple CT table (torch).

Port of ``cilium_tpu/datapath/conntrack.py`` (reference semantics:
bpf/lib/conntrack.h lifetimes, CT_NEW/ESTABLISHED/REPLY/RELATED with the
reverse lookup first, RST/FIN closing, per-direction TCP flag tracking).

One representation: a single [8, N+2] int32 tensor, one row per field
(k0..k3, expires, state, rev_nat, proxy_port), updated in place.  Slot
N is the reference's sentinel: nothing writes it and snapshots carry
it.  Slot N+1 is the port's private discard slot, the index at which
the reference drops its masked scatters (``mode="drop"``): torch
rejects an out-of-range index, so masked rows write there instead.
Probes never reach N or N+1 (``& (slots - 1)``); snapshots, GC and
entry counts leave N+1 out.

Where several rows of a batch ``set`` one slot, the reference's CPU
program lets the last row win every field, while CUDA ``index_put_``
picks any row, possibly a different one per field.  ``_elect`` makes
the winner explicit: the highest batch row per slot, elected with one
``amax`` scatter of row numbers, and all fields are written from it.

``ct_step`` and ``ct_set_rev_nat`` are the span ``dp:ct``, the create
rounds ``dp:ct.create`` (``observability/stages.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..observability.stages import span, spanned
from ..ops.hashtab_ops import hash_mix

# Lifetimes (reference: conntrack.h:31-34).
CT_LIFETIME_TCP = 21600
CT_LIFETIME_NONTCP = 60
CT_SYN_TIMEOUT = 60
CT_CLOSE_TIMEOUT = 10
CT_REPORT_INTERVAL = 5

# Verdict states (reference: conntrack.h CT_* enum order).
CT_NEW = 0
CT_ESTABLISHED = 1
CT_REPLY = 2
CT_RELATED = 3

# Direction (reference: CT_INGRESS/CT_EGRESS).
CT_INGRESS = 0
CT_EGRESS = 1

# TCP flag bits (standard wire order, lower byte).
TCP_FIN = 0x01
TCP_SYN = 0x02
TCP_RST = 0x04
TCP_ACK = 0x10

# Entry flag bits packed in the state word.
_RX_CLOSING = 1 << 0
_TX_CLOSING = 1 << 1
_RELATED = 1 << 2

# Field rows of the [8, N+2] table, in the reference's CTState order.
FIELDS = ("k0", "k1", "k2", "k3", "expires", "state", "rev_nat",
          "proxy_port")
_K0, _K1, _K2, _K3, _EXPIRES, _STATE, _REV_NAT, _PROXY = range(8)


class CTBatch(NamedTuple):
    """Per-packet tuples, all [B] int32."""

    saddr: torch.Tensor
    daddr: torch.Tensor
    sport: torch.Tensor
    dport: torch.Tensor
    proto: torch.Tensor
    direction: torch.Tensor  # CT_INGRESS / CT_EGRESS
    tcp_flags: torch.Tensor  # lower TCP flag byte (0 for non-TCP)
    related: torch.Tensor    # ICMP error -> related lookup (0/1)


def make_ct_state(slots: int, device: DeviceLike = None) -> torch.Tensor:
    """An empty [8, slots + 2] table (sentinel N, discard slot N+1)."""
    return torch.zeros((len(FIELDS), slots + 2), dtype=torch.int32,
                       device=resolve_device(device))


def _i32(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.int32, device=like.device)


def _pack_k2(sport, dport):
    return ((sport & 0xFFFF) << 16) | (dport & 0xFFFF)


def _pack_k3(proto, direction):
    return ((proto & 0xFF) << 8) | ((direction & 1) << 1) | 1


def _ct_hash(k0, k1, k2, k3):
    return hash_mix(hash_mix(k0, k1), hash_mix(k2, k3))


def _probe_idx(k0, k1, k2, k3, slots: int, max_probe: int):
    h = _ct_hash(k0, k1, k2, k3) & (slots - 1)
    steps = torch.arange(max_probe, dtype=torch.int32, device=k0.device)
    return (h[:, None] + steps[None, :]) & (slots - 1)


def _lookup(ct: torch.Tensor, k0, k1, k2, k3, now, slots: int,
            max_probe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found [B], slot [B]) for live (unexpired) entries.  The slot is
    the sum of the hit probes' indices, as in the reference."""
    idx = _probe_idx(k0, k1, k2, k3, slots, max_probe)       # [B, K]
    got_k3 = ct[_K3][idx]
    hit = (ct[_K0][idx] == k0[:, None]) & \
        (ct[_K1][idx] == k1[:, None]) & \
        (ct[_K2][idx] == k2[:, None]) & \
        (got_k3 == k3[:, None]) & (got_k3 != 0) & \
        (ct[_EXPIRES][idx] > now)
    found = hit.any(dim=1)
    slot = torch.where(hit, idx, _i32(0, idx)).sum(dim=1,
                                                   dtype=torch.int32)
    return found, slot


def _lifetime(proto, tcp_flags):
    is_tcp = proto == 6
    syn_only = (tcp_flags & (TCP_SYN | TCP_ACK)) == TCP_SYN
    return torch.where(is_tcp,
                       torch.where(syn_only, _i32(CT_SYN_TIMEOUT, proto),
                                   _i32(CT_LIFETIME_TCP, proto)),
                       _i32(CT_LIFETIME_NONTCP, proto))


def _elect(tgt: torch.Tensor, discard: int) -> torch.Tensor:
    """``tgt`` with every row but the highest of each target slot sent
    to the discard slot: where rows share a slot, the last row's write
    is the one that lands, in every field, as on the reference's CPU
    program.  Rows already aimed at the discard slot stay there."""
    rows = torch.arange(tgt.shape[0], dtype=torch.int32, device=tgt.device)
    winner = torch.full((discard + 1,), -1, dtype=torch.int32,
                        device=tgt.device)
    winner.scatter_reduce_(0, tgt.long(), rows, "amax", include_self=True)
    return torch.where(winner[tgt] == rows, tgt, _i32(discard, tgt))


@spanned("ct")
def ct_step(ct: torch.Tensor, batch: CTBatch, now: torch.Tensor,
            create_mask: torch.Tensor,
            update_mask: Optional[torch.Tensor] = None,
            rev_nat_in: Optional[torch.Tensor] = None,
            proxy_port_in: Optional[torch.Tensor] = None,
            *, slots: int, max_probe: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """One batched CT pass over ``ct`` ([8, slots+2]), updated in place.

    ``create_mask`` [B] bool gates CT_NEW entry creation (the policy
    verdict gate, bpf_lxc.c:545); ``update_mask`` [B] bool also gates
    hit-entry updates (prefilter-dropped packets neither refresh nor
    create); ``rev_nat_in``/``proxy_port_in`` [B] are stored into newly
    created entries.  ``now`` is a 0-d int32 tensor.

    Returns (ct_verdict [B] in CT_*, rev_nat [B], proxy_port [B], ct).
    The reads and writes follow the reference's order, so every read
    sees the same table the reference's does."""
    discard = slots + 1
    b = batch.saddr.shape[0]
    dev = batch.saddr.device
    zero = _i32(0, batch.saddr)
    if update_mask is None:
        update_mask = torch.ones(b, dtype=torch.bool, device=dev)
    if rev_nat_in is None:
        rev_nat_in = torch.zeros(b, dtype=torch.int32, device=dev)
    if proxy_port_in is None:
        proxy_port_in = torch.zeros(b, dtype=torch.int32, device=dev)
    update_mask = update_mask.to(torch.bool)

    fwd_k0, fwd_k1 = batch.saddr, batch.daddr
    fwd_k2 = _pack_k2(batch.sport, batch.dport)
    fwd_k3 = _pack_k3(batch.proto, batch.direction)
    # Reverse tuple: swapped addrs/ports, flipped direction
    # (conntrack.h:287 ipv4_ct_tuple_reverse).
    rev_k0, rev_k1 = batch.daddr, batch.saddr
    rev_k2 = _pack_k2(batch.dport, batch.sport)
    rev_k3 = _pack_k3(batch.proto, 1 - batch.direction)

    # Reverse first: REPLY/RELATED precedence (conntrack.h:468-471).
    rfound, rslot = _lookup(ct, rev_k0, rev_k1, rev_k2, rev_k3, now,
                            slots, max_probe)
    ffound, fslot = _lookup(ct, fwd_k0, fwd_k1, fwd_k2, fwd_k3, now,
                            slots, max_probe)
    hit = rfound | ffound
    slot = torch.where(rfound, rslot, fslot)

    # --- update hit entries -------------------------------------------
    closing = ((batch.tcp_flags & (TCP_FIN | TCP_RST)) != 0) & \
        (batch.proto == 6)
    life = torch.where(closing, _i32(CT_CLOSE_TIMEOUT, zero),
                       _lifetime(batch.proto, batch.tcp_flags))
    new_exp = now + life
    dir_is_in = batch.direction == CT_INGRESS
    flag_bits = torch.where(dir_is_in, (batch.tcp_flags & 0xFF) << 8,
                            (batch.tcp_flags & 0xFF) << 16)
    close_bit = torch.where(
        closing, torch.where(dir_is_in, _i32(_RX_CLOSING, zero),
                             _i32(_TX_CLOSING, zero)), zero)

    upd_slot = torch.where(hit & update_mask, slot, _i32(discard, zero))
    # Expiry: the last row of a slot wins (close shortens, activity
    # extends).
    ct[_EXPIRES][_elect(upd_slot, discard)] = new_exp
    # Flags accumulate by a max of (old | new), old value included.
    ct[_STATE].scatter_reduce_(0, upd_slot.long(),
                               ct[_STATE][slot] | flag_bits | close_bit,
                               "amax", include_self=True)

    # --- create new entries -------------------------------------------
    create = (~hit) & create_mask.to(torch.bool) & update_mask
    new_state = flag_bits | torch.where(batch.related != 0,
                                        _i32(_RELATED, zero), zero)
    new_life = now + _lifetime(batch.proto, batch.tcp_flags)
    fields = torch.stack([fwd_k0, fwd_k1, fwd_k2, fwd_k3,
                          new_life, new_state, rev_nat_in,
                          proxy_port_in])                     # [8, B]
    # Two rounds: flows that lose a same-batch race for a free slot
    # re-probe against the updated table and take the next free slot.
    with span("ct.create"):
        for _ in range(2):
            still = create & ~_lookup(ct, fwd_k0, fwd_k1, fwd_k2, fwd_k3,
                                      now, slots, max_probe)[0]
            cidx = _probe_idx(fwd_k0, fwd_k1, fwd_k2, fwd_k3, slots,
                              max_probe)
            free = (ct[_K3][cidx] == 0) | (ct[_EXPIRES][cidx] <= now)
            first_free = free & (torch.cumsum(free.to(torch.int32),
                                              dim=1) == 1)
            has_free = free.any(dim=1) & still
            cslot = torch.where(first_free, cidx, zero).sum(
                dim=1, dtype=torch.int32)
            tgt = torch.where(has_free, cslot, _i32(discard, zero))
            ct[:, _elect(tgt, discard)] = fields

    # --- verdict outputs, read from the final table -------------------
    entry_related = rfound & ((ct[_STATE][rslot] & _RELATED) != 0)
    verdict = torch.where(
        rfound,
        torch.where(entry_related | (batch.related != 0),
                    _i32(CT_RELATED, zero), _i32(CT_REPLY, zero)),
        torch.where(ffound, _i32(CT_ESTABLISHED, zero),
                    _i32(CT_NEW, zero)))
    rev_nat = torch.where(hit, ct[_REV_NAT][slot], zero)
    # Established flows keep redirecting through their recorded proxy
    # port.
    proxy_port = torch.where(ffound, ct[_PROXY][fslot], zero)
    return verdict, rev_nat, proxy_port, ct


@spanned("ct")
def ct_set_rev_nat(ct: torch.Tensor, batch: CTBatch,
                   rev_nat_idx: torch.Tensor, now: torch.Tensor, *,
                   slots: int, max_probe: int) -> torch.Tensor:
    """Stamp rev-NAT indices onto existing forward entries, in place
    (reference: ct_create4 stores ct_state->rev_nat_index)."""
    k2 = _pack_k2(batch.sport, batch.dport)
    k3 = _pack_k3(batch.proto, batch.direction)
    found, slot = _lookup(ct, batch.saddr, batch.daddr, k2, k3, now,
                          slots, max_probe)
    discard = slots + 1
    tgt = torch.where(found & (rev_nat_idx != 0), slot,
                      _i32(discard, slot))
    ct[_REV_NAT][_elect(tgt, discard)] = rev_nat_idx
    return ct


def ct_gc(ct: torch.Tensor, now: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clear expired entries in place (ctmap.go:240 doGC analog).
    Returns (ct, n_deleted as a 0-d int32 tensor).  The discard slot is
    neither counted nor cleared."""
    live = ct[:, :-1]
    dead = (live[_K3] != 0) & (live[_EXPIRES] <= now)
    live.masked_fill_(dead[None, :], 0)
    return ct, dead.sum(dtype=torch.int32)


class ConntrackTable:
    """Host wrapper owning the device CT state (pkg/maps/ctmap analog).

    Snapshots use the reference's npz layout: one [slots + 1] int32
    array per field (sentinel included) plus ``slots``, so a snapshot of
    either package restores into the other."""

    def __init__(self, slots: int = 1 << 16, max_probe: int = 8,
                 device: DeviceLike = None):
        if slots <= 0 or slots & (slots - 1):
            raise ValueError(f"CT slots must be a power of two: {slots}")
        self.device = resolve_device(device)
        self.slots = slots
        self.max_probe = max_probe
        self.state = make_ct_state(slots, self.device)

    def _now(self, now: int) -> torch.Tensor:
        return torch.full((), now, dtype=torch.int32, device=self.device)

    def step(self, batch: CTBatch, now: int, create_mask=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if create_mask is None:
            create_mask = torch.ones(batch.saddr.shape[0],
                                     dtype=torch.bool, device=self.device)
        verdict, rev_nat, _proxy, self.state = ct_step(
            self.state, batch, self._now(now), create_mask,
            slots=self.slots, max_probe=self.max_probe)
        return verdict, rev_nat

    def stamp_rev_nat(self, batch: CTBatch, rev_nat_idx, now: int) -> None:
        self.state = ct_set_rev_nat(self.state, batch, rev_nat_idx,
                                    self._now(now), slots=self.slots,
                                    max_probe=self.max_probe)

    def gc(self, now: int) -> int:
        self.state, n = ct_gc(self.state, self._now(now))
        return int(n)

    def entry_count(self) -> int:
        return int((self.state[_K3, :self.slots] != 0).sum())

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of every field, sentinel included, discard slot
        left out: the reference's per-field layout."""
        host = self.state[:, :self.slots + 1].cpu().numpy()
        out = {f: host[i].copy() for i, f in enumerate(FIELDS)}
        out["slots"] = np.array([self.slots], np.int64)
        return out

    def prepare_snapshot(self, arrays: Dict[str, np.ndarray]
                         ) -> torch.Tensor:
        """Validate a snapshot and build its table without touching this
        one, so a caller can prepare every table before assigning any.
        A geometry change invalidates it (ValueError)."""
        slots = int(np.asarray(arrays["slots"])[0])
        if slots != self.slots:
            raise ValueError(
                f"CT snapshot geometry {slots} != table {self.slots}")
        host = np.zeros((len(FIELDS), slots + 2), np.int32)
        for i, f in enumerate(FIELDS):
            host[i, :slots + 1] = np.asarray(arrays[f]).astype(
                np.int32, copy=False)
        return torch.as_tensor(host, device=self.device)

    def restore_snapshot(self, arrays: Dict[str, np.ndarray]) -> int:
        """prepare_snapshot + assign; returns live entries restored."""
        self.state = self.prepare_snapshot(arrays)
        return self.entry_count()
