"""Batched service load balancing: VIP -> backend + rev-NAT (torch).

Port of ``cilium_tpu/datapath/lb.py`` (reference: bpf/lib/lb.h
lb4/lb6_lookup_service, lb*_select_slave, lb*_local and lb*_rev_nat;
bookkeeping of pkg/maps/lbmap).  Compiled form: one hash table (vip,
port|proto) -> service index, flat backend arrays indexed by
[svc_offset + slave], and rev-NAT arrays indexed by rev_nat_index.  The
v6 tables hold the VIP as four words, compared in full, and whole v6
addresses in the backend and rev-NAT rows.

JAX clamps an out-of-range gather index and CUDA faults on one, so the
port clips each gather index the reference lets its clamp absorb: the
backend index of a zero-backend service that is compiled last lies one
past the backend arrays.  The DNAT and reverse-NAT steps of both
families are the span ``dp:lb`` (``observability/stages.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.hashtab import build_hash_table
from ..compiler.lpm import _hash6 as _hash6_host
from ..device import DeviceLike, resolve_device
from ..observability.stages import spanned
from ..ops.hashtab_ops import batched_lookup, fold6, hash_mix
from ..ops.lpm_ops import _hash6


@dataclass(frozen=True)
class Backend:
    addr: int       # uint32 IPv4 as int
    port: int


@dataclass
class Service:
    """A service frontend (reference: pkg/loadbalancer types)."""

    vip: int        # uint32 IPv4
    port: int
    proto: int = 6
    backends: List[Backend] = field(default_factory=list)
    rev_nat_index: int = 0  # assigned at compile/insert time


class LBTables(NamedTuple):
    """Device LB state, all int32."""

    svc_key_a: torch.Tensor   # [S] vip
    svc_key_b: torch.Tensor   # [S] port<<16 | proto<<8 | 1
    svc_value: torch.Tensor   # [S] service index
    svc_count: torch.Tensor   # [NSVC] backend count
    svc_offset: torch.Tensor  # [NSVC] offset into backend arrays
    svc_revnat: torch.Tensor  # [NSVC] rev-NAT index
    b_addr: torch.Tensor      # [NB]
    b_port: torch.Tensor      # [NB]
    rev_vip: torch.Tensor     # [NR] rev_nat_index -> original VIP
    rev_port: torch.Tensor    # [NR]


@dataclass
class CompiledLB:
    tables: LBTables
    max_probe: int
    num_services: int
    num_backends: int


def _u32_bits(values) -> np.ndarray:
    """Python ints in uint32 range -> int32 array of the same bits."""
    return np.asarray(values, np.int64).astype(np.uint32).view(np.int32)


def compile_lb(services: Sequence[Service],
               device: DeviceLike = None) -> CompiledLB:
    """Lower a service list to device tables.

    rev_nat_index is 1-based (0 == no NAT) and stable for the lifetime
    of a service: conntrack entries survive table recompiles, so a live
    flow's stored index has to keep resolving to the same VIP.  Services
    without an index get the lowest free one here; the rev-NAT arrays
    are sized by the largest index, so a deleted service leaves a zero
    row instead of renumbering the others."""
    dev = resolve_device(device)
    entries = {}
    counts, offsets, revnats = [], [], []
    b_addr, b_port = [], []
    used = {s.rev_nat_index for s in services if s.rev_nat_index > 0}
    next_free = 1
    for svc in services:
        if svc.rev_nat_index <= 0:
            while next_free in used:
                next_free += 1
            svc.rev_nat_index = next_free
            used.add(next_free)
    max_idx = max(used, default=0)
    rev_vip = [0] * (max_idx + 1)
    rev_port = [0] * (max_idx + 1)
    for i, svc in enumerate(services):
        key = (svc.vip & 0xFFFFFFFF,
               ((svc.port & 0xFFFF) << 16) | ((svc.proto & 0xFF) << 8) | 1)
        entries[key] = i
        offsets.append(len(b_addr))
        counts.append(len(svc.backends))
        revnats.append(svc.rev_nat_index)
        for b in svc.backends:
            b_addr.append(b.addr & 0xFFFFFFFF)
            b_port.append(b.port)
        rev_vip[svc.rev_nat_index] = svc.vip & 0xFFFFFFFF
        rev_port[svc.rev_nat_index] = svc.port
    t = build_hash_table(entries) if entries else build_hash_table(
        {(0, 1): 0}, min_slots=8)
    put = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.int32), device=dev)
    tables = LBTables(
        svc_key_a=put(t.key_a), svc_key_b=put(t.key_b),
        svc_value=put(t.value),
        svc_count=put(counts or [0]), svc_offset=put(offsets or [0]),
        svc_revnat=put(revnats or [0]),
        b_addr=put(_u32_bits(b_addr or [0])), b_port=put(b_port or [0]),
        rev_vip=put(_u32_bits(rev_vip)), rev_port=put(rev_port))
    return CompiledLB(tables=tables, max_probe=t.max_probe,
                      num_services=len(services), num_backends=len(b_addr))


def select_slave(h: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Backend slot from the 5-tuple hash: ``abs(h) % max(count, 1)``,
    where 0 backends give 0.  At h = -2**31 ``abs`` stays negative and
    ``%`` (``torch.remainder``) takes the divisor's sign, as JAX's does;
    ``torch.fmod`` would not."""
    n = torch.clamp(count, min=1)
    return torch.where(count > 0, torch.abs(h) % n, torch.zeros_like(h))


@spanned("lb")
def lb_step(tables: LBTables, daddr, dport, proto, saddr, sport, *,
            max_probe: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Service DNAT for a batch (lb4_lookup_service + lb4_select_slave +
    lb4_local).  Returns (new_daddr, new_dport, rev_nat_idx, is_service);
    non-service packets pass through unchanged with rev_nat 0."""
    qb = ((dport & 0xFFFF) << 16) | ((proto & 0xFF) << 8) | 1
    found, svc_idx, _ = batched_lookup(
        tables.svc_key_a, tables.svc_key_b, tables.svc_value,
        daddr, qb, max_probe)
    zero = torch.zeros((), dtype=torch.int32, device=daddr.device)
    svc_idx = torch.where(found, svc_idx, zero)
    count = tables.svc_count[svc_idx]
    offset = tables.svc_offset[svc_idx]
    # Slave selection by packet 5-tuple hash (lb.h lb4_hash).
    h = hash_mix(hash_mix(saddr, daddr),
                 hash_mix(((sport & 0xFFFF) << 16) | (dport & 0xFFFF),
                          proto))
    bidx = torch.clamp(offset + select_slave(h, count), 0,
                       tables.b_addr.shape[0] - 1)
    ok = found & (count > 0)
    new_daddr = torch.where(ok, tables.b_addr[bidx], daddr)
    new_dport = torch.where(ok, tables.b_port[bidx], dport)
    rev_nat = torch.where(ok, tables.svc_revnat[svc_idx], zero)
    return new_daddr, new_dport, rev_nat, ok


@spanned("lb")
def lb_rev_nat(tables: LBTables, saddr, sport, rev_nat_idx
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reply-path reverse NAT: restore VIP/port for flows whose CT entry
    carries a rev_nat_index (reference: lb4_rev_nat).  The index is
    clipped to the rev-NAT arrays, as JAX's gather clamps it."""
    has = rev_nat_idx > 0
    n = tables.rev_vip.shape[0]
    idx = torch.clamp(torch.where(has, rev_nat_idx,
                                  torch.zeros_like(rev_nat_idx)), 0, n - 1)
    return (torch.where(has, tables.rev_vip[idx], saddr),
            torch.where(has, tables.rev_port[idx], sport))


# ---------------------------------------------------------------------------
# IPv6 (lb6)
# ---------------------------------------------------------------------------

Words6 = Tuple[int, int, int, int]  # big-endian uint32 words


@dataclass(frozen=True)
class Backend6:
    addr: Words6
    port: int


@dataclass
class Service6:
    vip: Words6
    port: int
    proto: int = 6
    backends: List[Backend6] = field(default_factory=list)
    rev_nat_index: int = 0


class LB6Tables(NamedTuple):
    """Device lb6 state, all int32."""

    svc_k0: torch.Tensor      # [S] vip words
    svc_k1: torch.Tensor
    svc_k2: torch.Tensor
    svc_k3: torch.Tensor
    svc_kb: torch.Tensor      # [S] port<<16 | proto<<8 | 1 (0 = empty)
    svc_value: torch.Tensor   # [S] service index
    svc_count: torch.Tensor   # [NSVC]
    svc_offset: torch.Tensor
    svc_revnat: torch.Tensor
    b_addr: torch.Tensor      # [NB, 4]
    b_port: torch.Tensor      # [NB]
    rev_vip: torch.Tensor     # [NR, 4]
    rev_port: torch.Tensor    # [NR]


@dataclass
class CompiledLB6:
    tables: LB6Tables
    max_probe: int
    num_services: int
    num_backends: int


def compile_lb6(services: Sequence[Service6],
                device: DeviceLike = None) -> CompiledLB6:
    """Lower v6 services to device tables.  Indices of services without
    one are allocated past the highest index in use, never the lowest
    free one: live CT entries may still carry a freed index."""
    dev = resolve_device(device)
    used = {s.rev_nat_index for s in services if s.rev_nat_index > 0}
    next_free = max(used, default=0) + 1
    for svc in services:
        if svc.rev_nat_index <= 0:
            svc.rev_nat_index = next_free
            used.add(next_free)
            next_free += 1
    max_idx = max(used, default=0)
    n = len(services)
    slots = 8
    while slots < 2 * max(n, 1):
        slots *= 2
    k = [np.zeros(slots, np.int32) for _ in range(4)]
    kb = np.zeros(slots, np.int32)
    value = np.zeros(slots, np.int32)
    counts, offsets, revnats = [], [], []
    b_addr: List[Words6] = []
    b_port: List[int] = []
    rev_vip: List[Words6] = [(0, 0, 0, 0)] * (max_idx + 1)
    rev_port = [0] * (max_idx + 1)
    max_probe = 1
    for i, svc in enumerate(services):
        occ = ((svc.port & 0xFFFF) << 16) | ((svc.proto & 0xFF) << 8) | 1
        h = int(_hash6_host(*svc.vip, occ)) & (slots - 1)
        probe = 0
        while kb[(h + probe) % slots] != 0:
            probe += 1
        s = (h + probe) % slots
        for j in range(4):
            k[j][s] = np.uint32(svc.vip[j]).view(np.int32)
        # int32 bits: ports >= 0x8000 push occ past the int32 maximum
        kb[s] = np.uint32(occ).view(np.int32)
        value[s] = i
        max_probe = max(max_probe, probe + 1)
        offsets.append(len(b_addr))
        counts.append(len(svc.backends))
        revnats.append(svc.rev_nat_index)
        for b in svc.backends:
            b_addr.append(b.addr)
            b_port.append(b.port)
        rev_vip[svc.rev_nat_index] = svc.vip
        rev_port[svc.rev_nat_index] = svc.port
    put = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.int32), device=dev)
    words = lambda rows: put(  # noqa: E731
        np.asarray(rows or [(0, 0, 0, 0)], np.uint32).view(np.int32))
    tables = LB6Tables(
        svc_k0=put(k[0]), svc_k1=put(k[1]), svc_k2=put(k[2]),
        svc_k3=put(k[3]), svc_kb=put(kb), svc_value=put(value),
        svc_count=put(counts or [0]), svc_offset=put(offsets or [0]),
        svc_revnat=put(revnats or [0]), b_addr=words(b_addr),
        b_port=put(b_port or [0]), rev_vip=words(rev_vip),
        rev_port=put(rev_port))
    return CompiledLB6(tables=tables, max_probe=max_probe,
                       num_services=n, num_backends=len(b_addr))


@spanned("lb")
def lb6_step(tables: LB6Tables, daddr, dport, proto, saddr, sport, *,
             max_probe: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """v6 service DNAT (lb6_lookup_service + lb6_select_slave +
    lb6_local); daddr/saddr are [B, 4].  Returns (new_daddr [B, 4],
    new_dport, rev_nat_idx, is_service).  The backend index is clipped
    into the backend arrays, as JAX's gather clamps it."""
    slots = tables.svc_kb.shape[0]
    mask = slots - 1
    zero = torch.zeros((), dtype=torch.int32, device=daddr.device)
    qb = ((dport & 0xFFFF) << 16) | ((proto & 0xFF) << 8) | 1
    h = _hash6(daddr[:, 0], daddr[:, 1], daddr[:, 2], daddr[:, 3], qb)
    steps = torch.arange(max_probe, dtype=torch.int32, device=daddr.device)
    probes = ((h[:, None] & mask) + steps[None, :]) & mask        # [B, K]
    got_kb = tables.svc_kb[probes]
    hit = (tables.svc_k0[probes] == daddr[:, 0:1]) & \
        (tables.svc_k1[probes] == daddr[:, 1:2]) & \
        (tables.svc_k2[probes] == daddr[:, 2:3]) & \
        (tables.svc_k3[probes] == daddr[:, 3:4]) & \
        (got_kb == qb[:, None]) & (got_kb != 0)
    found = hit.any(dim=1)
    svc_idx = torch.where(hit, tables.svc_value[probes], zero).sum(
        dim=1, dtype=torch.int32)
    count = tables.svc_count[svc_idx]
    offset = tables.svc_offset[svc_idx]
    hsel = hash_mix(hash_mix(fold6(saddr), fold6(daddr)),
                    hash_mix(((sport & 0xFFFF) << 16) | (dport & 0xFFFF),
                             proto))
    bidx = torch.clamp(offset + select_slave(hsel, count), 0,
                       tables.b_port.shape[0] - 1)
    ok = found & (count > 0)
    new_daddr = torch.where(ok[:, None], tables.b_addr[bidx], daddr)
    new_dport = torch.where(ok, tables.b_port[bidx], dport)
    rev_nat = torch.where(ok, tables.svc_revnat[svc_idx], zero)
    return new_daddr, new_dport, rev_nat, ok


@spanned("lb")
def lb6_rev_nat(tables: LB6Tables, saddr, sport, rev_nat_idx
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reply-path v6 reverse NAT (lb6_rev_nat): saddr [B, 4].  The index
    is clipped to the rev-NAT arrays, as JAX's gather clamps it."""
    has = rev_nat_idx > 0
    n = tables.rev_vip.shape[0]
    idx = torch.clamp(torch.where(has, rev_nat_idx,
                                  torch.zeros_like(rev_nat_idx)), 0, n - 1)
    return (torch.where(has[:, None], tables.rev_vip[idx], saddr),
            torch.where(has, tables.rev_port[idx], sport))


class LoadBalancer:
    """Host-side service registry + compiled device tables
    (pkg/service + pkg/maps/lbmap analog)."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._services: Dict[Tuple[int, int, int], Service] = {}
        self.compiled: Optional[CompiledLB] = None
        self._next_rev_nat = 1  # stable, monotonically allocated

    def _admit(self, svc: Service) -> None:
        key = (svc.vip, svc.port, svc.proto)
        old = self._services.get(key)
        if old is not None:
            # keep the stable rev-NAT index across updates
            svc.rev_nat_index = old.rev_nat_index
        else:
            svc.rev_nat_index = self._next_rev_nat
            self._next_rev_nat += 1
        self._services[key] = svc

    def upsert_service(self, svc: Service) -> None:
        self._admit(svc)
        self._recompile()

    def upsert_services(self, services: Sequence[Service]) -> None:
        """``upsert_service`` for each, in order, with one recompile."""
        for svc in services:
            self._admit(svc)
        self._recompile()

    def delete_service(self, vip: int, port: int, proto: int = 6) -> bool:
        existed = self._services.pop((vip, port, proto), None) is not None
        if existed:
            self._recompile()
        return existed

    def _recompile(self) -> None:
        self.compiled = compile_lb(list(self._services.values()),
                                   device=self.device)

    def __len__(self) -> int:
        return len(self._services)

    def services(self) -> List[Service]:
        return sorted(self._services.values(),
                      key=lambda s: (s.vip, s.port, s.proto))

    def step(self, daddr, dport, proto, saddr, sport):
        if self.compiled is None:
            self._recompile()
        return lb_step(self.compiled.tables, daddr, dport, proto, saddr,
                       sport, max_probe=self.compiled.max_probe)

    def rev_nat(self, saddr, sport, rev_nat_idx):
        return lb_rev_nat(self.compiled.tables, saddr, sport, rev_nat_idx)
