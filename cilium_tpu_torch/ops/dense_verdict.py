"""Dense broadcast-compare verdict engine (torch + CUDA kernel).

Port of ``cilium_tpu/ops/dense_verdict.py``.  Policy entries live as flat
arrays [N] (one row per real entry), and a batch classifies by comparing
packet keys against all entries: the 3-stage fallback of
bpf/lib/policy.h:46 __policy_can_access, with per-entry packet/byte
counter deltas at the entry that decided each packet.

``dense_verdict`` is the kernel wrapper.  On CUDA tensors it launches
the hand-written kernel ``csrc/dense_verdict.cu`` (the port of the
Pallas kernel ``_dense_tiled_kernel``) or raises; on CPU tensors it runs
the plain version ``dense_verdict_reference``.  The kernel compares
each packet with its own endpoint's entries only, which
``compile_dense`` stores contiguously; ``dense_segments`` derives where
each endpoint's run lies, once per table.  The dense LPM stays in plain
torch.  Both plain versions work in chunks of packets so that the
[chunk, N] compare matrices stay small at any batch size.

Counters are wrapping int32 holding the reference's uint32 bits (torch
has no ``index_add_`` for uint32), added into in place.
"""

from __future__ import annotations

import ctypes
import functools
import ipaddress
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..compiler.policy_tables import pack_key, pack_meta
from ..datapath.codes import VERDICT_DROP, WORLD_IDENTITY
from ..device import DeviceLike, resolve_device
from ..policy.mapstate import PolicyMapState

# Entry axis padded to the reference's lane width, so the port's tables
# equal the reference's bit for bit.
LANE = 128
# Elements of one [chunk, N] compare matrix in the plain versions.
_CHUNK_ELEMS = 1 << 24


class DenseTables(NamedTuple):
    """Flat policy entries across all endpoints, padded to LANE."""

    ep: torch.Tensor      # [N] int32, -1 on padding rows
    key_a: torch.Tensor   # [N] int32 identity word
    key_b: torch.Tensor   # [N] int32 packed meta word
    value: torch.Tensor   # [N] int32 proxy port


def _i32(values, dev: torch.device) -> torch.Tensor:
    """Python ints (uint32 or int32 range) -> int32 tensor of the bits."""
    arr = np.array(values, np.int64).astype(np.uint32).view(np.int32)
    return torch.as_tensor(arr, device=dev)


def compile_dense(map_states: Sequence[PolicyMapState],
                  device: DeviceLike = None) -> DenseTables:
    """Stack every endpoint's entries into flat arrays, each endpoint's
    entries contiguous and sorted by packed key."""
    dev = resolve_device(device)
    eps: List[int] = []
    kas: List[int] = []
    kbs: List[int] = []
    vals: List[int] = []
    for ep_idx, state in enumerate(map_states):
        for k, v in sorted(state.items(), key=lambda kv: pack_key(kv[0])):
            ka, kb = pack_key(k)
            eps.append(ep_idx)
            kas.append(ka)
            kbs.append(kb)
            vals.append(v.proxy_port)
    n = len(eps)
    pad = (-n) % LANE
    if n == 0:
        pad = LANE
    eps += [-1] * pad
    kas += [0] * pad
    kbs += [0] * pad
    vals += [0] * pad
    return DenseTables(ep=_i32(eps, dev), key_a=_i32(kas, dev),
                       key_b=_i32(kbs, dev), value=_i32(vals, dev))


class DenseSegments(NamedTuple):
    """Where each endpoint's entries lie in a ``DenseTables``, for the
    kernel: endpoint ``e`` owns rows ``offsets[e]:offsets[e + 1]``.
    ``entries`` is a copy of the tables, so the segments hold the tables
    they were made from and those tensors' version counters, and
    ``dense_verdict`` refuses them for any other tables or once a table
    tensor has been changed in place."""

    offsets: torch.Tensor   # [E + 1] int32, on the tables' device
    n_endpoints: int        # E: the last real row's endpoint + 1
    entries: torch.Tensor   # [N, 4] int32 rows (ep, key_a, key_b, value)
    source: DenseTables     # the tables these segments describe
    versions: Tuple[int, ...]  # their tensors' ``_version`` at the copy


def _versions(tables: DenseTables) -> Tuple[int, ...]:
    return tuple(t._version for t in tables)


def dense_segments(tables: DenseTables) -> DenseSegments:
    """Derive the endpoint segments of ``tables``; reads ``tables.ep``
    on the host once (a sync on a card), so build them with the tables
    and hand them to every step.  Raises unless the real rows' ``ep``
    are non-negative and non-decreasing and only ``-1`` padding rows
    follow them, as ``compile_dense`` lays them out.  An endpoint below
    E with no rows gets an empty segment."""
    ep = tables.ep.cpu().numpy()
    real = int(np.argmax(ep < 0)) if (ep < 0).any() else ep.shape[0]
    if (ep[real:] != -1).any():
        raise ValueError("dense_segments: rows after the first padding "
                         "row (ep = -1) must all be padding")
    if (np.diff(ep[:real]) < 0).any():
        raise ValueError("dense_segments: each endpoint's rows must be "
                         "contiguous, in increasing endpoint order")
    n_endpoints = int(ep[real - 1]) + 1 if real else 0
    offsets = np.searchsorted(ep[:real], np.arange(n_endpoints + 1),
                              side="left").astype(np.int32)
    dev = tables.ep.device
    return DenseSegments(offsets=torch.as_tensor(offsets, device=dev),
                         n_endpoints=n_endpoints,
                         entries=torch.stack(tuple(tables), dim=1)
                         .contiguous(),
                         source=tables, versions=_versions(tables))


def _chunk_rows(n_cols: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, n_cols))


def dense_verdict_reference(tables: DenseTables, pkt_ep, pkt_ident,
                            pkt_dport, pkt_proto, pkt_dir, pkt_len
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain torch twin of the reference's ``_classify_block`` (as
    ``dense_verdict_step`` calls it), over packet chunks.

    Returns (verdict [B], counter deltas packets [N], bytes [N]), all
    int32; the deltas wrap like the reference's uint32."""
    ep, ka, kb, val = tables
    meta_exact = pack_meta(pkt_dport, pkt_proto, pkt_dir)
    meta_l3 = pack_meta(torch.zeros_like(pkt_dport),
                        torch.zeros_like(pkt_proto), pkt_dir)
    dev = ep.device
    n = ep.shape[0]
    d_pk = torch.zeros(n, dtype=torch.int32, device=dev)
    d_by = torch.zeros(n, dtype=torch.int32, device=dev)
    verdicts = []
    step = _chunk_rows(n)
    drop = torch.full((), VERDICT_DROP, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for lo in range(0, pkt_ep.shape[0], step):
        pep = pkt_ep[lo:lo + step, None]
        pid = pkt_ident[lo:lo + step, None]
        pme = meta_exact[lo:lo + step, None]
        pml = meta_l3[lo:lo + step, None]
        plen = pkt_len[lo:lo + step, None].to(torch.int32)
        same_ep = pep == ep[None, :]
        ident_eq = pid == ka[None, :]
        m1 = same_ep & ident_eq & (pme == kb[None, :])
        m2 = same_ep & ident_eq & (pml == kb[None, :])
        m3 = same_ep & (ka[None, :] == 0) & (pme == kb[None, :])
        hit1 = m1.any(dim=1)
        hit2 = m2.any(dim=1)
        hit3 = m3.any(dim=1)
        # unique keys per endpoint => at most one match per stage
        val1 = (m1.to(torch.int32) * val[None, :]).sum(1, dtype=torch.int32)
        val3 = (m3.to(torch.int32) * val[None, :]).sum(1, dtype=torch.int32)
        verdicts.append(torch.where(
            hit1, val1, torch.where(hit2, zero,
                                    torch.where(hit3, val3, drop))))
        # effective match: the stage that decided each packet
        m_eff = m1 | (m2 & ~hit1[:, None]) | \
            (m3 & ~(hit1 | hit2)[:, None])
        ieff = m_eff.to(torch.int32)
        d_pk += ieff.sum(0, dtype=torch.int32)
        d_by += (ieff * plen).sum(0, dtype=torch.int32)
    verdict = torch.cat(verdicts) if verdicts else \
        torch.empty(0, dtype=torch.int32, device=dev)
    return verdict, d_pk, d_by


# Packets each thread of the verdict kernel compares with every entry
# it loads: ``kPerThread`` in ``csrc/dense_verdict.cu``.
PACKETS_PER_THREAD = 2


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the C functions of a built ``csrc/dense_verdict.cu``.
    Pointers and the stream go as c_void_p: a bare Python int would be
    cut to 32 bits."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_verdict_launch.restype = i
    lib.dense_verdict_launch.argtypes = [p, i, p, i, p, p, p, p, p, p, i,
                                         p, p, p, p, i, p]
    lib.dense_verdict_scratch_words.restype = ctypes.c_longlong
    lib.dense_verdict_scratch_words.argtypes = [i, i]
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    return declare(kernels.load("dense_verdict"))


def check_segments(tables: DenseTables, segments: DenseSegments) -> None:
    """Raise unless ``segments`` were made by ``dense_segments(tables)``
    and no table tensor has changed in place since."""
    if any(s is not t for s, t in zip(segments.source, tables)):
        raise ValueError("dense_verdict: segments were made from other "
                         "tables; build them with dense_segments(tables)")
    if segments.versions != _versions(tables):
        raise ValueError("dense_verdict: the tables changed in place after "
                         "their segments were made; build them again")


def dense_verdict(tables: DenseTables, pkt_ep, pkt_ident, pkt_dport,
                  pkt_proto, pkt_dir, pkt_len, *,
                  segments: Optional[DenseSegments] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense verdict stage: (verdict [B], d_packets [N], d_bytes [N]).

    ``segments`` must be ``dense_segments(tables)``, made since the
    tables last changed (``check_segments``, on either device); ``None``
    derives them here, a host sync on a card.
    On CPU tensors: ``dense_verdict_reference``.
    On CUDA tensors: one launch of ``csrc/dense_verdict.cu`` on the
    current stream (four kernels: it groups the packets by endpoint and
    compares each group with its endpoint's segment only), counted in
    ``dense_verdict.launches``.
    Anything the kernel does not take (mixed devices, a dtype other than
    int32, non-contiguous or mismatched shapes) raises.  Any B and any N
    are taken; packets whose endpoint has no segment drop."""
    if segments is not None:
        check_segments(tables, segments)
    args = (*tables, pkt_ep, pkt_ident, pkt_dport, pkt_proto, pkt_dir,
            pkt_len)
    devices = {t.device for t in args}
    if devices == {torch.device("cpu")}:
        return dense_verdict_reference(tables, pkt_ep, pkt_ident,
                                       pkt_dport, pkt_proto, pkt_dir,
                                       pkt_len)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("dense_verdict: tensors on "
                         f"{sorted(map(str, devices))}; all must be on one "
                         "CUDA device or all on the CPU")
    for t in args:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("dense_verdict: every input must be a "
                             "contiguous 1-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    n, b = tables.ep.shape[0], pkt_ep.shape[0]
    if any(t.shape[0] != n for t in tables) or \
            any(t.shape[0] != b for t in args[4:]):
        raise ValueError("dense_verdict: entry arrays must share one "
                         "length and packet arrays another")
    if n >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError("dense_verdict: B and N must fit int32")
    if segments is None:
        segments = dense_segments(tables)
    dev = pkt_ep.device
    if segments.entries.device != dev or segments.offsets.device != dev \
            or tuple(segments.entries.shape) != (n, 4) \
            or tuple(segments.offsets.shape) != (segments.n_endpoints + 1,):
        raise ValueError("dense_verdict: segments do not fit these tables")
    if b == 0:
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        return (torch.empty(0, dtype=torch.int32, device=dev), zeros,
                zeros.clone())
    verdict = torch.empty(b, dtype=torch.int32, device=dev)
    # the launch zeroes the two counter arrays itself
    d_pk = torch.empty(n, dtype=torch.int32, device=dev)
    d_by = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _kernel_library()
    n_ep = segments.n_endpoints
    scratch = torch.empty(lib.dense_verdict_scratch_words(b, n_ep),
                          dtype=torch.int32, device=dev)
    ptr = lambda t: t.data_ptr()  # noqa: E731
    code = lib.dense_verdict_launch(
        ptr(segments.entries), n, ptr(segments.offsets), n_ep,
        *map(ptr, args[4:]), b, ptr(verdict), ptr(d_pk), ptr(d_by),
        ptr(scratch), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, "dense_verdict launch")
    dense_verdict.launches += 1
    return verdict, d_pk, d_by


dense_verdict.launches = 0


# ---------------------------------------------------------------------------
# Dense LPM + fused raw-path step
# ---------------------------------------------------------------------------

class DenseLPM(NamedTuple):
    """Flat LPM entries: addr-under-mask compare, longest-prefix wins."""

    net: torch.Tensor    # [P] int32 network address (pre-masked)
    mask: torch.Tensor   # [P] int32 netmask
    plen: torch.Tensor   # [P] int32 prefix length + 1 (0 = padding row)
    value: torch.Tensor  # [P] int32 identity


def compile_dense_lpm(prefixes, device: DeviceLike = None) -> DenseLPM:
    """{cidr: identity} -> DenseLPM (pads to LANE)."""
    dev = resolve_device(device)
    rows = []
    for cidr, ident in sorted(prefixes.items()):
        net = ipaddress.ip_network(cidr, strict=False)
        mask = int(net.netmask)
        rows.append((int(net.network_address) & mask, mask,
                     net.prefixlen + 1, ident))
    pad = (-len(rows)) % LANE
    if not rows:
        pad = LANE
    rows += [(0, 0xFFFFFFFF, 0, 0)] * pad  # plen 0 rows never win
    cols = list(zip(*rows))
    return DenseLPM(net=_i32(cols[0], dev), mask=_i32(cols[1], dev),
                    plen=_i32(cols[2], dev), value=_i32(cols[3], dev))


def dense_lpm_lookup(lpm: DenseLPM, addr: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B] addr -> (found [B] bool, value [B] int32): longest matching
    prefix wins, as a [chunk, P] masked compare + two reductions per
    chunk of packets."""
    found, values = [], []
    zero = torch.zeros((), dtype=torch.int32, device=addr.device)
    step = _chunk_rows(lpm.net.shape[0])
    for lo in range(0, addr.shape[0], step):
        a = addr[lo:lo + step, None]
        match = (a & lpm.mask[None, :]) == lpm.net[None, :]
        score = torch.where(match, lpm.plen[None, :], zero)
        best = score.amax(dim=1)
        # exactly one prefix of a given length can contain an address,
        # so a masked sum selects the winner's value
        sel = match & (score == best[:, None]) & (best[:, None] > 0)
        values.append((sel.to(torch.int32) * lpm.value[None, :])
                      .sum(1, dtype=torch.int32))
        found.append(best > 0)
    if not found:
        return (torch.zeros(0, dtype=torch.bool, device=addr.device),
                torch.zeros(0, dtype=torch.int32, device=addr.device))
    return torch.cat(found), torch.cat(values)


def dense_datapath_step(tables: DenseTables, lpm: DenseLPM,
                        counters_packets: torch.Tensor,
                        counters_bytes: torch.Tensor, pkt_ep,
                        pkt_src_addr, pkt_dport, pkt_proto, pkt_dir,
                        pkt_len, *, segments: Optional[DenseSegments] = None):
    """Gather-free config-1 step: dense ipcache LPM -> dense 3-stage
    verdict (the CUDA kernel on a card) -> per-entry counters, added
    into in place.  Returns (verdict, identity, counters_packets,
    counters_bytes), the contract of ``datapath.pipeline.datapath_step``."""
    found, ident = dense_lpm_lookup(lpm, pkt_src_addr)
    world = torch.full((), WORLD_IDENTITY, dtype=torch.int32,
                       device=ident.device)
    identity = torch.where(found, ident, world)
    verdict, d_pk, d_by = dense_verdict(tables, pkt_ep, identity,
                                        pkt_dport, pkt_proto, pkt_dir,
                                        pkt_len, segments=segments)
    counters_packets.add_(d_pk)
    counters_bytes.add_(d_by)
    return verdict, identity, counters_packets, counters_bytes


class DenseVerdictEngine:
    """Host wrapper: compile states, run batches, keep counters."""

    def __init__(self, map_states: Sequence[PolicyMapState],
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tables = compile_dense(map_states, device=self.device)
        self.segments = dense_segments(self.tables)
        n = self.tables.ep.shape[0]
        self.counters_packets = torch.zeros(n, dtype=torch.int32,
                                            device=self.device)
        self.counters_bytes = torch.zeros(n, dtype=torch.int32,
                                          device=self.device)

    def __call__(self, pkt_ep, pkt_ident, pkt_dport, pkt_proto, pkt_dir,
                 pkt_len) -> torch.Tensor:
        def arr(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=self.device, dtype=torch.int32) \
                    .contiguous()
            return torch.as_tensor(np.asarray(x, np.int32),
                                   device=self.device)
        verdict, d_pk, d_by = dense_verdict(
            self.tables, arr(pkt_ep), arr(pkt_ident), arr(pkt_dport),
            arr(pkt_proto), arr(pkt_dir), arr(pkt_len),
            segments=self.segments)
        self.counters_packets.add_(d_pk)
        self.counters_bytes.add_(d_by)
        return verdict
