"""Carry the JAX package's device state across into the port.

The reference keeps its state as JAX arrays.  Its caller hands each
structure over as ``{field: np.asarray(leaf)}`` (NamedTuple field names
of ``DatapathTables``, ``Counters``, ``DenseTables``, ``DenseLPM``,
``LPM6Tables``, ``LB6Tables``) and gets the port's structures on
``device``.  Leaves must be 32-bit integers; uint32 leaves (the
counters) become int32 views of the same bits.  The engine's packed
counters ([2, E*S] uint32), conntrack snapshots (the per-field npz
layout), the Hubble flow table, the bucket engine's counters, a
compiled regex set, the L7 fast-verdict programs, the threat model and
the threat and analytics state buffers have their own hand-overs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from .analytics.stage import AnalyticsState
from .compiler.regexc import CompiledRegexSet
from .datapath.conntrack import ConntrackTable
from .datapath.lb import LB6Tables
from .datapath.pipeline import DatapathTables, LPM6Tables
from .datapath.verdict import Counters
from .device import DeviceLike, resolve_device
from .hubble.aggregation import FlowState
from .l7.fast import FastProgramSpec, L7FastPrograms
from .ops.bucket_ops import BucketCounters
from .ops.dense_verdict import DenseLPM, DenseTables
from .threat.model import ThreatConfig, ThreatModel
from .threat.stage import STATE_COLS, ThreatState

Leaves = Optional[Dict[str, np.ndarray]]


class PortState(NamedTuple):
    """The port's structures; a field is None when not handed over."""

    tables: Optional[DatapathTables]
    counters: Optional[Counters]
    dense: Optional[DenseTables]
    dense_lpm: Optional[DenseLPM]
    policy_probe: int
    lpm_probe: int
    lpm6: Optional[LPM6Tables] = None
    lb6: Optional[LB6Tables] = None


def _to_port(cls: Type[NamedTuple], leaves: Leaves, dev: torch.device):
    if leaves is None:
        return None
    if set(leaves) != set(cls._fields):
        raise ValueError(f"{cls.__name__} needs fields {cls._fields}, "
                         f"got {sorted(leaves)}")
    out = {}
    for field in cls._fields:
        arr = np.ascontiguousarray(leaves[field])
        if arr.dtype not in (np.int32, np.uint32):
            raise ValueError(f"{cls.__name__}.{field}: expected int32 or "
                             f"uint32, got {arr.dtype}")
        out[field] = torch.as_tensor(arr.view(np.int32).copy(), device=dev)
    return cls(**out)


def from_jax_arrays(*, tables: Leaves = None, counters: Leaves = None,
                    dense: Leaves = None, dense_lpm: Leaves = None,
                    lpm6: Leaves = None, lb6: Leaves = None,
                    policy_probe: int = 1, lpm_probe: int = 1,
                    device: DeviceLike = None) -> PortState:
    """Numpy leaves of the reference's state -> the port's tables on
    ``device``.  ``policy_probe``/``lpm_probe`` are the ``max_probe``
    of the compiled policy and LPM that the hash step needs; ``lpm6``
    and ``lb6`` take a v6 LPM's and the lb6 tables' leaves."""
    dev = resolve_device(device)
    return PortState(tables=_to_port(DatapathTables, tables, dev),
                     counters=_to_port(Counters, counters, dev),
                     dense=_to_port(DenseTables, dense, dev),
                     dense_lpm=_to_port(DenseLPM, dense_lpm, dev),
                     policy_probe=policy_probe, lpm_probe=lpm_probe,
                     lpm6=_to_port(LPM6Tables, lpm6, dev),
                     lb6=_to_port(LB6Tables, lb6, dev))


def counters_from_pack(pack: np.ndarray, device: DeviceLike = None
                       ) -> torch.Tensor:
    """The reference engine's packed counters ([2, E*S] uint32: row 0
    packets, row 1 bytes) -> the port engine's [2, E*S] int32 buffer
    of the same bits on ``device``."""
    arr = np.ascontiguousarray(pack)
    if arr.ndim != 2 or arr.shape[0] != 2 or \
            arr.dtype not in (np.int32, np.uint32):
        raise ValueError(f"expected a [2, n] 32-bit counter pack, got "
                         f"{arr.dtype} {arr.shape}")
    return torch.as_tensor(arr.view(np.int32).copy(),
                           device=resolve_device(device))


def conntrack_from_snapshot(arrays: Dict[str, np.ndarray],
                            max_probe: int = 8,
                            device: DeviceLike = None) -> ConntrackTable:
    """A port ``ConntrackTable`` holding a reference CT snapshot (the
    per-field [N+1] arrays plus ``slots``, as ``ConntrackTable.snapshot``
    of either package writes it)."""
    table = ConntrackTable(slots=int(np.asarray(arrays["slots"])[0]),
                           max_probe=max_probe, device=device)
    table.restore_snapshot(arrays)
    return table


def flows_from_jax(keys: np.ndarray, counters: np.ndarray,
                   device: DeviceLike = None) -> FlowState:
    """The reference's ``FlowState`` (keys [N+2, 4] int32, counters
    [N+1, 2] uint32, as numpy arrays) -> the port's on ``device``."""
    keys = np.ascontiguousarray(keys)
    counters = np.ascontiguousarray(counters)
    n = keys.shape[0] - 2
    if keys.shape != (n + 2, 4) or counters.shape != (n + 1, 2) or \
            keys.dtype != np.int32 or \
            counters.dtype not in (np.int32, np.uint32):
        raise ValueError(f"expected keys [N+2, 4] int32 and counters "
                         f"[N+1, 2] 32-bit, got {keys.dtype} {keys.shape}"
                         f" and {counters.dtype} {counters.shape}")
    dev = resolve_device(device)
    return FlowState(keys=torch.as_tensor(keys.copy(), device=dev),
                     counters=torch.as_tensor(
                         counters.view(np.int32).copy(), device=dev))


def flows_to_jax(state: FlowState) -> Tuple[np.ndarray, np.ndarray]:
    """The port's ``FlowState`` -> (keys int32, counters uint32) numpy
    arrays in the reference's layout."""
    return (state.keys.cpu().numpy().copy(),
            state.counters.cpu().numpy().view(np.uint32).copy())


def bucket_counters_from_jax(packets: np.ndarray, bytes_: np.ndarray,
                             device: DeviceLike = None) -> BucketCounters:
    """The reference bucket engine's counters ([E*NB*W] uint32 each, as
    numpy arrays) -> the port's wrapping int32 counters on ``device``."""
    dev = resolve_device(device)
    out = []
    for name, arr in (("packets", packets), ("bytes", bytes_)):
        arr = np.ascontiguousarray(arr)
        if arr.ndim != 1 or arr.dtype not in (np.int32, np.uint32):
            raise ValueError(f"{name}: expected a 1-D 32-bit array, got "
                             f"{arr.dtype} {arr.shape}")
        out.append(torch.as_tensor(arr.view(np.int32).copy(), device=dev))
    return BucketCounters(*out)


def bucket_counters_to_jax(counters: BucketCounters
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The port's bucket counters -> (packets, bytes) uint32 numpy
    arrays, the reference's layout."""
    return tuple(c.cpu().numpy().view(np.uint32).copy() for c in counters)


def compiled_regex_from_jax(table: np.ndarray, accept: np.ndarray,
                            starts: np.ndarray,
                            patterns: Tuple[str, ...] = ()
                            ) -> CompiledRegexSet:
    """The reference's compiled regex set (``table`` [S, 256] int32,
    ``accept`` [S] bool, ``starts`` [R] int32) -> the port's, so that
    one package's tables can feed the other's engines."""
    table = np.ascontiguousarray(table, np.int32)
    accept = np.ascontiguousarray(accept, bool)
    starts = np.ascontiguousarray(starts, np.int32)
    if table.ndim != 2 or table.shape[1] != 256 or \
            accept.shape != (table.shape[0],) or starts.ndim != 1:
        raise ValueError(f"expected table [S, 256], accept [S], starts "
                         f"[R]; got {table.shape}, {accept.shape}, "
                         f"{starts.shape}")
    return CompiledRegexSet(table=table, accept=accept, starts=starts,
                            num_states=table.shape[0],
                            patterns=tuple(patterns))


def l7_programs_from_jax(progs) -> L7FastPrograms:
    """The reference's ``L7FastPrograms`` (read by attribute: its numpy
    arrays, stride, classes, window and program map) -> the port's, so
    that both packages walk the same fused tables."""
    arrays = {f: np.ascontiguousarray(getattr(progs, f), np.int32)
              for f in ("flat", "cmap", "accept", "starts", "pmask")}
    specs = tuple(FastProgramSpec(port=int(sp.port), protocol=sp.protocol,
                                  patterns=tuple(sp.patterns))
                  for sp in getattr(progs, "specs", ()))
    return L7FastPrograms(
        **arrays, k=int(progs.k), c1=int(progs.c1),
        window=int(progs.window),
        port_to_prog={int(p): int(i)
                      for p, i in progs.port_to_prog.items()},
        protocols=tuple(progs.protocols), states=int(progs.states),
        specs=specs)


def threat_model_from_tables(tables: Dict[str, np.ndarray]
                             ) -> ThreatModel:
    """A ``ThreatModel.tables()`` dict of either package (tm_w1, tm_b1,
    tm_w2, tm_b2, tm_cfg) -> the port's model with those weights and
    that config."""
    return ThreatModel(w1=np.asarray(tables["tm_w1"]),
                       b1=np.asarray(tables["tm_b1"]),
                       w2=np.asarray(tables["tm_w2"]),
                       b2=int(np.asarray(tables["tm_b2"]).reshape(-1)[0]),
                       config=ThreatConfig.decode(tables["tm_cfg"]))


def _state_buffer(arr: np.ndarray, cols: Optional[int], name: str,
                  device: DeviceLike) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 2 or arr.dtype != np.int32 or \
            (cols is not None and arr.shape[1] != cols):
        raise ValueError(f"{name}: expected a 2-D int32 buffer"
                         f"{'' if cols is None else f' of {cols} columns'}"
                         f", got {arr.dtype} {arr.shape}")
    return torch.as_tensor(arr.copy(), device=resolve_device(device))


def threat_state_from_jax(state: np.ndarray, device: DeviceLike = None
                          ) -> ThreatState:
    """The reference's ThreatState buffer ([T+1, 6] int32) -> the
    port's on ``device``."""
    return ThreatState(state=_state_buffer(state, STATE_COLS,
                                           "threat state", device))


def threat_state_to_jax(state: ThreatState) -> np.ndarray:
    return state.state.cpu().numpy().copy()


def analytics_state_from_jax(state: np.ndarray, device: DeviceLike = None
                             ) -> AnalyticsState:
    """The reference's AnalyticsState buffer ([R, W] int32) -> the
    port's on ``device``."""
    return AnalyticsState(state=_state_buffer(state, None,
                                              "analytics state", device))


def analytics_state_to_jax(state: AnalyticsState) -> np.ndarray:
    return state.state.cpu().numpy().copy()
