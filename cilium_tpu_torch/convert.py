"""Carry the JAX package's device state across into the port.

The reference keeps its state as JAX arrays.  Its caller hands each
structure over as ``{field: np.asarray(leaf)}`` (NamedTuple field names
of ``DatapathTables``, ``Counters``, ``DenseTables``, ``DenseLPM``) and
gets the port's structures on ``device``.  Leaves must be 32-bit
integers; uint32 leaves (the counters) become int32 views of the same
bits.  The engine's packed counters ([2, E*S] uint32) and conntrack
snapshots (the per-field npz layout) have their own hand-overs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Type

import numpy as np
import torch

from .datapath.conntrack import ConntrackTable
from .datapath.pipeline import DatapathTables
from .datapath.verdict import Counters
from .device import DeviceLike, resolve_device
from .ops.dense_verdict import DenseLPM, DenseTables

Leaves = Optional[Dict[str, np.ndarray]]


class PortState(NamedTuple):
    """The port's structures; a field is None when not handed over."""

    tables: Optional[DatapathTables]
    counters: Optional[Counters]
    dense: Optional[DenseTables]
    dense_lpm: Optional[DenseLPM]
    policy_probe: int
    lpm_probe: int


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
                    policy_probe: int = 1, lpm_probe: int = 1,
                    device: DeviceLike = None) -> PortState:
    """Numpy leaves of the reference's state -> the port's tables on
    ``device``.  ``policy_probe``/``lpm_probe`` are the ``max_probe``
    of the compiled policy and LPM that the hash step needs."""
    dev = resolve_device(device)
    return PortState(tables=_to_port(DatapathTables, tables, dev),
                     counters=_to_port(Counters, counters, dev),
                     dense=_to_port(DenseTables, dense, dev),
                     dense_lpm=_to_port(DenseLPM, dense_lpm, dev),
                     policy_probe=policy_probe, lpm_probe=lpm_probe)


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
