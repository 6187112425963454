"""The device mesh and its canonical placements, over torch devices.

Port of ``cilium_tpu/parallel/mesh.py``.  A ``Mesh`` is a (dp, ep) grid
of ``torch.device``s from an explicit device list: column ``k`` holds
ep-shard ``k``, and a shard's engine keeps every table and all of its
state on its column's first device, where its step runs whole.  On one
card the shards share it (``devices=[cuda:0] * 4``); the tests run them
on ``cpu``.  The list may repeat a device, so a shard count does not
need as many cards.

A placement is a ``NamedSharding(mesh, spec)``: the reference's
PartitionSpec over the mesh axes, kept as a description (the
registry's, ``parallel/specs.py``).  ``shard_batch`` splits [B]-leading
tensors into ``dp`` chunks, one on each row's first device, and leaves
every other tensor whole on the mesh's first device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

DP_AXIS = "dp"   # packet-batch data parallelism
EP_AXIS = "ep"   # endpoint-table sharding (model-parallel analog)


class PartitionSpec(tuple):
    """The per-dimension mesh axes of a placement (None: not split);
    equal to the reference's ``jax.sharding.PartitionSpec`` of the same
    axes as a tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """A (dp, ep) grid of torch devices."""

    def __init__(self, devices: np.ndarray,
                 axis_names=(DP_AXIS, EP_AXIS)):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError(f"mesh devices must be [dp, ep], got "
                             f"{self.devices.shape}")
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


class NamedSharding(NamedTuple):
    """A placement over a mesh: how a tensor of this role spreads."""

    mesh: Mesh
    spec: PartitionSpec


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, ep_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, ep) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device).

    ``ep_parallel`` splits devices between batch parallelism and endpoint
    table sharding; default keeps everything on the dp axis.  Asking for
    more devices than exist is an error, never a silent
    under-provision: a dataplane that believes it spans N fault domains
    but actually spans fewer would mis-scope every per-shard decision.
    """
    avail = [torch.device(d) for d in devices] if devices is not None \
        else cuda_devices()
    if n_devices is not None and n_devices > len(avail):
        raise ValueError(
            f"requested {n_devices} devices but only {len(avail)} "
            f"available")
    devs = avail[:n_devices] if n_devices else avail
    n = len(devs)
    if n == 0:
        raise ValueError("no devices available for the mesh (no CUDA "
                         "device; pass devices=[...] to name them)")
    if ep_parallel < 1 or n % ep_parallel != 0:
        raise ValueError(f"{n} devices not divisible by ep={ep_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // ep_parallel, ep_parallel))


def ep_submesh(mesh: Mesh, shard: int) -> Mesh:
    """Shard ``shard``'s (dp, 1) column submesh: the devices that hold
    that shard's endpoint-table slice.  Each shard's engine runs on its
    own column, so a fault in one shard's lane is a single-shard fault
    domain, not a whole-mesh outage."""
    n_ep = mesh.devices.shape[1]
    if not 0 <= shard < n_ep:
        raise ValueError(f"shard {shard} out of range for ep={n_ep}")
    return Mesh(mesh.devices[:, shard:shard + 1], mesh.axis_names)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, ...] tensors: shard the batch across dp, replicate across ep."""
    return NamedSharding(mesh, P(DP_AXIS))


def packed_batch_sharding(mesh: Mesh) -> NamedSharding:
    """[F, B] packed field matrices (pipeline.PACKED_FIELDS rows):
    shard the batch axis (axis 1) across dp."""
    return NamedSharding(mesh, P(None, DP_AXIS))


def table_sharding(mesh: Mesh) -> NamedSharding:
    """[E, S] policy tables: shard the endpoint axis across ep."""
    return NamedSharding(mesh, P(EP_AXIS, None))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class BatchShards(tuple):
    """A [B]-leading tensor split along B into ``dp`` chunks, chunk i
    on the first device of mesh row i (``shard_batch``)."""

    spec = P(DP_AXIS)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, tree, batch: Optional[int] = None):
    """Split [B]-leading tensors across dp, everything else whole.

    ``batch`` names B explicitly; when omitted it is inferred from the
    first tensor leaf's leading dimension.  Only tensors whose leading
    dimension equals B (and divides evenly across dp) are split, into a
    ``BatchShards`` of ``dp`` chunks — scalars, tables and oddly-shaped
    leaves go whole onto the mesh's first device instead of being sliced
    along the wrong axis.
    """
    leaves = [x for x in _tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.ndim >= 1]
    if batch is None:
        if not leaves:
            return tree
        batch = int(leaves[0].shape[0])
    dp = mesh.devices.shape[0]
    rows = [mesh.devices[i, 0] for i in range(dp)]
    first = mesh.devices[0, 0]

    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim >= 1 and int(x.shape[0]) == batch and batch % dp == 0:
            step = batch // dp
            return BatchShards(x[i * step:(i + 1) * step].to(rows[i])
                               for i in range(dp))
        return x.to(first)
    return _tree_map(place, tree)
