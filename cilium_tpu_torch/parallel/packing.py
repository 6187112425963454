"""The packing manifest: the table leaves grouped into a handful of
flat device buffers.

Port of ``cilium_tpu/parallel/packing.py``.  The reference packs the
``FullTables`` / ``FullTables6`` leaves into concatenated flat buffers,
grouped by (sharding class, dtype) from the canonical spec registry
(``parallel/specs.py``), so that its jitted steps take a few buffers
instead of about forty leaves, and rebuilds the per-leaf views inside the
program from static offsets.

Groups:

* ``ep-<dtype>``  — endpoint-axis-sharded leaves (the stacked policy
  tables + per-slot identities).
* ``rep-<dtype>`` — replicated address-keyed leaves (ipcache/LPM, LB,
  prefilter, tunnel).
* ``l7-dfa`` / ``threat-model`` — the optional stages' tables, each in
  its own group.
* ``ct-state`` / ``counters`` / ``flow-state`` / ``threat-state`` /
  ``analytics-state`` — the engine-owned mutable state, not
  manifest-built (names only, held by ``specs.PACKED_GROUP_SPECS``).

In PyTorch the idiom differs from the reference's jitted functional
form: ``unpacker`` returns **views** into the group buffers
(``buf[off:off + size].view(shape)``, no copy), the row writers write
in place with ``index_copy_``, and ``write_leaf`` writes the leaf's
region in place.  The manifest itself (group names, dtypes, offsets,
shapes) equals the reference's for the same tables: a group's dtype is
named through ``DTYPE_NAMES`` (numpy's names, which JAX uses), so a
torch ``int32`` leaf lands in ``ep-int32`` / ``rep-int32`` as it does
there.  The engine keeps its unpacked tables; the manifest and views are
for callers that want static buffers (a captured step).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

# the engine-owned mutable state packs (not manifest-built, but part
# of the same lint-enforced group namespace)
CT_STATE_GROUP = "ct-state"
COUNTERS_GROUP = "counters"
# the two-leaf Hubble flow pack (hubble/aggregation.py FlowState):
# keys buffer carries the lost/updates accounting row, counters stay
# their own uint32 buffer along the dtype boundary
FLOW_STATE_GROUP = "flow-state"
# the fused L7 fast-verdict DFA table set (l7/fast.py) packs into its
# OWN group instead of riding rep-int32: a no-L7 engine then builds
# the exact pre-fast buffer list, keeping that program byte-identical
# at the pinned leaf ceiling (the per-slot l7_prog classification
# shards with the policy rows and stays in ep-int32)
L7_DFA_GROUP = "l7-dfa"
_L7_DFA_LEAVES = frozenset(
    ("l7_flat", "l7_map", "l7_accept", "l7_starts", "l7_pmask"))
# the inline threat-scoring model (threat/model.py) packs into its OWN
# group for the same reason: a no-threat engine builds the exact
# pre-threat buffer list, and a weight push / threshold flip is a
# region write into this one buffer (engine apply_threat_weights /
# set_threat_config), never a repack
THREAT_MODEL_GROUP = "threat-model"
_THREAT_MODEL_LEAVES = frozenset(
    ("tm_w1", "tm_b1", "tm_w2", "tm_b2", "tm_cfg"))
# the engine-owned mutable threat buffer (threat/stage.ThreatState):
# not manifest-built, same lint-enforced group namespace as ct-state
THREAT_STATE_GROUP = "threat-state"
# the engine-owned traffic-analytics buffer (analytics/stage.
# AnalyticsState): sketches + key tables + cardinality registers as
# one [R, W] int32 leaf — not manifest-built, same lint-enforced
# group namespace as ct-state/threat-state
ANALYTICS_STATE_GROUP = "analytics-state"


# torch dtype -> the reference's dtype name, for the dtypes the
# manifests hold: every manifest-built leaf of either package is int32
# (uint32 data is held as wrapping int32 in the port, and the counters
# live in the engine-owned packs).  A leaf of another dtype is refused
# until it is added here with its reference name.
DTYPE_NAMES: Dict[torch.dtype, str] = {torch.int32: "int32"}


def dtype_name(t: torch.Tensor) -> str:
    """The reference's name for a leaf's dtype (KeyError on a dtype
    the table does not map)."""
    return DTYPE_NAMES[t.dtype]


class LeafSlot(NamedTuple):
    """One table leaf's view into its group buffer."""

    path: str                 # dotted leaf path (specs.py convention)
    group: str                # owning group buffer name
    offset: int               # flat element offset inside the group
    size: int                 # element count
    shape: Tuple[int, ...]    # view shape


class GroupSpec(NamedTuple):
    name: str                 # "<class>-<dtype>", e.g. "ep-int32"
    dtype: str
    size: int                 # total flat elements


class PackManifest(NamedTuple):
    """Static packing layout for one table class instance.  Pure
    tuples: hashable and comparable, so geometry changes are detected
    by manifest inequality."""

    cls_name: str
    leaves: Tuple[LeafSlot, ...]
    groups: Tuple[GroupSpec, ...]

    def group_names(self) -> Tuple[str, ...]:
        return tuple(g.name for g in self.groups)

    def leaf_count(self) -> int:
        return len(self.leaves)

    def leaf(self, path: str) -> Optional[LeafSlot]:
        for l in self.leaves:
            if l.path == path:
                return l
        return None


def _classes():
    from ..datapath.pipeline import FullTables, FullTables6
    return {"FullTables": FullTables, "FullTables6": FullTables6}


def _nested_for(cls_name: str) -> Dict[str, type]:
    from ..datapath.lb import LB6Tables, LBTables
    from ..datapath.pipeline import DatapathTables, LPM6Tables
    return {
        "FullTables": {"datapath": DatapathTables, "lb": LBTables},
        "FullTables6": {"ipcache6": LPM6Tables, "pf6": LPM6Tables,
                        "lb6": LB6Tables},
    }.get(cls_name, {})


def _walk(obj, prefix: str = ""):
    """(dotted path, tensor) for every present (non-None) leaf, in
    field-declaration order — the stable packing order."""
    for f in type(obj)._fields:
        v = getattr(obj, f)
        if v is None:
            continue
        if hasattr(v, "_fields"):
            yield from _walk(v, prefix + f + ".")
        else:
            yield prefix + f, v


def _sharding_class(spec) -> str:
    """ep (endpoint-axis sharded) vs rep (replicated): any mesh axis
    in the declared spec means the leaf's rows belong to one shard."""
    for axis in spec:
        if axis is not None:
            return "ep"
    return "rep"


def build_manifest(tables) -> PackManifest:
    """Packing manifest for one table instance, grouped by (declared
    sharding class, dtype) from the canonical spec registry.  A leaf
    without a registry entry is an error here exactly like it is in
    the sharding lint — new leaves must declare their distribution."""
    from . import specs
    cls_name = type(tables).__name__
    spec_table = specs.registry()[cls_name]
    leaves: List[LeafSlot] = []
    offsets: Dict[str, int] = {}
    dtypes: Dict[str, str] = {}
    for path, arr in _walk(tables):
        spec = spec_table[path]
        dt = dtype_name(arr)
        if path in _L7_DFA_LEAVES:
            group = L7_DFA_GROUP
        elif path in _THREAT_MODEL_LEAVES:
            group = THREAT_MODEL_GROUP
        else:
            group = f"{_sharding_class(spec)}-{dt}"
        off = offsets.get(group, 0)
        size = int(arr.numel())
        leaves.append(LeafSlot(path=path, group=group, offset=off,
                               size=size, shape=tuple(arr.shape)))
        offsets[group] = off + size
        dtypes[group] = dt
    groups = tuple(GroupSpec(name=g, dtype=dtypes[g], size=offsets[g])
                   for g in offsets)
    return PackManifest(cls_name=cls_name, leaves=tuple(leaves),
                        groups=groups)


def pack_groups(tables, manifest: PackManifest
                ) -> Tuple[torch.Tensor, ...]:
    """Concatenate the leaves into their group buffers, on the leaves'
    device (control-plane cost, paid once per table generation).  Every
    buffer is a new allocation, never a view of a leaf, so writes into
    it leave the tables it was packed from as they were.  Returns
    buffers ordered like ``manifest.groups``."""
    vals = dict(_walk(tables))
    out = []
    for g in manifest.groups:
        parts = [vals[l.path].reshape(-1)
                 for l in manifest.leaves if l.group == g.name]
        out.append(torch.cat(parts))
    return tuple(out)


def unpacker(manifest: PackManifest
             ) -> Callable[[Tuple[torch.Tensor, ...]], object]:
    """Closure rebuilding the table NamedTuple from the group buffers:
    every leaf a view ``buf[offset:offset + size].view(shape)`` sharing
    the buffer's memory (no copy), so a write into a buffer shows in
    the tables built from it."""
    cls = _classes()[manifest.cls_name]
    nested = _nested_for(manifest.cls_name)
    names = manifest.group_names()

    def unpack(bufs: Tuple[torch.Tensor, ...]):
        by_group = dict(zip(names, bufs))
        vals = {l.path: by_group[l.group][l.offset:l.offset + l.size]
                .view(l.shape) for l in manifest.leaves}
        kwargs = {}
        for f in cls._fields:
            sub_cls = nested.get(f)
            if sub_cls is not None:
                pref = f + "."
                sub = {p[len(pref):]: v for p, v in vals.items()
                       if p.startswith(pref)}
                kwargs[f] = sub_cls(**sub) if sub else None
            else:
                kwargs[f] = vals.get(f)
        return cls(**kwargs)

    return unpack


# ---------------------------------------------------------------------------
# Delta-apply write-through: endpoint rows written into the packed
# policy slices in place, no repack.
# ---------------------------------------------------------------------------

_POLICY_ROWS = {  # canonical name -> leaf path per table class
    "FullTables": ("datapath.key_id", "datapath.key_meta",
                   "datapath.value"),
    "FullTables6": ("key_id", "key_meta", "value"),
}


def _row_index(offs: Tuple[int, ...], n_slots: int,
               slots: torch.Tensor) -> torch.Tensor:
    """Flat buffer indices of rows ``slots`` of the [E, n_slots] leaves
    at ``offs``, leaf by leaf (int64, on the slots' device)."""
    col = torch.arange(n_slots, dtype=torch.int64,
                       device=slots.device)[None, :]
    base = slots.to(torch.int64)[:, None] * n_slots + col
    return torch.cat([(o + base).reshape(-1) for o in offs])


def make_policy_row_writer(manifest: PackManifest):
    """(writer, group index) realizing dirty endpoint rows in the
    packed policy slices: ``writer(buf, slots [D], kid [D, S],
    kmeta [D, S], kval [D, S]) -> buf``, written in place by one
    ``index_copy_`` over all three regions; the single-rule delta
    stays a row write, never a repack."""
    paths = _POLICY_ROWS[manifest.cls_name]
    slots_ = [manifest.leaf(p) for p in paths]
    if any(l is None for l in slots_):
        raise KeyError(f"policy rows missing from {manifest.cls_name} "
                       "manifest")
    group = slots_[0].group
    if any(l.group != group for l in slots_):
        raise ValueError("policy row leaves split across groups")
    gidx = manifest.group_names().index(group)
    offs = tuple(l.offset for l in slots_)
    n_slots = slots_[0].shape[1]

    def write(buf, slots, kid, kmeta, kval):
        idx = _row_index(offs, n_slots, slots)
        vals = torch.cat([kid.reshape(-1), kmeta.reshape(-1),
                          kval.reshape(-1)]).to(buf.dtype)
        return buf.index_copy_(0, idx, vals)

    return write, gidx


def make_l7_prog_row_writer(manifest: PackManifest):
    """Row writer for the per-slot L7 classification table: the
    delta-apply twin of :func:`make_policy_row_writer` for the
    ``l7_prog`` leaf, ``writer(buf, slots [D], rows [D, S]) -> buf`` in
    place.  Returns None when the manifest carries no l7_prog leaf
    (fast verdicts disabled)."""
    leaf = manifest.leaf("l7_prog")
    if leaf is None:
        return None
    gidx = manifest.group_names().index(leaf.group)
    off = leaf.offset
    n_slots = leaf.shape[1]

    def write(buf, slots, rows):
        idx = _row_index((off,), n_slots, slots)
        return buf.index_copy_(0, idx, rows.reshape(-1).to(buf.dtype))

    return write, gidx


def write_leaf(manifest: PackManifest, bufs: Tuple[torch.Tensor, ...],
               path: str, arr) -> Optional[Tuple[torch.Tensor, ...]]:
    """Write one whole leaf's region into its group buffer, in place.
    Returns the buffer tuple, or None when the leaf is absent from the
    manifest or its shape changed — the caller must rebuild (a
    geometry change re-packs)."""
    leaf = manifest.leaf(path)
    if leaf is None or tuple(arr.shape) != leaf.shape:
        return None
    gidx = manifest.group_names().index(leaf.group)
    buf = bufs[gidx]
    src = torch.as_tensor(arr).to(device=buf.device, dtype=buf.dtype)
    buf[leaf.offset:leaf.offset + leaf.size].copy_(src.reshape(-1))
    return tuple(bufs)
