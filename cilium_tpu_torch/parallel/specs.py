"""Canonical shard-spec registry: every device-table leaf's logical
placement over the (dp, ep) mesh.

Port of ``cilium_tpu/parallel/specs.py`` over the port's own table
classes, with the port's ``PartitionSpec`` (``parallel/mesh.py``).  This
is the single source of truth for how the dataplane's device state
distributes across the mesh — the analog of the reference's
per-CPU/per-node map ownership rules.  Policy tables shard their
endpoint axis across ``ep``; the mutable per-shard state (conntrack,
flow aggregation, counters) is shard-LOCAL — logically stacked along
``ep``, physically resident only on its owning shard's column — and the
address-keyed lookup tables (ipcache, LB, prefilter, tunnel) are
replicated per shard because any shard's packets may reference any
address.  The port's CT state is one [8, N+2] tensor whose rows are the
reference's ``CTState`` fields (``conntrack.FIELDS``); it is registered
under that name, by row.

``tests/test_torch_sharding_lint.py`` holds the registry complete: a new
table leaf without a declared spec here is a test failure, not a silent
default-to-replicated.  ``PACKED_GROUP_SPECS`` declares the groups of
``parallel/packing.py``'s manifest; the port's engine keeps its tables
unpacked, so the packed buffers serve callers that want them.
"""

from __future__ import annotations

from typing import Dict, List, Type

from ..datapath.conntrack import FIELDS as CT_FIELDS
from .mesh import DP_AXIS, EP_AXIS, P

# shorthand specs (the logical layout over the FULL (dp, ep) mesh)
EP_ROWS = P(EP_AXIS, None)          # [E, S]: endpoint axis across ep
EP_VEC = P(EP_AXIS)                 # [E]: endpoint axis across ep
SHARD_LOCAL = P(EP_AXIS, None)      # logically [ep, ...]: one copy per
#                                     shard, resident on its column
REPLICATED = P()                    # every shard holds a full copy
BATCH = P(DP_AXIS)                  # [B] packet-batch leaves
PACKED_BATCH = P(None, DP_AXIS)     # [F, B] packed field matrices


# ---------------------------------------------------------------------------
# The registry: {table class name: {leaf path: PartitionSpec}}.
# Nested NamedTuples use dotted paths (FullTables.datapath.key_id ->
# "datapath.key_id").
# ---------------------------------------------------------------------------

DATAPATH_TABLES_SPECS: Dict[str, P] = {
    "key_id": EP_ROWS, "key_meta": EP_ROWS, "value": EP_ROWS,
    "lpm_masks": REPLICATED, "lpm_key_a": REPLICATED,
    "lpm_key_b": REPLICATED, "lpm_value": REPLICATED,
    "lpm_plens": REPLICATED,
}

LB_TABLES_SPECS: Dict[str, P] = {
    "svc_key_a": REPLICATED, "svc_key_b": REPLICATED,
    "svc_value": REPLICATED, "svc_count": REPLICATED,
    "svc_offset": REPLICATED, "svc_revnat": REPLICATED,
    "b_addr": REPLICATED, "b_port": REPLICATED,
    "rev_vip": REPLICATED, "rev_port": REPLICATED,
}

LPM6_TABLES_SPECS: Dict[str, P] = {
    "masks": REPLICATED, "k0": REPLICATED, "k1": REPLICATED,
    "k2": REPLICATED, "k3": REPLICATED, "kb": REPLICATED,
    "value": REPLICATED, "plens": REPLICATED,
}

LB6_TABLES_SPECS: Dict[str, P] = {
    "svc_k0": REPLICATED, "svc_k1": REPLICATED, "svc_k2": REPLICATED,
    "svc_k3": REPLICATED, "svc_kb": REPLICATED,
    "svc_value": REPLICATED, "svc_count": REPLICATED,
    "svc_offset": REPLICATED, "svc_revnat": REPLICATED,
    "b_addr": REPLICATED, "b_port": REPLICATED,
    "rev_vip": REPLICATED, "rev_port": REPLICATED,
}

# On-device L7 fast-verdict tables (l7/fast.py): the per-slot program
# classification shards with the policy rows it annotates; the fused
# DFA table set is replicated — any shard's packets may carry any
# payload (its packed dispatch-buffer group is "l7-dfa" below).
L7_FAST_SPECS: Dict[str, P] = {
    "l7_prog": EP_ROWS,
    "l7_flat": REPLICATED, "l7_map": REPLICATED,
    "l7_accept": REPLICATED, "l7_starts": REPLICATED,
    "l7_pmask": REPLICATED,
}

# Inline threat-scoring model (threat/model.py): the quantized scorer
# weights + threshold/mode config are replicated — every shard scores
# its own packets against the same model (its packed dispatch-buffer
# group is "threat-model" below, so a weight push is a region write).
THREAT_MODEL_SPECS: Dict[str, P] = {
    "tm_w1": REPLICATED, "tm_b1": REPLICATED, "tm_w2": REPLICATED,
    "tm_b2": REPLICATED, "tm_cfg": REPLICATED,
}

FULL_TABLES_SPECS: Dict[str, P] = {
    **{f"datapath.{k}": v for k, v in DATAPATH_TABLES_SPECS.items()},
    **{f"lb.{k}": v for k, v in LB_TABLES_SPECS.items()},
    "pf_masks": REPLICATED, "pf_key_a": REPLICATED,
    "pf_key_b": REPLICATED, "pf_value": REPLICATED,
    "pf_plens": REPLICATED,
    "tun_masks": REPLICATED, "tun_key_a": REPLICATED,
    "tun_key_b": REPLICATED, "tun_value": REPLICATED,
    "tun_plens": REPLICATED,
    "ep_identity": EP_VEC,
    **L7_FAST_SPECS,
    **THREAT_MODEL_SPECS,
}

FULL_TABLES6_SPECS: Dict[str, P] = {
    "key_id": EP_ROWS, "key_meta": EP_ROWS, "value": EP_ROWS,
    **{f"ipcache6.{k}": v for k, v in LPM6_TABLES_SPECS.items()},
    **{f"pf6.{k}": v for k, v in LPM6_TABLES_SPECS.items()},
    **{f"lb6.{k}": v for k, v in LB6_TABLES_SPECS.items()},
    "router_ip6": REPLICATED,
    "ep_identity": EP_VEC,
    **L7_FAST_SPECS,
    **THREAT_MODEL_SPECS,
}

# mutable per-shard state: every leaf lives on its owning shard alone
CT_STATE_SPECS: Dict[str, P] = {
    "k0": SHARD_LOCAL, "k1": SHARD_LOCAL, "k2": SHARD_LOCAL,
    "k3": SHARD_LOCAL, "expires": SHARD_LOCAL, "state": SHARD_LOCAL,
    "rev_nat": SHARD_LOCAL, "proxy_port": SHARD_LOCAL,
}

FLOW_STATE_SPECS: Dict[str, P] = {
    # two-leaf flow pack (hubble/aggregation.py FlowState): the keys
    # buffer carries the accounting row (lost/updates lanes), the
    # uint32 counters stay split along the dtype boundary
    "keys": SHARD_LOCAL, "counters": SHARD_LOCAL,
}

COUNTERS_SPECS: Dict[str, P] = {
    "packets": SHARD_LOCAL, "bytes": SHARD_LOCAL,
}

# the threat plane's mutable buffer (threat/stage.ThreatState): token
# buckets + claim-window aggregates are shard-local like the CT state
# — each shard rate-limits and windows its own endpoints' traffic
THREAT_STATE_SPECS: Dict[str, P] = {
    "state": SHARD_LOCAL,
}

# the traffic-analytics buffer (analytics/stage.AnalyticsState):
# sketches, key tables and cardinality registers are shard-local —
# each shard folds its own traffic, and the mesh-wide answer merges
# shards host-side (add sketches / max registers, decode.py)
ANALYTICS_STATE_SPECS: Dict[str, P] = {
    "state": SHARD_LOCAL,
}

# ---------------------------------------------------------------------------
# Packed dispatch-buffer groups of the reference's parallel/packing.py:
# the grouped flat buffers its jitted steps take.  Each group's spec is
# the distribution of the CONCATENATED buffer over the mesh — ep-grouped
# slices belong to one shard's column, replicated groups are copied per
# shard, and the mutable state packs are shard-local like the leaves
# they stack.  The port's steps take the tables unpacked;
# parallel/packing.py builds these groups for callers that want them.
# ---------------------------------------------------------------------------

PACKED_GROUP_SPECS: Dict[str, P] = {
    "ep-int32": P(EP_AXIS),        # stacked policy rows + slot
    #                                identities + l7_prog classification
    "rep-int32": P(),              # ipcache/LB/prefilter/tunnel copies
    "l7-dfa": P(),                 # fused L7 fast-verdict DFA table set
    #                                (l7/fast.py; its own group so the
    #                                no-L7 program keeps its exact
    #                                buffer list), replicated per shard
    "ct-state": SHARD_LOCAL,       # [8, N+1] conntrack pack (donated)
    "counters": SHARD_LOCAL,       # [2, E*S] counter pack (donated)
    "flow-state": SHARD_LOCAL,     # 2-leaf flow pack (NOT donated —
    #                                CPU XLA copies donated scatter
    #                                buffers; hubble/aggregation.py)
    "threat-model": P(),           # quantized scorer weights + config
    #                                (threat/model.py; its own group so
    #                                the no-threat program keeps its
    #                                exact buffer list and a weight
    #                                push is a region write, never a
    #                                repack), replicated per shard
    "threat-state": SHARD_LOCAL,   # [6, T+1] token-bucket/window
    #                                buffer (NOT donated, the
    #                                flow-state precedent)
    "analytics-state": SHARD_LOCAL,  # [R, W] sketch/register buffer
    #                                (NOT donated, the flow-state
    #                                precedent; analytics/stage.py)
}


class CTState:
    """The rows of the port's CT state tensor, by name (the reference's
    ``CTState`` NamedTuple fields)."""

    _fields = CT_FIELDS


def _table_classes():
    from ..datapath.lb import LB6Tables, LBTables
    from ..datapath.pipeline import (DatapathTables, FullTables,
                                     FullTables6, LPM6Tables)
    from ..datapath.verdict import Counters
    from ..analytics.stage import AnalyticsState
    from ..hubble.aggregation import FlowState
    from ..threat.stage import ThreatState
    return {
        DatapathTables: DATAPATH_TABLES_SPECS,
        LBTables: LB_TABLES_SPECS,
        LPM6Tables: LPM6_TABLES_SPECS,
        LB6Tables: LB6_TABLES_SPECS,
        FullTables: FULL_TABLES_SPECS,
        FullTables6: FULL_TABLES6_SPECS,
        CTState: CT_STATE_SPECS,
        FlowState: FLOW_STATE_SPECS,
        Counters: COUNTERS_SPECS,
        ThreatState: THREAT_STATE_SPECS,
        AnalyticsState: ANALYTICS_STATE_SPECS,
    }


def leaf_paths(cls: Type, nested: Dict[str, Type]) -> List[str]:
    """Dotted leaf paths of a NamedTuple table class, recursing into
    fields named in ``nested`` (field name -> NamedTuple class)."""
    out: List[str] = []
    for field in cls._fields:
        sub = nested.get(field)
        if sub is not None:
            out.extend(f"{field}.{p}"
                       for p in leaf_paths(sub, nested))
        else:
            out.append(field)
    return out


def registry() -> Dict[str, Dict[str, P]]:
    """{table class name: specs} for every registered device table."""
    return {cls.__name__: specs
            for cls, specs in _table_classes().items()}


def missing_specs() -> Dict[str, List[str]]:
    """Leaves present on a registered table class but absent from its
    spec table (the sharding lint's subject — must be empty)."""
    from ..datapath.lb import LB6Tables, LBTables
    from ..datapath.pipeline import DatapathTables, LPM6Tables
    nested_by_cls = {
        "FullTables": {"datapath": DatapathTables, "lb": LBTables},
        "FullTables6": {"ipcache6": LPM6Tables, "pf6": LPM6Tables,
                        "lb6": LB6Tables},
    }
    out: Dict[str, List[str]] = {}
    for cls, specs in _table_classes().items():
        nested = nested_by_cls.get(cls.__name__, {})
        missing = [p for p in leaf_paths(cls, nested) if p not in specs]
        if missing:
            out[cls.__name__] = missing
    return out
