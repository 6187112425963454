"""Hubble flow observability.

    aggregation — the device-resident flow table updated inside the v4
                  and v6 steps (torch)
    flow        — FlowRecord and the bounded host ring with monotonic
                  sequence cursors
    filter      — the observe filter grammar (identity, verdict, drop
                  reason, port, proto, L7, since)
    observer    — one node's queryable flow view and flow metrics
    relay       — federated get_flows fan-out with per-peer deadlines and
                  circuit breakers
    federation  — the cross-shard tier on sharded daemons: per-shard
                  flow stores behind one shared cursor, per-shard
                  device-table drains, and shard-attributed merged
                  answers with fail-open degradation flags
"""

from .aggregation import (FlowState, FlowTable, aggregate_oracle,
                          flow_update_step, make_flow_state,
                          snapshot_to_oracle_form)
from .filter import FlowFilter, parse_drop_reason, parse_proto, parse_verdict
from .flow import (FlowRecord, FlowStore, flow_from_access_log,
                   flow_from_dict, flow_from_event, verdict_of_event)
from .federation import ShardedObserver
from .observer import FlowObserver
from .relay import HubbleRelay, rest_peer

__all__ = [
    "FlowState", "FlowTable", "aggregate_oracle", "flow_update_step",
    "make_flow_state", "snapshot_to_oracle_form",
    "FlowFilter", "parse_drop_reason", "parse_proto", "parse_verdict",
    "FlowRecord", "FlowStore", "flow_from_access_log", "flow_from_dict",
    "flow_from_event", "verdict_of_event",
    "FlowObserver", "HubbleRelay", "rest_peer", "ShardedObserver",
]
