"""The Hubble observer: one node's queryable flow view.

Reference: pkg/hubble/observer — the observer server owns the flow
ring, answers GetFlows with filters, and feeds the flow-derived
metrics.  Here the observer subscribes to the two local event sources
(the monitor hub's sampled datapath events and the proxy access log),
converts them to FlowRecords in the bounded store, keeps the
flow-derived metric series current, and exposes the on-device
aggregation table's compact state.

A whole copy of ``cilium_tpu/hubble/observer.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..utils.metrics import (HUBBLE_DNS_RESPONSES, HUBBLE_DROPS,
                             HUBBLE_FLOWS_LOST, HUBBLE_FLOWS_PROCESSED,
                             HUBBLE_HTTP_RESPONSES)
from .filter import FlowFilter
from .flow import (FlowRecord, FlowStore, flow_from_access_log,
                   flow_from_event)


class FlowObserver:
    """Local observer: store + metrics + aggregation-table view."""

    def __init__(self, node: str = "node-local",
                 capacity: int = 8192, datapath=None,
                 seq_source=None):
        self.node = node
        self.store = FlowStore(capacity=capacity,
                               seq_source=seq_source)
        self.datapath = datapath
        self._lock = threading.Lock()
        self._unsubs: List[Callable] = []
        self._followers: List[Callable[[FlowRecord], None]] = []

    @property
    def last_seq(self) -> int:
        """Newest assigned flow cursor (the REST paging anchor)."""
        return self.store.last_seq

    # -------------------------------------------------------- ingestion

    def attach_monitor(self, hub) -> None:
        """Subscribe to the monitor hub: sampled datapath events become
        flows (L7 enters via attach_access_log with full structure, so
        the hub's flattened kind="l7" notes are skipped here)."""
        self._unsubs.append(hub.subscribe(self._on_monitor_event))

    def attach_access_log(self, access_log) -> None:
        """Subscribe to the proxy access log (structured L7 records)."""
        access_log.subscribers.append(self._on_access_log)

        def unsub():
            if self._on_access_log in access_log.subscribers:
                access_log.subscribers.remove(self._on_access_log)
        self._unsubs.append(unsub)

    def _on_monitor_event(self, ev) -> None:
        if ev.kind != "":
            return
        self.ingest(flow_from_event(ev, self.node))

    def _on_access_log(self, entry) -> None:
        self.ingest(flow_from_access_log(entry, self.node))

    def ingest(self, record: FlowRecord) -> FlowRecord:
        """Ring one flow record + update the flow-derived series."""
        stamped = self.store.add(record)
        HUBBLE_FLOWS_PROCESSED.inc()
        if stamped.verdict == "DROPPED":
            HUBBLE_DROPS.inc(labels={
                "reason": stamped.drop_reason or
                (stamped.l7_protocol and "Policy denied (L7)") or
                "unknown",
                "src_identity": str(stamped.src_identity),
                "dst_identity": str(stamped.dst_identity)})
        if stamped.l7_protocol == "http" and stamped.l7_status:
            HUBBLE_HTTP_RESPONSES.inc(labels={
                "status": str(stamped.l7_status),
                "method": stamped.l7_method or "unknown"})
        if stamped.l7_protocol == "dns":
            HUBBLE_DNS_RESPONSES.inc(labels={
                "rcode": str(stamped.l7_status)})
        with self._lock:
            followers = list(self._followers)
        for fn in followers:
            fn(stamped)
        return stamped

    def follow(self, fn: Callable[[FlowRecord], None]) -> Callable:
        """Register a live-flow subscriber; returns unsubscribe."""
        with self._lock:
            self._followers.append(fn)

        def unsubscribe():
            with self._lock:
                if fn in self._followers:
                    self._followers.remove(fn)
        return unsubscribe

    # ------------------------------------------------------------ query

    def get_flows(self, flt: Optional[FlowFilter] = None,
                  since: int = 0, limit: int = 100) -> List[Dict]:
        """Filtered flows as wire dicts, oldest first."""
        since = max(since, flt.since if flt else 0)
        return [f.to_dict()
                for f in self.store.get(flt, since=since, limit=limit)]

    def aggregate_snapshot(self, max_entries: int = 4096) -> List[Dict]:
        """The on-device flow table's per-flow counters (empty when
        device aggregation is disabled).  Goes through the engine's
        ``flow_snapshot`` surface, which a sharded dataplane
        aggregates across EVERY shard — ``dp.flows`` alone would be
        shard 0's table only."""
        dp = self.datapath
        if dp is None or getattr(dp, "flows", None) is None:
            return []
        if hasattr(dp, "flow_snapshot"):
            return dp.flow_snapshot(max_entries)
        return dp.flows.snapshot(max_entries)

    def stats(self) -> Dict:
        out = {"node": self.node, "store": self.store.stats()}
        dp = self.datapath
        if dp is not None and getattr(dp, "flows", None) is not None:
            # mesh-wide view: ShardedDatapath.flow_stats() sums every
            # shard's table (with a per-shard breakdown); reading
            # dp.flows.stats() here reported only the first shard
            out["aggregation"] = dp.flow_stats() \
                if hasattr(dp, "flow_stats") else dp.flows.stats()
        else:
            out["aggregation"] = None
        if self.store.evicted:
            # ring evictions are lost follow-events (pagers using the
            # cursor may have missed them) — surface on the series
            evicted = self.store.evicted
            already = getattr(self, "_lost_reported", 0)
            if evicted > already:
                HUBBLE_FLOWS_LOST.inc(evicted - already,
                                      labels={"source": "ring"})
                self._lost_reported = evicted
        return out

    def close(self) -> None:
        for unsub in self._unsubs:
            try:
                unsub()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._unsubs = []
