"""Federated cross-shard Hubble: the mesh-wide flow query plane.

Every shard of the sharded dataplane keeps its own device-resident
flow table, so one shard's observer would see one shard's flows (the
``dp.flows`` property is shard 0's table).  This module is the
federated view: a ``ShardedObserver`` that owns one flow plane per
dataplane shard and serves ONE merged, cursor-paginated,
shard-attributed answer — locally and, through the relay, mesh-wide:

- **Per-shard flow stores, one cursor.**  Each shard gets its own
  ``FlowObserver`` (so the ``hubble_*`` drop/HTTP/DNS series keep
  aggregating across every shard's traffic — one registry, N
  ingesters), but all stores draw sequence numbers from ONE shared
  monotonic cursor: a merged answer pages forward with a single
  ``since`` exactly like the single-store observer.
- **Event routing.**  Sampled datapath events route to their owning
  shard (``endpoint % n_shards`` — the ShardedServingLane split);
  L7 access-log records route by source identity (the proxy plane is
  not endpoint-sharded, so identity is the stable key).
- **Device-table drain.**  ``drain()`` snapshots every shard's device
  flow table and rings one flow record per flow whose counters moved
  since the last drain (delta accounting) — the COMPLETE flow plane,
  not just the sampled ring; Taurus-style per-packet-ML training
  reads this stream.  Each shard's drain runs under the relay's
  resilience primitives (a per-shard ``Deadline`` +
  ``CircuitBreaker``): a shard whose device table cannot be read is a
  flagged partial, never a hang, and its store keeps serving the
  sampled flows it already has (fail-open).
- **Fail-open shard flags.**  Every answer carries per-shard
  statuses: a shard whose supervisor is degraded serves FAIL-STATIC
  verdicts from its host oracle — its flows stay IN the answer,
  flagged ``fail-static``, so an operator sees exactly which slice of
  the mesh the flows' verdicts were decided on-host for.

The relay (hubble/relay.py) propagates these per-shard statuses per
peer, so ``hubble observe --federated`` renders the whole mesh: every
node, every shard, every degradation flagged in one answer.

A whole copy of ``cilium_tpu/hubble/federation.py`` over the port's
``ShardedDatapath``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..datapath.events import DROP_NAMES
from ..utils.metrics import (HUBBLE_FEDERATION_DRAINED,
                             HUBBLE_FEDERATION_QUERIES,
                             HUBBLE_FEDERATION_SHARDS)
from ..utils.resilience import CircuitBreaker, Deadline
from .filter import FlowFilter
from .flow import (FlowRecord, flow_from_access_log, flow_from_event,
                   verdict_of_event)
from .observer import FlowObserver


class _SharedCursor:
    """One monotonic sequence source shared by every shard store."""

    def __init__(self):
        self._mu = threading.Lock()
        self._next = 1

    def __call__(self) -> int:
        with self._mu:
            seq = self._next
            self._next += 1
            return seq

    @property
    def last(self) -> int:
        with self._mu:
            return self._next - 1


class ShardedObserver:
    """The federated flow plane over a ``ShardedDatapath``: one
    ``FlowObserver`` per dataplane shard behind the single-observer
    surface the daemon/REST/bugtool drive (``get_flows``/``stats``/
    ``aggregate_snapshot``/``last_seq``), plus the shard-attributed
    federation surface (``local_answer``/``shard_statuses``/
    ``drain``)."""

    def __init__(self, node: str = "node-local", datapath=None,
                 capacity: int = 8192,
                 drain_deadline_s: float = 2.0):
        if datapath is None or not hasattr(datapath, "n_shards"):
            raise ValueError(
                "ShardedObserver needs a ShardedDatapath")
        self.node = node
        self.datapath = datapath
        self.n_shards = int(datapath.n_shards)
        self.drain_deadline_s = drain_deadline_s
        self._cursor = _SharedCursor()
        self._unsubs: List[Callable] = []
        # one observer per shard: per-shard ring + the shared metric
        # series (drops/HTTP/DNS aggregate across ALL shards because
        # every ingester feeds the same process registry)
        self.shard_observers: List[FlowObserver] = [
            FlowObserver(node=node,
                         capacity=max(64, capacity // self.n_shards),
                         datapath=None, seq_source=self._cursor)
            for _ in range(self.n_shards)]
        # drain resilience: the relay's per-peer primitives applied to
        # the per-shard device-table read — a dead shard's drain is a
        # bounded, breaker-gated probe, never a per-tick timeout tax
        self._drain_breakers = [
            CircuitBreaker(f"hubble-drain:shard{k}",
                           failure_threshold=2, reset_timeout=0.5,
                           max_reset=10.0)
            for k in range(self.n_shards)]
        self._drain_errors: List[str] = [""] * self.n_shards
        # delta accounting: {shard: {flow key: (packets, bytes)}}
        self._drained: List[Dict[tuple, tuple]] = [
            {} for _ in range(self.n_shards)]
        self._drain_mu = threading.Lock()
        self.drains = 0

    # -------------------------------------------------------- ingestion

    def shard_of_endpoint(self, endpoint: int) -> int:
        return int(endpoint) % self.n_shards

    def attach_monitor(self, hub) -> None:
        """Subscribe to the monitor hub; sampled datapath events route
        to their owning shard's observer (same split as the serving
        lane: ``endpoint % n_shards``)."""
        self._unsubs.append(hub.subscribe(self._on_monitor_event))

    def attach_access_log(self, access_log) -> None:
        access_log.subscribers.append(self._on_access_log)

        def unsub():
            if self._on_access_log in access_log.subscribers:
                access_log.subscribers.remove(self._on_access_log)
        self._unsubs.append(unsub)

    def _on_monitor_event(self, ev) -> None:
        if ev.kind != "":
            return
        k = self.shard_of_endpoint(ev.endpoint)
        self.shard_observers[k].ingest(
            flow_from_event(ev, self.node, shard=k))

    def _on_access_log(self, entry) -> None:
        # the proxy plane is not endpoint-sharded; source identity is
        # the stable routing key for L7 records
        k = int(entry.src_identity) % self.n_shards
        self.shard_observers[k].ingest(
            flow_from_access_log(entry, self.node, shard=k))

    def ingest(self, record: FlowRecord) -> FlowRecord:
        """Direct ingestion (test/tooling surface): routes by the
        record's shard when stamped, else by its endpoint."""
        k = record.shard if 0 <= record.shard < self.n_shards \
            else self.shard_of_endpoint(record.endpoint)
        if record.shard != k:
            record = FlowRecord(**{**record.to_dict(), "shard": k})
        return self.shard_observers[k].ingest(record)

    # ------------------------------------------------------------ drain

    def drain(self, max_entries: int = 4096) -> Dict:
        """Drain every shard's device flow table into its store: one
        flow record per flow whose packet counter moved since the last
        drain.  Per-shard Deadline + CircuitBreaker: an unreadable
        shard contributes a flagged error, never a hang, and retries
        on the breaker's bounded cadence."""
        out = {"drained": 0, "shards": {}}
        for k in range(self.n_shards):
            breaker = self._drain_breakers[k]
            if not breaker.allow():
                out["shards"][str(k)] = {"status": "breaker-open",
                                         "error":
                                         self._drain_errors[k]}
                continue
            deadline = Deadline(self.drain_deadline_s)
            try:
                snap = self.datapath.shard_flow_snapshot(
                    k, max_entries)
                n = self._ingest_snapshot(k, snap, deadline)
            except Exception as e:  # noqa: BLE001 — per-shard
                breaker.record_failure()   # fail-open, never a hang
                self._drain_errors[k] = repr(e)
                out["shards"][str(k)] = {"status": "error",
                                         "error": repr(e)}
                continue
            breaker.record_success()
            out["drained"] += n
            out["shards"][str(k)] = {"status": "ok", "flows": n}
            if n:
                HUBBLE_FEDERATION_DRAINED.inc(
                    n, labels={"shard": str(k)})
        with self._drain_mu:
            self.drains += 1
        self._export_shard_gauge()
        return out

    def _ingest_snapshot(self, k: int, snap: List[Dict],
                         deadline: Deadline) -> int:
        """Ring delta records for one shard's snapshot (rows whose
        packet counter moved).  Drained records go straight to the
        store — they are aggregates, not samples, so they must not
        double-count the sampled ``hubble_*`` series."""
        store = self.shard_observers[k].store
        with self._drain_mu:
            prev = self._drained[k]
        drained = 0
        now = time.time()
        seen: Dict[tuple, tuple] = {}
        for i, row in enumerate(snap):
            if i % 128 == 0:
                deadline.check()
            key = (row["src-identity"], row["dst-identity"],
                   row["dport"], row["proto"], row["event"])
            seen[key] = (row["packets"], row["bytes"])
            old_p, old_b = prev.get(key, (0, 0))
            # uint32 counters wrap: treat a backwards move as a fresh
            # table (shard rebuild) and re-emit the whole flow
            dp_ = row["packets"] - old_p if row["packets"] >= old_p \
                else row["packets"]
            if dp_ <= 0:
                continue
            db = row["bytes"] - old_b if row["bytes"] >= old_b \
                else row["bytes"]
            event = row["event"]
            store.add(FlowRecord(
                seq=0, timestamp=float(row["last-seen"]) or now,
                node=self.node, verdict=verdict_of_event(event),
                src_identity=row["src-identity"],
                dst_identity=row["dst-identity"],
                dport=row["dport"], proto=row["proto"],
                length=db, event=event,
                drop_reason=DROP_NAMES.get(event, "")
                if event < 0 else "",
                shard=k,
                summary=f"flow-table: +{dp_} pkts +{db}B "
                        f"(total {row['packets']})"))
            drained += 1
        with self._drain_mu:
            self._drained[k] = seen
        return drained

    # ------------------------------------------------------------ query

    def shard_statuses(self) -> List[Dict]:
        """Per-shard fail-open flags: the supervisor's serving mode
        (a degraded shard's flows are FAIL-STATIC records decided on
        the host oracle — still in the answer, flagged) joined with
        the drain breaker's health."""
        modes = self.datapath.shard_modes()
        out = []
        for k in range(self.n_shards):
            mode = modes.get(k, "ok")
            breaker = self._drain_breakers[k].state
            if mode == "degraded":
                status = "fail-static"
            elif mode == "recovering":
                status = "recovering"
            elif breaker != "closed":
                status = "drain-degraded"
            else:
                status = "ok"
            entry = {"shard": k, "status": status, "mode": mode,
                     "drain-breaker": breaker,
                     "flows": self.shard_observers[k].store.last_seq}
            if self._drain_errors[k] and breaker != "closed":
                entry["error"] = self._drain_errors[k]
            out.append(entry)
        return out

    def get_flows(self, flt: Optional[FlowFilter] = None,
                  since: int = 0, limit: int = 100,
                  shard: Optional[int] = None) -> List[Dict]:
        """Merged (or single-shard) filtered flows as wire dicts,
        ordered by the shared cursor — the single-observer contract,
        shard-attributed."""
        since = max(since, flt.since if flt else 0)
        if shard is not None and not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"(0..{self.n_shards - 1})")
        shards = [shard] if shard is not None \
            else range(self.n_shards)
        records = []
        for k in shards:
            records.extend(self.shard_observers[k].store.get(
                flt, since=since, limit=limit))
        records.sort(key=lambda f: f.seq)
        if limit:
            records = records[:limit] if since else records[-limit:]
        return [f.to_dict() for f in records]

    def local_answer(self, flt: Optional[FlowFilter] = None,
                     since: int = 0, limit: int = 100,
                     shard: Optional[int] = None) -> Dict:
        """The federation wire answer: merged flows + per-shard
        fail-open statuses (what the relay's local fetch and REST
        /flows return on a sharded daemon)."""
        shards = self.shard_statuses()
        partial = any(s["status"] != "ok" for s in shards)
        HUBBLE_FEDERATION_QUERIES.inc(
            labels={"result": "partial" if partial else "ok"})
        return {"flows": self.get_flows(flt, since=since, limit=limit,
                                        shard=shard),
                "shards": shards, "partial": partial,
                "seq": self.last_seq, "node": self.node}

    @property
    def last_seq(self) -> int:
        return self._cursor.last

    # the single-observer surface the daemon/bugtool/debuginfo drive

    @property
    def store(self):
        """Shard 0's store (compat shim; merged paging goes through
        ``get_flows``/``last_seq`` — the shared cursor spans every
        store)."""
        return self.shard_observers[0].store

    def follow(self, fn: Callable[[FlowRecord], None]) -> Callable:
        unsubs = [obs.follow(fn) for obs in self.shard_observers]

        def unsubscribe():
            for u in unsubs:
                u()
        return unsubscribe

    def aggregate_snapshot(self, max_entries: int = 4096) -> List[Dict]:
        """Mesh-wide on-device per-flow counters, shard-attributed."""
        out = []
        for k in range(self.n_shards):
            try:
                rows = self.datapath.shard_flow_snapshot(k,
                                                         max_entries)
            except Exception:  # noqa: BLE001 — a dead shard's table
                continue       # is a missing slice, not a failure
            for row in rows:
                out.append({**row, "shard": k})
        return out[:max_entries]

    def _export_shard_gauge(self) -> None:
        open_ = sum(1 for b in self._drain_breakers
                    if b.state != "closed")
        HUBBLE_FEDERATION_SHARDS.set(
            self.n_shards - open_, labels={"state": "available"})
        HUBBLE_FEDERATION_SHARDS.set(
            open_, labels={"state": "degraded"})

    def stats(self) -> Dict:
        per_shard = {}
        for k, obs in enumerate(self.shard_observers):
            per_shard[str(k)] = {
                "store": obs.store.stats(),
                "aggregation": self.datapath.shard_flow_stats(k),
                "drain-breaker": self._drain_breakers[k].state}
        stores = [obs.store.stats() for obs in self.shard_observers]
        return {
            "node": self.node,
            "store": {
                "capacity": sum(s["capacity"] for s in stores),
                "ringed": sum(s["ringed"] for s in stores),
                "seq": self.last_seq,
                "evicted": sum(s["evicted"] for s in stores)},
            # mesh-wide aggregation view (sums every shard's table)
            "aggregation": self.datapath.flow_stats(),
            "federation": {"shards": self.n_shards,
                           "drains": self.drains,
                           "statuses": self.shard_statuses()},
            "per-shard": per_shard,
        }

    def close(self) -> None:
        for unsub in self._unsubs:
            try:
                unsub()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._unsubs = []
        for obs in self.shard_observers:
            obs.close()
