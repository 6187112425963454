"""The sharded verdict dataplane: the full pipeline distributed across
the (dp, ep) device mesh with per-shard fault domains.

Port of ``cilium_tpu/parallel/sharded.py``, host orchestration over one
torch ``Datapath`` per shard:

- **Endpoint-axis sharding.**  Shard k owns the endpoint slots with
  ``slot % n_shards == k`` (its slice of the logical [E, S] stack), held
  by its own engine on its mesh column's first device
  (``mesh.ep_submesh``, ``Datapath.set_mesh_placement``).  The column's
  step runs whole on that device: ``dp > 1`` is reported in
  ``geometry()`` but splits no batch, since a split would need a
  cross-device merge of the CT creates to give the single-device
  answer.  The canonical placement of every table leaf lives in
  ``parallel/specs.py``.

- **Shard-local mutable state.**  Conntrack, flow aggregation and
  counters are per shard: a shard's flows belong to its endpoints, so
  CT residency follows table residency and GC sweeps shard-locally.
  The CT key carries no endpoint, so a 5-tuple seen on endpoints of two
  shards (or a reply on another shard's endpoint) is established in one
  shard's table and new in the other's: the plane equals one engine on
  traffic whose flows stay on one endpoint.

- **Per-shard fault domains.**  Each shard's serving lane runs its own
  ``DeviceSupervisor`` (shard-scoped breaker, watchdog, fault
  accounting): when shard k trips, only endpoints mapped to shard k
  serve fail-static from that shard's ``HostStaticOracle`` while every
  other shard keeps serving on the device, and breaker-gated recovery
  rebuilds and replays only shard k's tables.  Shards that share one
  card share its CUDA context: a sticky CUDA error takes all of them,
  where on the TPU mesh it took one device.  Injected faults
  (``utils/faultinject``) are host-side and scope to one shard.

The prefilter and LB host registries are shared by every shard, so one
control-plane mutation reaches every shard on the reload fan-out; each
shard compiles the shared LB registry onto its own device
(``Datapath._lb_tables``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..datapath.engine import Datapath
from ..datapath.events import DROP_POLICY
from ..datapath.pipeline import PACKED_FIELDS
from ..endpoint.tables import DeviceTableManager
from ..observability.pressure import (MAP_ENTRIES, MAP_PRESSURE,
                                      compute_pressure)
from ..policy.mapstate import PolicyMapState
from ..utils.metrics import DATAPLANE_MODE
from .mesh import EP_AXIS, ep_submesh, make_mesh

_MODE_RANK = {"ok": 0, "recovering": 1, "degraded": 2}
_MODE_CODE = {"ok": 0.0, "degraded": 1.0, "recovering": 2.0}


# ---------------------------------------------------------------------------
# Endpoint <-> shard mapping
# ---------------------------------------------------------------------------
#
# Global table slots interleave across shards: global slot g lives on
# shard g % n_shards at local slot g // n_shards.  Interleaving (vs
# contiguous blocks) lets every shard grow independently without
# renumbering anyone else's slots — the same reason consistent-hash
# rings interleave ownership.

def shard_of_slot(global_slot: int, n_shards: int) -> int:
    return int(global_slot) % n_shards


def local_slot(global_slot: int, n_shards: int) -> int:
    return int(global_slot) // n_shards


def global_slot(shard: int, local: int, n_shards: int) -> int:
    return int(local) * n_shards + int(shard)


class ShardedTableManager:
    """Per-shard ``DeviceTableManager``s behind the single-manager
    interface the daemon drives: ``attach``/``sync_endpoint`` touch
    ONLY the owning shard's device slice (one row write on one shard's
    tensors), and a grow on one shard rebuilds one shard's tables —
    the delta-apply blast radius is one fault domain, not the mesh.
    Shard k's tensors live on ``devices[k]`` (default: ``cuda`` for
    every shard)."""

    def __init__(self, n_shards: int, initial_endpoints: int = 8,
                 initial_slots: int = 64, max_load: float = 0.5,
                 devices: Optional[Sequence] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        devices = list(devices) if devices is not None \
            else [None] * n_shards
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} "
                             f"shards")
        self.n_shards = n_shards
        self.shards = [DeviceTableManager(initial_endpoints,
                                          initial_slots, max_load,
                                          device=devices[k])
                       for k in range(n_shards)]

    def shard_of_endpoint(self, endpoint_id: int) -> int:
        """Deterministic endpoint -> shard mapping (stable across
        restarts: re-attached endpoints land on the same shard, so a
        restored CT checkpoint stays shard-consistent)."""
        return int(endpoint_id) % self.n_shards

    def attach(self, endpoint_id: int) -> int:
        k = self.shard_of_endpoint(endpoint_id)
        local = self.shards[k].attach(endpoint_id)
        return global_slot(k, local, self.n_shards)

    def detach(self, endpoint_id: int) -> None:
        self.shards[self.shard_of_endpoint(endpoint_id)].detach(
            endpoint_id)

    def slot_of(self, endpoint_id: int) -> Optional[int]:
        k = self.shard_of_endpoint(endpoint_id)
        local = self.shards[k].slot_of(endpoint_id)
        if local is None:
            return None
        return global_slot(k, local, self.n_shards)

    def sync_endpoint(self, endpoint_id: int, state, revision: int
                      ) -> Dict:
        k = self.shard_of_endpoint(endpoint_id)
        out = self.shards[k].sync_endpoint(endpoint_id, state,
                                           revision)
        return {**out, "shard": k}

    def states_by_slot(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for k, mgr in enumerate(self.shards):
            for local, st in mgr.states_by_slot().items():
                out[global_slot(k, local, self.n_shards)] = st
        return out

    def stats(self) -> Dict:
        per = [mgr.stats() for mgr in self.shards]
        return {"shards": self.n_shards,
                "endpoints": sum(s["endpoints"] for s in per),
                "capacity": sum(s["capacity"] for s in per),
                "nbytes": sum(s["nbytes"] for s in per),
                "revision": max(s["revision"] for s in per),
                "per-shard": per}


# ---------------------------------------------------------------------------
# Sharded serving lane
# ---------------------------------------------------------------------------

class ShardedTicket:
    """One submission's future across shard lanes: resolves when every
    owning shard's ticket resolves, reassembling per-record results in
    submission order.  A degraded shard's rows carry its fail-static
    answers (no error); a genuinely failed shard's rows carry its
    fail-closed denies and the ticket surfaces that shard's error."""

    def __init__(self, n: int,
                 parts: Sequence[Tuple[np.ndarray, object]]):
        self._n = n
        self._parts = list(parts)
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: List[Callable] = []
        self._remaining = len(self._parts)
        self.value = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        if not self._parts:
            self._finish()
        else:
            for _idx, ticket in self._parts:
                ticket.add_done_callback(self._part_done)

    def _part_done(self, _ticket) -> None:
        with self._lock:
            self._remaining -= 1
            if self._remaining != 0:
                return
        self._finish()

    def _finish(self) -> None:
        verdict = np.full(self._n, DROP_POLICY, np.int32)
        identity = np.zeros(self._n, np.int32)
        error = None
        for idx, ticket in self._parts:
            if ticket.value is not None:
                verdict[idx] = ticket.value[0]
                identity[idx] = ticket.value[1]
            if error is None and ticket.error is not None:
                error = ticket.error
        self.value = (verdict, identity)
        self.error = error
        with self._lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad callback must
                pass           # not poison a shard dispatcher thread

    def add_done_callback(self, cb: Callable) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("sharded ticket not resolved in time")
        return self.value


class ShardedServingLane:
    """The mesh-wide serving facade: splits each submitted SoA record
    chunk by owning shard (``endpoint % n_shards``), rewrites endpoint
    slots to shard-local, and fans the pieces into the per-shard
    continuous micro-batching lanes.  Each piece rides its own shard's
    dispatcher, supervisor and fault domain."""

    def __init__(self, plane: "ShardedDatapath"):
        self.plane = plane
        self.lanes = [sh.serving() for sh in plane.shards]

    def submit_records(self, soa: Dict[str, np.ndarray], n: int,
                       deadline: Optional[float] = None,
                       payload: Optional[np.ndarray] = None
                       ) -> ShardedTicket:
        n = int(n)
        n_shards = self.plane.n_shards
        endpoint = soa["endpoint"][:n]
        owner = endpoint % n_shards
        parts = []
        for k, lane in enumerate(self.lanes):
            idx = np.flatnonzero(owner == k)
            if idx.size == 0:
                continue
            sub = {f: np.ascontiguousarray(soa[f][:n][idx],
                                           dtype=np.int32)
                   for f in PACKED_FIELDS}
            sub["endpoint"] = (sub["endpoint"]
                               // n_shards).astype(np.int32)
            pl = None if payload is None else \
                np.ascontiguousarray(payload[:n][idx])
            parts.append((idx, lane.submit_records(
                sub, int(idx.size), deadline=deadline, payload=pl)))
        return ShardedTicket(n, parts)

    @property
    def supervisors(self) -> List[object]:
        return [lane.supervisor for lane in self.lanes]

    def stats(self) -> Dict:
        return {"lane": "sharded-verdict",
                "shards": {str(k): lane.stats()
                           for k, lane in enumerate(self.lanes)}}

    def close(self, timeout: float = 5.0) -> None:
        for lane in self.lanes:
            lane.close(timeout=timeout)


# ---------------------------------------------------------------------------
# The sharded dataplane
# ---------------------------------------------------------------------------

class ShardedDatapath:
    """N shard engines behind the single-engine surface the daemon
    drives.  Each shard is a full ``Datapath`` (its own CT/flow/counter
    state, its own step) on its column submesh's first device; the
    address-keyed tables (ipcache, prefilter, LB, tunnel) replicate to
    every shard, and the prefilter/LB registries are SHARED host
    objects so one control-plane mutation reaches every shard on the
    reload fan-out.  Without ``mesh``, the mesh is
    ``make_mesh(n_devices, ep_parallel=n_shards, devices=devices)``:
    ``devices=[torch.device("cuda:0")] * 4`` puts four shards on one
    card."""

    def __init__(self, n_shards: Optional[int] = None, mesh=None,
                 n_devices: Optional[int] = None,
                 ct_slots: int = 1 << 16, ct_probe: int = 8,
                 devices: Optional[Sequence] = None):
        if mesh is None:
            mesh = make_mesh(n_devices, ep_parallel=n_shards or 1,
                             devices=devices)
        self.mesh = mesh
        self.n_shards = int(mesh.shape[EP_AXIS])
        if n_shards is not None and n_shards != self.n_shards:
            raise ValueError(
                f"mesh ep axis {self.n_shards} != n_shards {n_shards}")
        self.shards: List[Datapath] = []
        self.prefilter = None
        self.lb = None
        for k in range(self.n_shards):
            column = ep_submesh(mesh, k)
            eng = Datapath(ct_slots=ct_slots, ct_probe=ct_probe,
                           device=column.devices[0, 0])
            if k == 0:
                self.prefilter, self.lb = eng.prefilter, eng.lb
            else:
                # shared control-plane registries: one insert, every
                # shard's next reload compiles it
                eng.prefilter = self.prefilter
                eng.lb = self.lb
            eng.configure_supervision(enabled=True, shard=k)
            eng.set_mesh_placement(column, shard=k)
            self.shards.append(eng)
        self._serving_lane: Optional[ShardedServingLane] = None
        self._table_mgr: Optional[ShardedTableManager] = None
        self._analytics_breakers: List = []
        self._lock = threading.Lock()

    # ------------------------------------------------------- geometry

    def geometry(self) -> Dict:
        dp, ep = self.mesh.devices.shape
        return {"dp": dp, "ep": ep, "devices": dp * ep,
                "shards": self.n_shards}

    def shard_of_slot(self, slot: int) -> int:
        return shard_of_slot(slot, self.n_shards)

    # ------------------------------------------------- engine surface

    @property
    def telemetry_enabled(self) -> bool:
        return self.shards[0].telemetry_enabled

    @telemetry_enabled.setter
    def telemetry_enabled(self, value: bool) -> None:
        for sh in self.shards:
            sh.telemetry_enabled = value

    @property
    def on_revision_served(self):
        return self.shards[0].on_revision_served

    @on_revision_served.setter
    def on_revision_served(self, fn) -> None:
        # the tracker's revision_served is idempotent per revision, so
        # every shard reports and the first one to serve wins
        for sh in self.shards:
            sh.on_revision_served = fn

    @property
    def revision(self) -> int:
        return max(sh.revision for sh in self.shards)

    @property
    def ct(self):
        """Shard 0's v4 CT table (geometry is uniform across shards);
        per-shard occupancy is in ``map_pressure``/``ct_entries``."""
        return self.shards[0].ct

    @property
    def ct6(self):
        return self.shards[0].ct6

    @property
    def _tables(self):
        return self.shards[0]._tables

    @property
    def flows(self):
        return self.shards[0].flows

    @property
    def provenance_enabled(self) -> bool:
        return self.shards[0].provenance_enabled

    @property
    def last_provenance(self):
        return self.shards[0].last_provenance

    @property
    def ipcache_prefixes(self) -> Dict[str, int]:
        return self.shards[0].ipcache_prefixes

    @property
    def ipcache_prefixes6(self) -> Dict[str, int]:
        return self.shards[0].ipcache_prefixes6

    @property
    def tunnel_prefixes(self) -> Dict[str, int]:
        return self.shards[0].tunnel_prefixes

    # -------------------------------------------------- table loading

    def load_policy(self, map_states: Sequence,
                    revision: int,
                    ipcache_prefixes: Optional[Dict[str, int]] = None
                    ) -> None:
        """Partition the stacked map states across shards: global slot
        g -> shard ``g % n_shards`` local slot ``g // n_shards``.
        Shards short of states get one empty (deny-all) state so every
        shard compiles a serveable program."""
        states = list(map_states)
        for k, sh in enumerate(self.shards):
            mine = states[k::self.n_shards] or [PolicyMapState()]
            sh.load_policy(mine, revision,
                           ipcache_prefixes=ipcache_prefixes)

    def use_table_manager(self, mgr: ShardedTableManager,
                          ipcache_prefixes: Optional[Dict[str, int]]
                          = None) -> None:
        if mgr.n_shards != self.n_shards:
            raise ValueError(
                f"table manager has {mgr.n_shards} shards, "
                f"dataplane has {self.n_shards}")
        self._table_mgr = mgr
        for k, sh in enumerate(self.shards):
            sh.use_table_manager(mgr.shards[k],
                                 ipcache_prefixes=ipcache_prefixes)

    def refresh_policy(self, revision: Optional[int] = None) -> bool:
        rebuilt = False
        for sh in self.shards:
            rebuilt = sh.refresh_policy(revision) or rebuilt
        return rebuilt

    def load_ipcache(self, prefixes: Dict[str, int],
                     prefixes6: Optional[Dict[str, int]] = None
                     ) -> None:
        for sh in self.shards:
            sh.load_ipcache(prefixes, prefixes6)

    def load_ipcache6(self, prefixes6: Dict[str, int]) -> None:
        for sh in self.shards:
            sh.load_ipcache6(prefixes6)

    def load_tunnel(self, prefixes: Dict[str, int]) -> None:
        for sh in self.shards:
            sh.load_tunnel(prefixes)

    def set_endpoint_identity(self, slot: int, identity: int) -> None:
        k = self.shard_of_slot(slot)
        self.shards[k].set_endpoint_identity(
            local_slot(slot, self.n_shards), identity)

    def set_router_ip6(self, ip: str) -> None:
        for sh in self.shards:
            sh.set_router_ip6(ip)

    def icmp6_echo_reply_bytes(self, requester_ip6: str,
                               ident: int = 0, seq: int = 0) -> bytes:
        return self.shards[0].icmp6_echo_reply_bytes(
            requester_ip6, ident=ident, seq=seq)

    def reload_services(self) -> None:
        for sh in self.shards:
            sh.reload_services()

    def reload_prefilter(self) -> None:
        for sh in self.shards:
            sh.reload_prefilter()

    def upsert_service6(self, svc) -> None:
        # each shard keeps its own lb6 registry; identical upsert
        # order means identical rev-NAT index assignment everywhere
        for sh in self.shards:
            sh.upsert_service6(svc)

    def delete_service6(self, vip, port: int, proto: int = 6) -> bool:
        out = False
        for sh in self.shards:
            out = sh.delete_service6(vip, port, proto) or out
        return out

    def lb6_service_list(self):
        return self.shards[0].lb6_service_list()

    # ---------------------------------------------------- flows / prov

    def enable_flow_aggregation(self, slots: int = 1 << 12,
                                max_probe: int = 8,
                                claim_every: int = 4) -> None:
        for sh in self.shards:
            sh.enable_flow_aggregation(slots=slots, max_probe=max_probe,
                                       claim_every=claim_every)

    def disable_flow_aggregation(self) -> None:
        for sh in self.shards:
            sh.disable_flow_aggregation()

    def flow_snapshot(self, max_entries: int = 4096):
        out = []
        for sh in self.shards:
            out.extend(sh.flow_snapshot(max_entries))
        return out[:max_entries]

    def shard_flow_snapshot(self, shard: int,
                            max_entries: int = 4096):
        """ONE shard's device flow table (the federated observer's
        per-shard drain source — hubble/federation.py)."""
        return self.shards[shard].flow_snapshot(max_entries)

    def shard_flow_stats(self, shard: int):
        return self.shards[shard].flow_stats()

    def shard_modes(self) -> Dict[int, str]:
        """{shard: supervisor mode} without creating serving lanes —
        the per-shard fail-open flag source for federated flow
        answers (a degraded shard's flows are FAIL-STATIC records and
        must be flagged as such)."""
        return {k: sh.supervision_status().get("mode", "ok")
                for k, sh in enumerate(self.shards)}

    def flow_stats(self):
        per = [sh.flow_stats() for sh in self.shards]
        if all(p is None for p in per):
            return None
        live = [p for p in per if p is not None]
        agg = {"occupied": sum(p.get("occupied", 0) for p in live),
               "slots": sum(p.get("slots", 0) for p in live),
               "per-shard": {str(k): p for k, p in enumerate(per)}}
        return agg

    def enable_provenance(self) -> None:
        for sh in self.shards:
            sh.enable_provenance()

    def disable_provenance(self) -> None:
        for sh in self.shards:
            sh.disable_provenance()

    def enable_l7_fast(self, programs) -> None:
        """Fan the L7 fast-verdict program set to every shard (the
        fused DFA tables are replicated per shard, like the other
        address/payload-keyed lookups; l7_prog shards with the policy
        rows each shard already owns)."""
        for sh in self.shards:
            sh.enable_l7_fast(programs)

    def disable_l7_fast(self) -> None:
        for sh in self.shards:
            sh.disable_l7_fast()

    def l7_fast_window(self) -> int:
        return self.shards[0].l7_fast_window()

    def l7_fast_report(self):
        return self.shards[0].l7_fast_report()

    # ------------------------------------------- inline threat scoring

    def enable_threat(self, model, buckets: int = 1024,
                      window_s: int = 8, stripe: int = 4) -> None:
        """Fan the threat scorer to every shard: the quantized model
        is replicated (every shard scores against the same weights),
        while each shard owns its OWN ThreatState buffer — token
        buckets and claim windows are shard-local like the CT state,
        so one shard's rate-limit debt never throttles a sibling."""
        for sh in self.shards:
            sh.enable_threat(model, buckets=buckets,
                             window_s=window_s, stripe=stripe)

    def disable_threat(self) -> None:
        for sh in self.shards:
            sh.disable_threat()

    def set_threat_config(self, config) -> None:
        for sh in self.shards:
            sh.set_threat_config(config)

    def apply_threat_weights(self, model) -> bool:
        fast = True
        for sh in self.shards:
            fast = sh.apply_threat_weights(model) and fast
        return fast

    def threat_report(self):
        """Merged report: shard 0's model view + per-shard state."""
        base = self.shards[0].threat_report()
        if base is None:
            return None
        base["shards"] = {str(k): sh.threat_report()
                          for k, sh in enumerate(self.shards)}
        base.pop("shard", None)
        return base

    @property
    def last_threat(self):
        """Concatenated last-batch threat lanes (per-shard engines
        keep their own; diagnostic surface only)."""
        outs = [sh.last_threat for sh in self.shards
                if sh.last_threat is not None]
        if not outs:
            return None
        return np.concatenate([o.cpu().numpy() for o in outs])

    # --------------------------------------- device traffic analytics

    def enable_analytics(self, width: int = 1 << 12, depth: int = 2,
                         lanes: int = 4, stripe: int = 16) -> None:
        """Fan the fused traffic-analytics stage to every shard: each
        shard folds its own traffic into its OWN AnalyticsState buffer
        (shard-local, the threat-state precedent).  Mesh-wide answers
        merge the per-shard quiesced sections host-side — sketches add
        elementwise, key tables and cardinality registers max, both
        order-free — so a top-K query never pauses serving."""
        from ..utils.resilience import CircuitBreaker
        with self._lock:
            self._analytics_breakers = [
                CircuitBreaker(f"analytics-drain:shard{k}",
                               failure_threshold=2, reset_timeout=0.5,
                               max_reset=10.0)
                for k in range(self.n_shards)]
        for sh in self.shards:
            sh.enable_analytics(width=width, depth=depth, lanes=lanes,
                                stripe=stripe)

    def disable_analytics(self) -> None:
        for sh in self.shards:
            sh.disable_analytics()

    def swap_analytics_epoch(self) -> Dict[int, int]:
        """Flip every shard's A/B epoch (each swap is a state write
        under that engine's own lock — no global pause).  Returns
        {shard: newly quiesced epoch}."""
        return {k: sh.swap_analytics_epoch()
                for k, sh in enumerate(self.shards)}

    def analytics_sections(self, swap: bool = True) -> Dict:
        """Per-shard quiesced epoch sections behind per-shard
        breakers: an unreadable shard contributes a flagged error and
        the mesh answer degrades to a ``partial`` (fail-open — the
        federated Hubble drain precedent), never a hang.  ``swap``
        flips each readable shard's epoch first, so the sections
        cover traffic since the previous drain cycle."""
        from ..analytics import decode as adec
        eng0 = self.shards[0]
        depth = eng0._analytics_depth
        lanes = eng0._analytics_lanes
        with self._lock:
            breakers = list(self._analytics_breakers)
        sections: List = []
        shards: Dict[str, Dict] = {}
        for k, sh in enumerate(self.shards):
            breaker = breakers[k] if k < len(breakers) else None
            if breaker is not None and not breaker.allow():
                shards[str(k)] = {"status": "breaker-open"}
                continue
            try:
                if swap:
                    epoch = sh.swap_analytics_epoch()
                    snap = sh.analytics_snapshot()
                    section = adec.epoch_section(snap, epoch, depth,
                                                 lanes)
                else:
                    snap = sh.analytics_snapshot()
                    section = adec.quiesced_section(snap, depth,
                                                    lanes)
            except Exception as e:  # noqa: BLE001 — per-shard
                if breaker is not None:
                    breaker.record_failure()   # fail-open, not a hang
                shards[str(k)] = {"status": "error", "error": repr(e)}
                continue
            if breaker is not None:
                breaker.record_success()
            sections.append(section)
            shards[str(k)] = {"status": "ok"}
        partial = any(s["status"] != "ok" for s in shards.values())
        return {"sections": sections, "shards": shards,
                "partial": partial, "depth": depth, "lanes": lanes}

    def analytics_query(self, view: str = "talkers", k: int = 10,
                        metric: str = "bytes",
                        swap: bool = True) -> Dict:
        """ONE mesh-wide top-K answer: merge every readable shard's
        quiesced section, decode the merged section once.  A degraded
        shard shows up as ``partial`` + its flagged status — the
        remaining shards' answer still serves (fail-open)."""
        from ..analytics import decode as adec
        secs = self.analytics_sections(swap=swap)
        if not secs["sections"]:
            return {"view": view, "entries": [], "partial": True,
                    "shards": secs["shards"]}
        merged = adec.merge_sections(secs["sections"], secs["depth"],
                                     secs["lanes"])
        entries = adec.decode_view(merged, view, secs["depth"],
                                   secs["lanes"], k=k, metric=metric)
        return {"view": view, "entries": entries,
                "partial": secs["partial"], "shards": secs["shards"]}

    def analytics_snapshot(self):
        """Shard 0's raw buffer (single-engine API parity; mesh-wide
        consumers use analytics_sections/analytics_query)."""
        return self.shards[0].analytics_snapshot()

    def analytics_report(self):
        """Merged report: shard 0's geometry + per-shard epochs."""
        base = self.shards[0].analytics_report()
        if base is None:
            return None
        base["shards"] = {str(k): sh.analytics_report()
                          for k, sh in enumerate(self.shards)}
        base.pop("shard", None)
        with self._lock:
            breakers = list(self._analytics_breakers)
        if breakers:
            base["open-breakers"] = sum(
                1 for b in breakers if b.state != "closed")
        return base

    # -------------------------------------------------------- serving

    def configure_supervision(self, enabled: bool = True,
                              **knobs) -> None:
        for k, sh in enumerate(self.shards):
            sh.configure_supervision(enabled=enabled, shard=k, **knobs)

    def serving(self) -> ShardedServingLane:
        with self._lock:
            if self._serving_lane is None:
                self._serving_lane = ShardedServingLane(self)
            return self._serving_lane

    def classify_records(self, soa: Dict[str, np.ndarray], n: int,
                         deadline: Optional[float] = None,
                         timeout: float = 120.0):
        """Route one SoA chunk through the per-shard serving lanes and
        wait for the assembled (verdict [n], identity [n]) pair."""
        ticket = self.serving().submit_records(soa, n,
                                               deadline=deadline)
        return ticket.result(timeout=timeout)

    def supervision_status(self) -> Dict:
        shards: Dict[str, Dict] = {}
        worst = "ok"
        degraded: List[int] = []
        supervised = True
        for k, sh in enumerate(self.shards):
            st = sh.supervision_status()
            shards[str(k)] = st
            mode = st.get("mode", "ok")
            if _MODE_RANK[mode] > _MODE_RANK[worst]:
                worst = mode
            if mode != "ok":
                degraded.append(k)
            supervised = supervised and bool(st.get("supervised"))
        DATAPLANE_MODE.set(_MODE_CODE[worst])
        return {"mode": worst, "supervised": supervised,
                "geometry": self.geometry(),
                "degraded-shards": degraded,
                "shards": shards}

    # ------------------------------------------------ replay / states

    def host_policy_states(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for k, sh in enumerate(self.shards):
            for local, st in sh.host_policy_states().items():
                out[global_slot(k, local, self.n_shards)] = st
        return out

    def policy_replay(self, endpoints, identities, dports, protos,
                      directions) -> List[Dict]:
        """Replay synthesized headers through the REAL sharded device
        tables: rows route to their owning shard (endpoint slots are
        GLOBAL), replay runs on each shard's live tensors, and the
        results come back in submission order with global slots."""
        eps = np.array(list(endpoints), dtype=np.int64)
        ids = np.array(list(identities), dtype=np.int64)
        dps = np.array(list(dports), dtype=np.int64)
        prs = np.array(list(protos), dtype=np.int64)
        drs = np.array(list(directions), dtype=np.int64)
        out: List[Optional[Dict]] = [None] * eps.shape[0]
        owner = eps % self.n_shards
        for k, sh in enumerate(self.shards):
            idx = np.flatnonzero(owner == k)
            if idx.size == 0:
                continue
            rows = sh.policy_replay(
                (eps[idx] // self.n_shards).tolist(), ids[idx].tolist(),
                dps[idx].tolist(), prs[idx].tolist(),
                drs[idx].tolist())
            for j, row in zip(idx.tolist(), rows):
                row["endpoint-slot"] = int(eps[j])
                row["shard"] = k
                out[j] = row
        return out

    def rule_decoder(self):
        """Shard-aware provenance decoder factory: returns a per-shard
        decoder map {shard: decode} (slots are shard-local flat
        indices; consumers pick the shard the batch routed to)."""
        return {k: sh.rule_decoder()
                for k, sh in enumerate(self.shards)}

    # ----------------------------------------------------- inventory

    def map_inventory(self) -> Dict[str, Dict]:
        per = [sh.map_inventory() for sh in self.shards]
        agg: Dict[str, Dict] = {}
        pol = {"endpoints": 0, "slots": per[0].get("policy", {})
               .get("slots", 0), "attached": 0, "max-probe": 0,
               "entries": 0}
        have_policy = False
        for inv in per:
            p = inv.get("policy")
            if p:
                have_policy = True
                pol["endpoints"] += int(p.get("endpoints", 0))
                pol["attached"] += int(p.get("attached",
                                             p.get("entries", 0)))
                pol["entries"] += int(p.get("entries", 0))
                pol["max-probe"] = max(pol["max-probe"],
                                       int(p.get("max-probe", 0)))
        if have_policy:
            agg["policy"] = pol
        for name in ("ct", "ct6"):
            agg[name] = {
                "slots": sum(int(i[name]["slots"]) for i in per),
                "occupied": sum(int(i[name]["occupied"]) for i in per),
                "max-probe": per[0][name]["max-probe"]}
        # replicated tables: every shard holds the same copy
        for name in ("ipcache", "ipcache6", "tunnel", "lb", "lb6",
                     "prefilter"):
            if name in per[0]:
                agg[name] = dict(per[0][name])
        if "hubble-flows" in per[0]:
            agg["hubble-flows"] = {
                "slots": sum(int(i["hubble-flows"]["slots"])
                             for i in per if "hubble-flows" in i),
                "occupied": sum(int(i["hubble-flows"]["occupied"])
                                for i in per if "hubble-flows" in i)}
        agg["shards"] = {str(k): inv for k, inv in enumerate(per)}
        return agg

    def map_pressure(self, warn_threshold: float = 0.9) -> Dict:
        """Mesh-wide pressure report: per-shard reports with the warn
        threshold applied SHARD-LOCALLY (shard-labelled gauges), plus
        the aggregate view on the unlabelled series."""
        shard_reports: Dict[str, Dict] = {}
        warnings: List[str] = []
        agg: Dict[str, Dict] = {}
        for k, sh in enumerate(self.shards):
            rep = compute_pressure(sh.map_inventory(), warn_threshold,
                                   shard=k)
            shard_reports[str(k)] = rep
            warnings.extend(rep["warnings"])
            for name, m in rep["maps"].items():
                a = agg.setdefault(name, {"occupied": 0, "capacity": 0,
                                          "pressure": None})
                a["occupied"] += int(m["occupied"])
                if m["capacity"] is None:
                    a["capacity"] = None
                elif a["capacity"] is not None:
                    a["capacity"] += int(m["capacity"])
        for name, a in agg.items():
            if a["capacity"]:
                a["pressure"] = round(a["occupied"] / a["capacity"], 6)
                MAP_PRESSURE.set(a["pressure"], labels={"map": name})
            MAP_ENTRIES.set(float(a["occupied"]), labels={"map": name})
        return {"maps": agg, "warnings": warnings,
                "warn-threshold": warn_threshold,
                "shards": shard_reports}

    def map_dump(self, name: str, max_entries: int = 4096):
        if name in ("ct", "ct6", "hubble-flows"):
            out = []
            for sh in self.shards:
                out.extend(sh.map_dump(name, max_entries))
            return out[:max_entries]
        # replicated maps: shard 0's copy IS the mesh's copy
        return self.shards[0].map_dump(name, max_entries)

    def ct_entries(self) -> Tuple[int, int]:
        v4 = v6 = 0
        for sh in self.shards:
            a, b = sh.ct_entries()
            v4 += a
            v6 += b
        return v4, v6

    # ---------------------------------------------------- maintenance

    def gc(self, now: Optional[int] = None) -> int:
        """Shard-aware CT GC: each shard sweeps its own tables on its
        own device (no cross-shard pause)."""
        return sum(sh.gc(now) for sh in self.shards)

    def pack_stats(self) -> Dict:
        """Table-write accounting across the mesh: each shard loads and
        writes its own tables, so whole loads and row writes are
        per-shard events with a per-shard blast radius."""
        per = {str(k): sh.pack_stats()
               for k, sh in enumerate(self.shards)}
        return {"full-packs": sum(p["full-packs"] for p in per.values()),
                "row-writes": sum(p["row-writes"] for p in per.values()),
                "leaf-writes": sum(p["leaf-writes"]
                                   for p in per.values()),
                "per-shard": per}

    def flush_telemetry(self) -> None:
        for sh in self.shards:
            sh.flush_telemetry()

    # ------------------------------------------------ CT persistence

    def snapshot_ct(self):
        """(v4, v6) snapshot dicts with shard-prefixed keys — the
        checkpoint stays one flat npz, restore splits it back."""
        v4: Dict[str, np.ndarray] = {
            "shards": np.array([self.n_shards], np.int64)}
        v6: Dict[str, np.ndarray] = {
            "shards": np.array([self.n_shards], np.int64)}
        for k, sh in enumerate(self.shards):
            s4, s6 = sh.snapshot_ct()
            for f, v in s4.items():
                v4[f"s{k}_{f}"] = v
            for f, v in s6.items():
                v6[f"s{k}_{f}"] = v
        return v4, v6

    def restore_ct_snapshots(self, v4, v6) -> int:
        n = int(np.array(v4["shards"]).reshape(-1)[0])
        if n != self.n_shards:
            raise ValueError(
                f"CT snapshot has {n} shards, dataplane has "
                f"{self.n_shards}")
        total = 0
        prepared = []
        for k, sh in enumerate(self.shards):
            sub4 = {f[len(f"s{k}_"):]: v for f, v in v4.items()
                    if f.startswith(f"s{k}_")}
            sub6 = {f[len(f"s{k}_"):]: v for f, v in v6.items()
                    if f.startswith(f"s{k}_")}
            prepared.append((sh, sub4, sub6))
        # validate everything BEFORE assigning anything: a bad shard
        # snapshot is a mesh-wide cold start, never a half-restore
        states = [(sh, sh.ct.prepare_snapshot(sub4),
                   sh.ct6.prepare_snapshot(sub6))
                  for sh, sub4, sub6 in prepared]
        for sh, st4, st6 in states:
            with sh._lock:
                sh.ct.state = st4
                sh.ct6.state = st6
            a, b = sh.ct_entries()
            total += a + b
        return total
