"""The datapath engine: host orchestrator over the device tables.

Port of ``cilium_tpu/datapath/engine.py``: one generation of every
device table (policy, v4 and v6 ipcache LPMs, LB and lb6, prefilter,
tunnel map, ICMPv6 router address) plus the mutable conntrack tables
(v4 and v6), counters and the optional Hubble flow table, behind
``process`` (a ``FullPacketBatch``), ``process_packed`` (one [10, B]
matrix) and ``process6`` (a ``FullPacketBatch6``).  Three optional
stages join both family steps when enabled: the L7 fast verdict over a
[B, W] ``payload=`` lane (``enable_l7_fast``), inline threat scoring
(``enable_threat``) and traffic analytics (``enable_analytics``); while
a stage is off its tables and state are not built and the steps run as
they did before it existed.  ``serving()`` wraps ``process_packed`` in
the shared micro-batching lane (``datapath/serving.py``) under a
``DeviceSupervisor`` (``datapath/supervisor.py``); ``policy_replay``
runs header batches through the live policy tensors, and
``map_inventory`` / ``map_dump`` / ``map_pressure`` read the tables for
the agent's ``/map`` routes and ``status()``.  ``set_mesh_placement``
makes the engine one shard of the sharded dataplane
(``parallel/sharded.py``): its state moves to its mesh column's first
device and its lane, supervisor and reports carry the shard index.
Swap-on-regenerate:
``load_policy`` builds a new table generation while conntrack, counters
and flows survive when the shapes allow (the analog of pinned BPF maps
surviving an agent restart).  The steps run eagerly; nothing in them
reads a device value on the host, so a call returns while the card
still works on it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.lpm import (CompiledLPM, CompiledLPM6, compile_lpm,
                            compile_lpm6, ipv4_to_u32, ipv6_batch_words,
                            ipv6_to_words)
from ..compiler.policy_tables import CompiledPolicy, compile_endpoints
from ..device import DeviceLike, resolve_device, same_device
from ..analytics.stage import (CTRL_COL, AnalyticsState, ctrl_row,
                               epoch_rows, make_analytics_state)
from ..hubble.aggregation import FlowState, FlowTable
from ..observability.pressure import compute_pressure
from ..observability.stages import host_span, record_stage, span
from ..policy.mapstate import PolicyMapState
from ..threat.stage import COL_WIN_TS, ThreatState, make_threat_state
from ..utils.metrics import CT_GC_ENTRIES, CT_GC_RUNS, POLICY_VERDICTS
from .conntrack import FIELDS as CT_FIELDS, ConntrackTable
from .events import format_rule, tier_name
from .icmp6 import echo_reply
from .lb import CompiledLB6, LoadBalancer, Service6, compile_lb6
from .pipeline import (DatapathTables, FullPacketBatch, FullPacketBatch6,
                       FullTables, FullTables6, build_tables,
                       full_datapath_step, full_datapath_step6,
                       full_datapath_step_packed, lpm6_tables)
from .prefilter import PreFilter
from .serving import VerdictDispatcher
from .supervisor import DeviceSupervisor
from .verdict import Counters, Provenance, make_packet_batch, verdict_explain


class Datapath:
    """One device-resident datapath generation + mutable flow state."""

    def __init__(self, ct_slots: int = 1 << 16, ct_probe: int = 8,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        # process, gc and the rebuilds all touch the CT and counters
        self._lock = threading.Lock()
        self.prefilter = PreFilter()
        self.lb = LoadBalancer(device=self.device)
        self.ct = ConntrackTable(slots=ct_slots, max_probe=ct_probe,
                                 device=self.device)
        # the v6 family's own table (the reference keeps ct6 apart)
        self.ct6 = ConntrackTable(slots=ct_slots, max_probe=ct_probe,
                                  device=self.device)
        self.compiled_policy: Optional[CompiledPolicy] = None
        self.compiled_ipcache: Optional[CompiledLPM] = None
        self.compiled_ipcache6: Optional[CompiledLPM6] = None
        self.ipcache_prefixes: Dict[str, int] = {}
        self.ipcache_prefixes6: Dict[str, int] = {}
        # v6 services: (vip words, port, proto) -> Service6; rev-NAT
        # indices are allocated monotonically and never reused, since
        # live CT entries may still carry a freed one
        self.lb6_services: Dict[tuple, Service6] = {}
        self.compiled_lb6: Optional[CompiledLB6] = None
        self._lb6_next_rev = 1
        # the node's v6 router address as int32 words (icmp6.h
        # ROUTER_IP): the address whose NS and echo the step answers
        self._router_ip6: Optional[np.ndarray] = None
        # tunnel map: pod CIDR -> tunnel endpoint node IP (int32 bits)
        self.tunnel_prefixes: Dict[str, int] = {}
        self.compiled_tunnel: Optional[CompiledLPM] = None
        # endpoint slot -> the endpoint's own security identity
        self._ep_identity = np.zeros(8, np.int32)
        # per-entry counters, [2, E*S] int32 holding uint32 bits (row 0
        # packets, row 1 bytes); read through the ``counters`` property
        self._counters: Optional[torch.Tensor] = None
        self.revision = 0
        self._tables: Optional[FullTables] = None
        self._tables6: Optional[FullTables6] = None
        self._statics: Dict = {}
        self._statics6: Dict = {}
        # Hubble flow aggregation: one table for both families (its keys
        # are identities); every ``_flow_claim_every``-th call of any
        # entry point runs the claiming step, the rest the claim-free one
        self.flows: Optional[FlowTable] = None
        self._flow_claim_every = 1
        self._flow_tick = 0
        # incremental mode: policy tensors owned by a DeviceTableManager
        self._table_mgr = None
        self._mgr_geometry = None  # (capacity, slots, max_probe, gen)
        self.provenance_enabled = False
        self.last_provenance: Optional[Provenance] = None
        # policy_replay probes as deep as the step (set per generation);
        # rule_decoder's host copy of the policy tensors, per generation
        self._replay_probe = 1
        self._prov_decode_cache = None
        # host-of-record policy states (load_policy mode): what the
        # fail-static oracle and the recovery gate answer from when no
        # DeviceTableManager owns the tensors
        self._host_states: Optional[List[PolicyMapState]] = None
        # runtime self-telemetry (observability/): stage slices and
        # verdict-outcome counts, all taken after the step with the lock
        # released; on_revision_served(revision) is called on the first
        # dispatch at a new policy revision
        self.telemetry_enabled = True
        self.on_revision_served = None
        self._served_revision = 0
        # deferred verdict-outcome accounting has its own lock: a forced
        # flush waits on the card, never while the dispatch lock is held.
        # Entries are (verdict, event recorded after its step); a side
        # stream reads finished verdicts without queueing behind the
        # steps launched since
        self._verdict_lock = threading.Lock()
        self._pending_verdicts: List = []
        self._read_stream = None
        # numbers each dispatch: the tag of its ``dp:engine.dispatch``
        self._dispatch_seq = itertools.count(1)
        # the shared serving lane (created on first use) and its
        # supervision knobs (configure_supervision)
        self._serving: Optional[VerdictDispatcher] = None
        self._serving_lane_name = "verdict"
        self._supervision_cfg: Dict = {"enabled": True}
        # mesh placement (parallel/): the (dp, 1) column this engine
        # serves as one shard of the sharded dataplane; None: a single
        # engine.  The step runs on the column's first device.
        self._placement = None
        self.shard_index: Optional[int] = None
        # the LB tables on this engine's device, when the service
        # registry is shared with an engine on another device:
        # (the registry's compiled generation, its tables here)
        self._lb_here = None
        # table-write accounting under the reference's keys: whole table
        # loads, policy rows written in place, single tensors written in
        # place (the reference's packed-buffer region writes)
        self._pack_stats = {"full-packs": 0, "row-writes": 0,
                            "leaf-writes": 0}
        # per-second device timestamp: steady-state batches reuse one
        # 0-d tensor instead of making a new one per batch
        self._ts_cache: Optional[Tuple[int, torch.Tensor]] = None
        # table generations built (config, weight and epoch swaps of the
        # optional stages write tensors in place and build none)
        self.rebuilds = 0
        # on-device L7 fast verdicts (l7/fast.L7FastPrograms); None: off
        self._l7_fast = None
        # the all -1 (absent: redirect) payload per batch size, for
        # callers of an L7-enabled engine that carry no payload
        self._absent_payloads: Dict[int, torch.Tensor] = {}
        # inline threat scoring (threat/model.ThreatModel); None: off
        self._threat = None
        self.threat_state: Optional[ThreatState] = None
        self.last_threat: Optional[torch.Tensor] = None  # threat_out
        self._threat_window_s = 8
        self._threat_stripe = 4
        # traffic analytics (None: off): the buffer, its geometry and the
        # epoch being written (the host's copy of the control cell, which
        # only swap_analytics_epoch and restore_analytics_state change)
        self.analytics_state: Optional[AnalyticsState] = None
        self._analytics_depth = 2
        self._analytics_lanes = 4
        self._analytics_stripe = 16
        self._analytics_epoch = 0

    @property
    def counters(self) -> Optional[Counters]:
        """Counters view over the [2, E*S] buffer (row views)."""
        c = self._counters
        if c is None:
            return None
        return Counters(packets=c[0], bytes=c[1])

    def enable_flow_aggregation(self, slots: int = 1 << 12,
                                max_probe: int = 8,
                                claim_every: int = 4) -> None:
        """Turn on the device flow table: both family steps gain the
        flow-aggregation tail.  ``claim_every`` stripes flow births:
        only every N-th call runs the claim, the others its claim-free
        variant."""
        with self._lock:
            if self.flows is not None and self.flows.slots == slots:
                return
            self.flows = FlowTable(slots=slots, max_probe=max_probe,
                                   device=self.device)
            self._flow_claim_every = max(1, claim_every)
            self._flow_tick = 0
            self._rebuild()

    def disable_flow_aggregation(self) -> None:
        with self._lock:
            if self.flows is None:
                return
            self.flows = None
            self._rebuild()

    def flow_snapshot(self, max_entries: int = 4096):
        """Decoded per-flow aggregates ([] when disabled)."""
        with self._lock:
            flows = self.flows
            return [] if flows is None else flows.snapshot(max_entries)

    def flow_stats(self) -> Optional[Dict]:
        with self._lock:
            if self.flows is None:
                return None
            return {**self.flows.stats(),
                    "claim-every": self._flow_claim_every}

    def enable_provenance(self) -> None:
        """Turn on per-packet verdict provenance: each step also yields
        (matched policymap slot, decision tier), kept as
        ``last_provenance``."""
        with self._lock:
            self.provenance_enabled = True

    def disable_provenance(self) -> None:
        with self._lock:
            self.provenance_enabled = False
            self.last_provenance = None

    # -- on-device L7 fast verdicts (l7/fast.py) -------------------------

    def enable_l7_fast(self, programs) -> None:
        """Turn on the L7 fast-verdict stage in both family steps:
        redirects whose matched entry's proxy port has a program in
        ``programs`` (an ``l7/fast.L7FastPrograms``) are decided from
        the ``payload=`` lane, allow or DROP_POLICY_L7; truncated and
        absent payloads keep their redirect."""
        with self._lock:
            self._l7_fast = programs
            self._absent_payloads = {}
            self._rebuild()

    def disable_l7_fast(self) -> None:
        """Back to the step without the stage: every L7 rule redirects
        to its proxy port again."""
        with self._lock:
            if self._l7_fast is None:
                return
            self._l7_fast = None
            self._absent_payloads = {}
            self._rebuild()

    def l7_fast_report(self) -> Optional[Dict]:
        """The program set's description (None: off)."""
        with self._lock:
            progs = self._l7_fast
        return None if progs is None else progs.describe()

    def l7_fast_window(self) -> int:
        """The payload window W callers encode to (0: the stage is off
        and payloads are ignored)."""
        progs = self._l7_fast
        return 0 if progs is None else progs.window

    def l7_fast_protocol_of(self):
        """Slot -> protocol tag of the program that decides it ("" for
        -1, an empty slot or a port without a program), read from the
        live policy tables; None when the stage is off."""
        with self._lock:
            progs = self._l7_fast
            tables = self._tables
        if progs is None:
            return None
        if tables is None:
            return lambda slot: ""
        meta = tables.datapath.key_meta.reshape(-1).cpu().numpy()
        value = tables.datapath.value.reshape(-1).cpu().numpy()

        def proto_of(slot) -> str:
            slot = int(slot)
            if slot < 0 or slot >= meta.shape[0] or meta[slot] == 0:
                return ""
            return progs.protocol_of_port(int(value[slot]))
        return proto_of

    # -- inline threat scoring (threat/) ---------------------------------

    def enable_threat(self, model, buckets: int = 1024, window_s: int = 8,
                      stripe: int = 4) -> None:
        """Turn on threat scoring in both family steps: ``model`` (a
        ``threat/model.ThreatModel``) scores every packet over a fresh
        [buckets+1, 6] state; its config is a device tensor, so later
        flips go through ``set_threat_config`` without a rebuild."""
        with self._lock:
            self._threat = model
            self._threat_window_s = window_s
            self._threat_stripe = stripe
            self.threat_state = make_threat_state(buckets, self.device)
            self._rebuild()

    def disable_threat(self) -> None:
        """Back to the step without the stage."""
        with self._lock:
            if self._threat is None:
                return
            self._threat = None
            self.threat_state = None
            self.last_threat = None
            self._rebuild()

    def _write_in_place(self, dst: torch.Tensor, arr) -> None:
        """Copy a host array into a live device tensor, ordered after
        the steps already queued; from pinned memory on a card, so the
        host does not wait for them."""
        src = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=dst.is_cuda)

    def set_threat_config(self, config) -> None:
        """Swap the threshold / mode vector (a ``ThreatConfig``): one
        in-place copy into the live ``tm_cfg``, no rebuild."""
        with self._lock:
            if self._threat is None:
                raise RuntimeError("threat scoring not enabled")
            self._threat = self._threat.with_config(config)
            if self._tables is not None:
                self._write_in_place(self._tables.tm_cfg,
                                     self._threat.config.encode())
                self._pack_stats["leaf-writes"] += 1

    def apply_threat_weights(self, model) -> bool:
        """Hot-swap the scorer (a trained ``ThreatModel``): the same
        geometry is copied into the five live model tensors, no rebuild;
        another hidden width rebuilds.  Returns True when it copied."""
        with self._lock:
            if self._threat is None:
                raise RuntimeError("threat scoring not enabled")
            fast = model.geometry == self._threat.geometry and \
                self._tables is not None
            self._threat = model
            if not fast:
                self._rebuild()
                return False
            for name, arr in model.tables().items():
                self._write_in_place(getattr(self._tables, name), arr)
                self._pack_stats["leaf-writes"] += 1
            return True

    def restore_threat_state(self, state: ThreatState) -> None:
        """Swap in a threat state of this engine's geometry (e.g. one
        carried from the JAX package by ``convert``)."""
        with self._lock:
            if self._threat is None:
                raise RuntimeError("threat scoring not enabled")
            want = tuple(self.threat_state.state.shape)
            if tuple(state.state.shape) != want:
                raise ValueError(f"threat state {tuple(state.state.shape)}"
                                 f", engine {want}")
            self.threat_state = ThreatState(
                state=state.state.to(self.device, torch.int32))

    def threat_report(self) -> Optional[Dict]:
        """Model and state report (None: off); reads the state."""
        with self._lock:
            model = self._threat
            state = self.threat_state
        if model is None:
            return None
        out = dict(model.describe())
        out.update({"buckets": state.state.shape[0] - 1,
                    "window-s": self._threat_window_s,
                    "stripe": self._threat_stripe,
                    "shard": self.shard_index,
                    "active-buckets": int(
                        (state.state[:-1, COL_WIN_TS] != 0).sum())})
        return out

    # -- traffic analytics (analytics/) ----------------------------------

    def enable_analytics(self, width: int = 1 << 12, depth: int = 2,
                         lanes: int = 4, stripe: int = 16) -> None:
        """Turn on traffic analytics in both family steps: each batch's
        final verdicts fold into a fresh [R, width] buffer (count-min
        sketches, candidate key tables, cardinality registers), one row
        in ``stripe`` a batch."""
        with self._lock:
            self._analytics_depth = depth
            self._analytics_lanes = lanes
            self._analytics_stripe = stripe
            self.analytics_state = make_analytics_state(width, depth,
                                                        lanes, self.device)
            self._analytics_epoch = 0
            self._rebuild()

    def disable_analytics(self) -> None:
        """Back to the step without the stage."""
        with self._lock:
            if self.analytics_state is None:
                return
            self.analytics_state = None
            self._rebuild()

    def swap_analytics_epoch(self) -> int:
        """Flip the A/B epoch: zero the section about to be written and
        name it in the control cell, two writes on the card ordered
        after the queued steps; no host read, no rebuild.  Returns the
        quiesced epoch (the one to decode)."""
        with self._lock:
            if self.analytics_state is None:
                raise RuntimeError("analytics not enabled")
            er = epoch_rows(self._analytics_depth, self._analytics_lanes)
            cur = self._analytics_epoch
            nxt = 1 - cur
            st = self.analytics_state.state
            st[nxt * er:(nxt + 1) * er].zero_()
            st[ctrl_row(self._analytics_depth, self._analytics_lanes),
               CTRL_COL] = nxt
            self._analytics_epoch = nxt
            return cur

    def restore_analytics_state(self, state: AnalyticsState) -> None:
        """Swap in an analytics buffer of this engine's geometry (e.g.
        one carried from the JAX package by ``convert``); reads its
        control cell."""
        with self._lock:
            if self.analytics_state is None:
                raise RuntimeError("analytics not enabled")
            want = tuple(self.analytics_state.state.shape)
            if tuple(state.state.shape) != want:
                raise ValueError(f"analytics state "
                                 f"{tuple(state.state.shape)}, engine "
                                 f"{want}")
            buf = state.state.to(self.device, torch.int32)
            self._analytics_epoch = int(buf[ctrl_row(
                self._analytics_depth, self._analytics_lanes), CTRL_COL])
            self.analytics_state = AnalyticsState(state=buf)

    def analytics_snapshot(self) -> Optional[np.ndarray]:
        """Host copy of the whole analytics buffer (None: off); the
        decoder (``analytics/decode.py``) reads its quiesced section."""
        with self._lock:
            st = self.analytics_state
        return None if st is None else st.state.cpu().numpy().copy()

    def analytics_report(self) -> Optional[Dict]:
        """Geometry and write epoch (None: off)."""
        with self._lock:
            if self.analytics_state is None:
                return None
            return {"width": self.analytics_state.state.shape[1],
                    "depth": self._analytics_depth,
                    "lanes": self._analytics_lanes,
                    "stripe": self._analytics_stripe,
                    "shard": self.shard_index,
                    "write-epoch": self._analytics_epoch}

    # -- table generations ----------------------------------------------

    def load_policy(self, map_states: Sequence[PolicyMapState],
                    revision: int,
                    ipcache_prefixes: Optional[Dict[str, int]] = None
                    ) -> None:
        with self._lock:
            self._table_mgr = None
            # slot i serves map_states[i]: the fail-static host-of-record
            self._host_states = list(map_states)
            self.compiled_policy = compile_endpoints(map_states,
                                                     revision=revision)
            if ipcache_prefixes is not None or \
                    self.compiled_ipcache is None:
                self.ipcache_prefixes = dict(ipcache_prefixes or {})
                self.compiled_ipcache = compile_lpm(ipcache_prefixes or {})
            self.revision = revision
            self._rebuild()

    def use_table_manager(self, mgr,
                          ipcache_prefixes: Optional[Dict[str, int]]
                          = None) -> None:
        """Take the policy tensors from a DeviceTableManager
        (incremental mode): endpoint syncs become row writes realized
        by ``refresh_policy``; only a geometry change rebuilds."""
        with self._lock:
            self._table_mgr = mgr
            if ipcache_prefixes is not None or \
                    self.compiled_ipcache is None:
                self.ipcache_prefixes = dict(ipcache_prefixes or {})
                self.compiled_ipcache = compile_lpm(ipcache_prefixes or {})
            self._rebuild()

    def refresh_policy(self, revision: Optional[int] = None,
                       force_rebuild: bool = False) -> bool:
        """Realize the table manager's current rows (the syncPolicyMap
        fast path).  With the geometry unchanged, the rows written since
        the last refresh are copied into the engine's own policy tensors
        (a row write each) and no table is rebuilt; otherwise, or with
        ``force_rebuild``, the generation is rebuilt.  Returns True when
        it rebuilt."""
        with self._lock:
            if self._table_mgr is None:
                raise RuntimeError("not in table-manager mode")
            if revision is not None:
                self.revision = max(self.revision, revision)
            geometry, tensors = self._table_mgr.snapshot()
            if force_rebuild or geometry != self._mgr_geometry \
                    or self._tables is None:
                self._rebuild(mgr_snapshot=(geometry, tensors))
                return True
            dirty = self._table_mgr.drain_dirty()
            self._pack_stats["row-writes"] += len(dirty)
            if dirty:
                # rows are written in place: rule_decoder's copy is stale
                self._prov_decode_cache = None
                rows = torch.as_tensor(np.fromiter(dirty, np.int64,
                                                   count=len(dirty)),
                                       device=self.device)
                dp = self._tables.datapath
                for i, dst in enumerate((dp.key_id, dp.key_meta,
                                         dp.value)):
                    dst[rows] = torch.as_tensor(
                        np.stack([r[i] for r in dirty.values()]),
                        device=self.device)
                if self._l7_fast is not None:
                    # the rows' program ids follow their proxy ports
                    self._tables.l7_prog[rows] = torch.as_tensor(
                        self._l7_fast.progs_for_values(
                            np.stack([r[2] for r in dirty.values()])),
                        device=self.device)
            return False

    def load_ipcache(self, prefixes: Dict[str, int],
                     prefixes6: Optional[Dict[str, int]] = None) -> None:
        with self._lock:
            self.ipcache_prefixes = dict(prefixes)
            self.compiled_ipcache = compile_lpm(prefixes)
            if prefixes6 is not None:
                self.ipcache_prefixes6 = dict(prefixes6)
                self.compiled_ipcache6 = compile_lpm6(prefixes6)
            self._rebuild()

    def load_ipcache6(self, prefixes6: Dict[str, int]) -> None:
        with self._lock:
            self.ipcache_prefixes6 = dict(prefixes6)
            self.compiled_ipcache6 = compile_lpm6(prefixes6)
            self._rebuild()

    def _admit6(self, svc: Service6) -> None:
        """Register a v6 service (lock held): a replaced service keeps
        its rev-NAT index, a new one takes the next unused index."""
        key = (tuple(svc.vip), svc.port, svc.proto)
        old = self.lb6_services.get(key)
        if svc.rev_nat_index <= 0:
            svc.rev_nat_index = old.rev_nat_index if old is not None \
                else self._lb6_next_rev
        self._lb6_next_rev = max(self._lb6_next_rev,
                                 svc.rev_nat_index + 1)
        self.lb6_services[key] = svc

    def upsert_service6(self, svc: Service6) -> None:
        """Program one v6 service (lb6)."""
        self.upsert_services6([svc])

    def upsert_services6(self, services: Sequence[Service6]) -> None:
        """``upsert_service6`` for each, in order, with one compile and
        one table generation."""
        with self._lock:
            for svc in services:
                self._admit6(svc)
            self.compiled_lb6 = compile_lb6(
                list(self.lb6_services.values()), device=self.device)
            self._rebuild()

    def delete_service6(self, vip: tuple, port: int,
                        proto: int = 6) -> bool:
        with self._lock:
            if self.lb6_services.pop((tuple(vip), port, proto),
                                     None) is None:
                return False
            self.compiled_lb6 = compile_lb6(
                list(self.lb6_services.values()), device=self.device) \
                if self.lb6_services else None
            self._rebuild()
            return True

    def set_router_ip6(self, ip: str) -> None:
        """Program the v6 router address that the ICMPv6/NDP responder
        answers for (icmp6.h ROUTER_IP)."""
        with self._lock:
            self._router_ip6 = np.asarray(ipv6_to_words(ip),
                                          np.uint32).view(np.int32)
            if self._tables6 is not None:
                self._tables6 = self._tables6._replace(
                    router_ip6=self._put(self._router_ip6))
                self._pack_stats["leaf-writes"] += 1

    def icmp6_echo_reply_bytes(self, requester_ip6: str, ident: int = 0,
                               seq: int = 0) -> bytes:
        """The responder's wire output for an answered echo
        (icmp6.h __icmp6_send_echo_reply), from this datapath's router
        address."""
        with self._lock:
            if self._router_ip6 is None:
                raise RuntimeError("router ip6 not programmed")
            words = [int(w) for w in self._router_ip6.view(np.uint32)]
        return echo_reply(words, ipv6_to_words(requester_ip6),
                          ident=ident, seq=seq)

    def load_tunnel(self, prefixes: Dict[str, int]) -> None:
        """Program the tunnel map: pod CIDR -> tunnel endpoint node IP
        (u32; pkg/maps/tunnel SetTunnelEndpoint)."""
        # node IPs above 2^31 are stored as their int32 bits
        normalized = {cidr: int(np.uint32(ip).view(np.int32))
                      for cidr, ip in prefixes.items()}
        with self._lock:
            if normalized == self.tunnel_prefixes:
                return
            self.tunnel_prefixes = normalized
            self.compiled_tunnel = compile_lpm(self.tunnel_prefixes) \
                if self.tunnel_prefixes else None
            self._rebuild()

    def set_endpoint_identity(self, slot: int, identity: int) -> None:
        """Record a local endpoint slot's own security identity (the
        per-endpoint SECLABEL), stamped into tunnel keys on encap."""
        with self._lock:
            if slot >= self._ep_identity.shape[0]:
                grown = np.zeros(max(slot + 1,
                                     2 * self._ep_identity.shape[0]),
                                 np.int32)
                grown[:self._ep_identity.shape[0]] = self._ep_identity
                self._ep_identity = grown
            self._ep_identity[slot] = identity
            if self._tables is not None:
                ep = self._put(self._ep_identity)
                self._tables = self._tables._replace(ep_identity=ep)
                self._tables6 = self._tables6._replace(ep_identity=ep)
                self._pack_stats["leaf-writes"] += 1

    def reload_services(self) -> None:
        with self._lock:
            self._rebuild()

    def reload_prefilter(self) -> None:
        with self._lock:
            self._rebuild()

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr, np.int32),
                               device=self.device)

    def _rebuild(self, mgr_snapshot=None) -> None:
        """Build the next table generation from the host state (lock
        held).  Counters are kept when their size is unchanged."""
        if self._table_mgr is None and self.compiled_policy is None:
            return
        self.rebuilds += 1
        self._pack_stats["full-packs"] += 1
        if self.lb.compiled is None:
            self.lb._recompile()
        if self.compiled_ipcache is None:
            self.compiled_ipcache = compile_lpm({})
        lpm = self.compiled_ipcache
        if self._table_mgr is not None:
            if mgr_snapshot is None:
                mgr_snapshot = self._table_mgr.snapshot()
            geometry, tensors = mgr_snapshot
            capacity, slots, max_probe, _gen = geometry
            # the engine's own copies: a manager row write shows only
            # after refresh_policy, as in the reference
            key_id, key_meta, value = (t.to(self.device, copy=True)
                                       for t in tensors)
            dp = DatapathTables(
                key_id=key_id, key_meta=key_meta, value=value,
                lpm_masks=self._put(lpm.masks),
                lpm_key_a=self._put(lpm.key_a),
                lpm_key_b=self._put(lpm.key_b),
                lpm_value=self._put(lpm.value),
                lpm_plens=self._put(lpm.prefix_lens))
            policy_probe = max(1, max_probe)
            n = max(1, capacity * slots)
            self._mgr_geometry = geometry
        else:
            dp = build_tables(self.compiled_policy, lpm, device=self.device)
            policy_probe = self.compiled_policy.max_probe
            n = max(1, self.compiled_policy.num_endpoints *
                    self.compiled_policy.slots)
        pf = self.prefilter.compiled
        if pf is None or pf.entry_count() == 0:
            pf = compile_lpm({})
        tun = self.compiled_tunnel
        tun_kwargs = {}
        tun_probe = 0
        if tun is not None and tun.entry_count() > 0:
            tun_probe = max(1, tun.max_probe)
            tun_kwargs = dict(
                tun_masks=self._put(tun.masks),
                tun_key_a=self._put(tun.key_a),
                tun_key_b=self._put(tun.key_b),
                tun_value=self._put(tun.value),
                tun_plens=self._put(tun.prefix_lens))
        ep_identity = self._put(self._ep_identity)
        # the optional stages' tables, shared by both families; absent
        # while a stage is off
        stage_kwargs, stage_statics = self._stage_tables(dp)
        self._tables = FullTables(
            datapath=dp, lb=self._lb_tables(),
            pf_masks=self._put(pf.masks), pf_key_a=self._put(pf.key_a),
            pf_key_b=self._put(pf.key_b), pf_value=self._put(pf.value),
            pf_plens=self._put(pf.prefix_lens),
            ep_identity=ep_identity, **tun_kwargs, **stage_kwargs)
        if self._counters is None or self._counters.shape[1] != n:
            self._counters = torch.zeros((2, n), dtype=torch.int32,
                                         device=self.device)
        flow_kwargs = {}
        if self.flows is not None:
            flow_kwargs = dict(flow_slots=self.flows.slots,
                               flow_probe=self.flows.max_probe,
                               flow_claim_budget=self.flows.claim_budget)
        self._replay_probe = policy_probe
        self._prov_decode_cache = None
        self._statics = dict(
            policy_probe=policy_probe,
            lpm_probe=max(1, self.compiled_ipcache.max_probe),
            pf_probe=max(1, pf.max_probe),
            lb_probe=self.lb.compiled.max_probe,
            ct_slots=self.ct.slots, ct_probe=self.ct.max_probe,
            tun_probe=tun_probe, **flow_kwargs, **stage_statics)

        # the v6 twin shares the policy tensors and endpoint identities
        ipc6 = self.compiled_ipcache6 if self.compiled_ipcache6 \
            is not None else compile_lpm6({})
        pf6 = self.prefilter.compiled6
        if pf6 is None or pf6.entry_count() == 0:
            pf6 = compile_lpm6({})
        lb6 = self.compiled_lb6
        self._tables6 = FullTables6(
            key_id=dp.key_id, key_meta=dp.key_meta, value=dp.value,
            ipcache6=lpm6_tables(ipc6, self.device),
            pf6=lpm6_tables(pf6, self.device),
            lb6=lb6.tables if lb6 is not None else None,
            router_ip6=None if self._router_ip6 is None
            else self._put(self._router_ip6),
            ep_identity=ep_identity, **stage_kwargs)
        self._statics6 = dict(
            policy_probe=policy_probe,
            lpm6_probe=max(1, ipc6.max_probe),
            pf6_probe=max(1, pf6.max_probe),
            ct_slots=self.ct6.slots, ct_probe=self.ct6.max_probe,
            lb6_probe=lb6.max_probe if lb6 is not None else 0,
            **flow_kwargs, **stage_statics)

    def _lb_tables(self):
        """The service registry's compiled LB tables on this engine's
        device (lock held).  A sharded plane shares one registry across
        its shards (``parallel/sharded.py``); the registry compiles on
        its own device, so a shard on another device takes a copy,
        made once per compiled generation."""
        compiled = self.lb.compiled
        if same_device(compiled.tables.svc_key_a.device, self.device):
            return compiled.tables
        if self._lb_here is None or self._lb_here[0] is not compiled:
            self._lb_here = (compiled, type(compiled.tables)(
                *(t.to(self.device) for t in compiled.tables)))
        return self._lb_here[1]

    def _stage_tables(self, dp: DatapathTables):
        """(table tensors, step flags) of the enabled optional stages
        (lock held); both empty while every stage is off.  The L7
        program of each slot follows the slot's proxy port, so it is
        derived again with every generation."""
        tables, statics = {}, {}
        progs = self._l7_fast
        if progs is not None:
            values = self.compiled_policy.value if self._table_mgr is None \
                else dp.value.cpu().numpy()
            tables.update(
                l7_prog=self._put(progs.progs_for_values(values)),
                l7_flat=self._put(progs.flat), l7_map=self._put(progs.cmap),
                l7_accept=self._put(progs.accept),
                l7_starts=self._put(progs.starts),
                l7_pmask=self._put(progs.pmask))
            statics.update(with_l7_fast=True, l7_k=progs.k, l7_c1=progs.c1)
        if self._threat is not None:
            tables.update({k: self._put(v)
                           for k, v in self._threat.tables().items()})
            statics.update(with_threat=True,
                           threat_window_s=self._threat_window_s,
                           threat_stripe=self._threat_stripe)
        if self.analytics_state is not None:
            statics.update(with_analytics=True,
                           analytics_depth=self._analytics_depth,
                           analytics_lanes=self._analytics_lanes,
                           analytics_stripe=self._analytics_stripe)
        return tables, statics

    # -- the step ---------------------------------------------------------

    def _timestamp(self, now: Optional[int]) -> torch.Tensor:
        """0-d int32 device tensor of the batch time, cached per value;
        made by a fill on the device, not a copy from the host."""
        val = int(now if now is not None else time.time())
        cache = self._ts_cache
        if cache is not None and cache[0] == val:
            return cache[1]
        ts = torch.full((), val, dtype=torch.int32, device=self.device)
        self._ts_cache = (val, ts)
        return ts

    def _payload_in(self, payload: Optional[torch.Tensor],
                    rows: int) -> Optional[torch.Tensor]:
        """The payload lane of one step (lock held): None while the fast
        stage is off (a payload is ignored then); the caller's [rows, W]
        int32 tensor on this engine's device; or, when the caller has
        none, the cached all -1 lane (absent: every L7 flow redirects)."""
        progs = self._l7_fast
        if progs is None:
            return None
        if payload is None:
            cached = self._absent_payloads.get(rows)
            if cached is None:
                cached = torch.full((rows, progs.window), -1,
                                    dtype=torch.int32, device=self.device)
                self._absent_payloads[rows] = cached
            return cached
        if tuple(payload.shape) != (rows, progs.window) or \
                payload.dtype != torch.int32 or \
                payload.device.type != self.device.type:
            raise ValueError(
                f"payload must be [{rows}, {progs.window}] int32 on "
                f"{self.device}, got {payload.dtype} "
                f"{tuple(payload.shape)} on {payload.device}")
        return payload

    def _dispatch_locked(self, step, family6: bool, batch, ts,
                         payload: Optional[torch.Tensor] = None,
                         rows: int = 0):
        """One step of either family (lock held), the flow table,
        provenance and the optional stages threaded through when they
        are on."""
        if self._tables is None:
            raise RuntimeError("no policy loaded")
        tables, ct, statics = (self._tables6, self.ct6, self._statics6) \
            if family6 else (self._tables, self.ct, self._statics)
        flows_in = None
        if self.flows is not None:
            flows_in = self.flows.state
            # claim-admission striping: one tick shared by every entry
            tick = self._flow_tick
            self._flow_tick = tick + 1
            if tick % self._flow_claim_every:
                statics = dict(statics, flow_claim_budget=0)
        outs = step(tables, ct.state, self.counters, batch, ts, flows_in,
                    self._payload_in(payload, rows), self.threat_state,
                    self.analytics_state,
                    with_provenance=self.provenance_enabled, **statics)
        verdict, event, identity, nat = outs[:4]
        ct.state = outs[4]
        tail = 6
        if flows_in is not None:
            self.flows.state = outs[tail]
            tail += 1
        if self._threat is not None:
            self.threat_state, self.last_threat = outs[tail:tail + 2]
            tail += 2
        if self.analytics_state is not None:
            self.analytics_state = outs[tail]
            tail += 1
        if self.provenance_enabled:
            self.last_provenance = Provenance(outs[tail], outs[tail + 1])
        return verdict, event, identity, nat

    def process(self, pkt: FullPacketBatch, now: Optional[int] = None,
                payload: Optional[torch.Tensor] = None):
        """Classify a batch.  Returns (verdict, event, identity, nat),
        device tensors; nat carries the DNAT'd forward tuple and the
        rev-NAT'd reply tuple.  ``payload`` is the [B, W] int32 L7
        payload lane on this engine's device
        (``l7/fast.encode_payloads``), read by the fast-verdict stage
        when it is on and ignored otherwise."""
        return self._serve("engine-v4", full_datapath_step, False, pkt,
                           now, payload, int(pkt.endpoint.shape[0]))

    def process6(self, pkt: FullPacketBatch6, now: Optional[int] = None,
                 payload: Optional[torch.Tensor] = None):
        """Classify a v6 batch (bpf_lxc.c:745 ipv6_policy).  Returns
        (verdict, event, identity, nat6), device tensors; ``payload`` as
        for ``process``."""
        return self._serve("engine-v6", full_datapath_step6, True, pkt,
                           now, payload, int(pkt.sport.shape[0]))

    def process_packed(self, packed: torch.Tensor,
                       now: Optional[int] = None,
                       payload: Optional[torch.Tensor] = None):
        """Classify a batch given as ONE [10, B] int32 field matrix on
        this engine's device (``pipeline.PACKED_FIELDS`` order): the
        serving path's entry, one host-to-device copy per batch.  Same
        outputs as ``process``; ``payload`` rides beside the matrix."""
        return self._serve("engine-v4", full_datapath_step_packed, False,
                           packed, now, payload, int(packed.shape[1]))

    def _serve(self, family: str, step, family6: bool, batch,
               now: Optional[int], payload, rows: int):
        """One dispatch under the lock, then (lock released) its stage
        slice and the revision-served hook; the whole call is the span
        ``dp:engine.dispatch#<n>``, n its sequence number."""
        with span("engine.dispatch", next(self._dispatch_seq)):
            ts = self._timestamp(now)
            telem = self.telemetry_enabled
            if telem:
                with host_span(family, "lock-wait", "engine.lock_wait"):
                    self._lock.acquire()
            else:
                self._lock.acquire()
            try:
                t_lock = time.perf_counter() if telem else 0.0
                out = self._dispatch_locked(step, family6, batch, ts,
                                            payload, rows)
                served = self._revision_newly_served_locked()
            finally:
                self._lock.release()
            if telem:
                self._account_dispatch(family, t_lock, out[0])
            if served:
                self._notify_revision_served(served)
            return out

    # -- the serving lane (datapath/serving.py, datapath/supervisor.py) ---

    def set_mesh_placement(self, submesh, shard: Optional[int] = None,
                           lane: Optional[str] = None) -> None:
        """Make this engine one shard column of the dataplane mesh
        (``parallel/mesh.ep_submesh``): its tables, CT, counters, flow,
        threat and analytics state move to the column's first device,
        where its step runs whole, and its serving lane is named
        ``verdict-s{shard}`` unless ``lane`` names it.  The column's
        other dp devices hold nothing: splitting a batch across them
        would need a cross-device merge of the CT creates."""
        dev = submesh.devices[0, 0]
        with self._lock:
            self._placement = submesh
            self.shard_index = shard
            if lane is not None:
                self._serving_lane_name = lane
            elif shard is not None:
                self._serving_lane_name = f"verdict-s{shard}"
            if same_device(dev, self.device):
                return
            self.device = dev
            self._ts_cache = None
            self._absent_payloads = {}
            for tbl in (self.ct, self.ct6):
                tbl.device = dev
                tbl.state = tbl.state.to(dev)
            if self.flows is not None:
                self.flows.device = dev
                self.flows.state = FlowState(
                    *(t.to(dev) for t in self.flows.state))
            if self._counters is not None:
                self._counters = self._counters.to(dev)
            if self.threat_state is not None:
                self.threat_state = ThreatState(
                    state=self.threat_state.state.to(dev))
            if self.analytics_state is not None:
                self.analytics_state = AnalyticsState(
                    state=self.analytics_state.state.to(dev))
            if self.compiled_lb6 is not None:
                self.compiled_lb6 = compile_lb6(
                    list(self.lb6_services.values()), device=dev)
            self._rebuild()

    def configure_supervision(self, enabled: bool = True,
                              **knobs) -> None:
        """Set the serving lane's supervision config before the first
        ``serving()``.  Knobs: watchdog_s, failure_threshold, reset_s,
        new_flow_policy, recovery_gate, shard (``DeviceSupervisor``
        arguments) plus max_pending and default_deadline (admission
        control).  ``enabled=False`` gives the lane without a
        supervisor."""
        with self._lock:
            if self._serving is not None:
                raise RuntimeError(
                    "serving lane already created; configure "
                    "supervision before first serving() use")
            self._supervision_cfg = {"enabled": enabled, **knobs}

    def serving(self) -> VerdictDispatcher:
        """The engine's shared continuous micro-batching lane (created on
        first use): every caller submits record chunks here, so
        concurrent callers coalesce into one device launch.  Unless
        supervision is disabled its launches run under a
        ``DeviceSupervisor``."""
        with self._lock:
            if self._serving is None:
                cfg = dict(self._supervision_cfg)
                admission = {
                    "max_pending": cfg.pop("max_pending", None),
                    "default_deadline": cfg.pop("default_deadline",
                                                None)}
                supervisor = DeviceSupervisor(self, **cfg) \
                    if cfg.pop("enabled", True) else None
                self._serving = VerdictDispatcher(
                    self, supervisor=supervisor,
                    lane=self._serving_lane_name, **admission)
            return self._serving

    def supervision_status(self) -> Dict:
        """Serving mode (ok/degraded/recovering), breaker state and the
        lane's shed / fail-static accounting.  Never creates the lane."""
        with self._lock:
            serving = self._serving
        if serving is None:
            return {"mode": "ok", "serving": None,
                    "supervised": self._supervision_cfg.get("enabled",
                                                            True)}
        sup = serving.supervisor
        return {"mode": sup.mode if sup is not None else "ok",
                "supervised": sup is not None,
                "serving": serving.stats()}

    def host_policy_states(self) -> Dict[int, PolicyMapState]:
        """{table slot: host-of-record PolicyMapState}: what the
        fail-static oracle enforces and the recovery gate replays
        against; from the DeviceTableManager in incremental mode, from
        the states ``load_policy`` compiled otherwise."""
        with self._lock:
            mgr = self._table_mgr
            states = self._host_states
        if mgr is not None:
            return mgr.states_by_slot()
        if states is None:
            return {}
        return {slot: st for slot, st in enumerate(states)}

    # -- self-telemetry (observability/) ----------------------------------

    def _account_dispatch(self, family: str, t_lock: float,
                          verdict: torch.Tensor) -> None:
        """The dispatch's stage slice (its time under the lock) and
        deferred verdict accounting, after the lock is released: the
        span ``dp:engine.telemetry``."""
        with span("engine.telemetry"):
            record_stage(family, "dispatch", time.perf_counter() - t_lock)
            done = None
            if verdict.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(verdict.device))
            with self._verdict_lock:
                self._pending_verdicts.append((verdict, done))
                self._flush_verdict_counts(
                    force=len(self._pending_verdicts) > 8)

    def _verdict_read_stream(self):
        """Context of the side stream verdict counts are read on (no
        stream on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._read_stream is None:
            self._read_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._read_stream)

    def _flush_verdict_counts(self, force: bool = False) -> None:
        """Count verdict outcomes of finished batches (verdict lock
        held).  A batch is finished when its event has completed (on
        the CPU at once); the rest wait for a later call, or, once more
        than 8 are pending, are read anyway.  The read runs on a side
        stream made to wait on the batch's event, so it never queues
        behind the steps launched after it."""
        remaining = []
        for arr, done in self._pending_verdicts:
            try:
                ready = force or done is None or done.query()
            except Exception:  # noqa: BLE001 — a context lost since
                continue
            if not ready:
                remaining.append((arr, done))
                continue
            try:
                with self._verdict_read_stream():
                    if done is not None:
                        torch.cuda.current_stream().wait_event(done)
                    v = arr.cpu().numpy()  # sync-ok: a finished (event-gated) batch, or a bounded force-flush, read on a side stream outside the device lock
            except Exception:  # noqa: BLE001 — a context lost since
                continue
            denied = int((v < 0).sum())
            redirected = int((v > 0).sum())
            allowed = v.shape[0] - denied - redirected
            for outcome, n in (("allowed", allowed), ("denied", denied),
                               ("redirected", redirected)):
                if n:
                    POLICY_VERDICTS.inc(n, labels={"outcome": outcome})
        self._pending_verdicts = remaining

    def flush_telemetry(self) -> None:
        """Drain the deferred verdict accounting (the metrics-scrape
        path); takes only the verdict lock."""
        with self._verdict_lock:
            self._flush_verdict_counts(force=True)

    def _revision_newly_served_locked(self) -> int:
        """First dispatch at a new policy revision (lock held): the
        revision to report, or 0."""
        if self.on_revision_served is None or \
                self.revision <= self._served_revision:
            return 0
        self._served_revision = self.revision
        return self.revision

    def _notify_revision_served(self, revision: int) -> None:
        try:
            self.on_revision_served(revision)
        except Exception:  # noqa: BLE001 — telemetry must never
            pass           # poison the verdict path

    # -- policy replay ------------------------------------------------------

    def rule_decoder(self):
        """Host decoder of provenance match slots: a closure mapping a
        flat [E*S] slot to the compiled PolicyKey words at that slot of
        the live policy tensors (None for -1, an empty slot or out of
        range).  The host copy is cached per table generation."""
        with self._lock:
            if self._tables is None:
                return lambda slot: None
            dp = self._tables.datapath
            cache = self._prov_decode_cache
        if cache is None or cache[0] is not dp.key_id:
            # read outside the lock: the copy waits for the queued steps
            arrays = tuple(t.reshape(-1).cpu().numpy()
                           for t in (dp.key_id, dp.key_meta, dp.value))
            cache = (dp.key_id, arrays + (int(dp.key_id.shape[-1]),))
            with self._lock:
                self._prov_decode_cache = cache
        flat_id, flat_meta, flat_value, slots = cache[1]

        def decode(slot) -> Optional[Dict]:
            slot = int(slot)
            if slot < 0 or slot >= flat_meta.shape[0]:
                return None
            meta = int(flat_meta[slot])
            if meta == 0:
                return None  # slot emptied since the batch ran
            return {"endpoint-slot": slot // slots,
                    "slot": slot % slots,
                    "identity": int(np.uint32(flat_id[slot])),
                    "dport": (meta >> 16) & 0xFFFF,
                    "proto": (meta >> 8) & 0xFF,
                    "direction": (meta >> 1) & 1,
                    "proxy-port": int(flat_value[slot])}
        return decode

    def policy_replay(self, endpoints, identities, dports, protos,
                      directions) -> List[Dict]:
        """Run a synthesized header batch through the live policy tensors
        (``policy trace --replay``, the recovery gate's device side).
        Pure read: no counters, no CT, no flow table; ``verdict_explain``
        shares the step's lookups, so the verdicts are the ones
        ``process()`` would give a new flow.

        Arguments are equal-length sequences of endpoint table slots,
        identities, dports, protos and directions.  Returns one dict per
        row: the final verdict/tier/slot, the decoded matched key and
        each stage's outcome."""
        with self._lock:
            if self._tables is None:
                raise RuntimeError("no policy loaded")
            dp = self._tables.datapath
            key_id, key_meta, value = dp.key_id, dp.key_meta, dp.value
            probe = self._replay_probe
        pkt = make_packet_batch(endpoints, identities, dports, protos,
                                directions, device=self.device)
        res = verdict_explain(key_id, key_meta, value, pkt,
                              max_probe=probe)
        host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else
                    {f: t.cpu().numpy() for f, t in v.items()})
                for k, v in res.items()}
        decode = self.rule_decoder()
        eps, ids, dps, prs, dirs = (np.asarray(a) for a in (
            endpoints, identities, dports, protos, directions))
        out: List[Dict] = []
        for i in range(eps.shape[0]):
            stages = {}
            for name in ("exact", "l3", "l4_wildcard"):
                st = host[name]
                found = bool(st["found"][i])
                stages[name] = {
                    "found": found, "value": int(st["value"][i]),
                    "key": decode(st["slot"][i]) if found else None}
            slot = int(host["slot"][i])
            tier = int(host["tier"][i])
            out.append({
                "endpoint-slot": int(eps[i]), "identity": int(ids[i]),
                "dport": int(dps[i]), "proto": int(prs[i]),
                "direction": int(dirs[i]),
                "verdict": int(host["verdict"][i]), "tier": tier,
                "tier-name": tier_name(tier), "slot": slot,
                "matched": decode(slot) if slot >= 0 else None,
                "stages": stages})
        return out

    def provenance_rule_of(self):
        """String form of rule_decoder for the monitor and Hubble
        surfaces ('' for unmatched slots)."""
        decode = self.rule_decoder()

        def rule_of(slot) -> str:
            return format_rule(decode(slot))
        return rule_of

    # -- map surface (cilium bpf */list analogs) --------------------------

    def map_pressure(self, warn_threshold: float = 0.9) -> Dict:
        """Map-pressure report over the live device tables (updates the
        map_pressure / map_entries gauges as a side effect)."""
        return compute_pressure(self.map_inventory(), warn_threshold)

    def lb6_service_list(self) -> List[Service6]:
        """The v6 service registry, copied under the engine lock (the
        threaded REST server must not iterate the live dict while an
        upsert changes it)."""
        with self._lock:
            return list(self.lb6_services.values())

    def map_inventory(self) -> Dict[str, Dict]:
        """Per-map geometry and occupancy: what state lives on the
        device now (cilium map list)."""
        with self._lock:
            out: Dict[str, Dict] = {}
            if self._table_mgr is not None:
                geom, _t = self._table_mgr.snapshot()
                cap, slots, probe, gen = geom
                out["policy"] = {"endpoints": cap, "slots": slots,
                                 "max-probe": probe, "generation": gen,
                                 "attached":
                                 self._table_mgr.stats()["endpoints"]}
            elif self.compiled_policy is not None:
                out["policy"] = {
                    "endpoints": self.compiled_policy.num_endpoints,
                    "slots": self.compiled_policy.slots,
                    "max-probe": self.compiled_policy.max_probe,
                    "entries": self.compiled_policy.entry_count()}
            out["ipcache"] = {"entries": len(self.ipcache_prefixes)}
            out["ipcache6"] = {"entries": len(self.ipcache_prefixes6)}
            for name, tbl in (("ct", self.ct), ("ct6", self.ct6)):
                out[name] = {"slots": tbl.slots,
                             "occupied": tbl.entry_count(),
                             "max-probe": tbl.max_probe}
            out["lb"] = {"services": len(self.lb)}
            out["lb6"] = {"services": len(self.lb6_services)}
            out["tunnel"] = {"entries": len(self.tunnel_prefixes)}
            if self.flows is not None:
                out["hubble-flows"] = self.flows.stats()
            pf = self.prefilter.compiled
            pf6 = self.prefilter.compiled6
            out["prefilter"] = {
                "v4-entries": pf.entry_count() if pf else 0,
                "v6-entries": pf6.entry_count() if pf6 else 0}
            return out

    def map_dump(self, name: str, max_entries: int = 4096):
        """Entries of one device map (cilium bpf ipcache/ct/tunnel/lb
        list).  CT dumps decode the live device table, the state the
        verdict path consults.  Raises KeyError for an unknown map."""
        if name == "hubble-flows":
            return self.flow_snapshot(max_entries)
        # the steps update the CT in place: copy it on the card under
        # the lock and read the copy to the host after releasing it, so
        # the transfer and the decode never hold up process()
        with self._lock:
            if name == "ipcache":
                return dict(sorted(self.ipcache_prefixes.items())
                            [:max_entries])
            if name == "ipcache6":
                return dict(sorted(self.ipcache_prefixes6.items())
                            [:max_entries])
            if name == "tunnel":
                return {cidr: int(np.uint32(ip & 0xFFFFFFFF))
                        for cidr, ip in
                        sorted(self.tunnel_prefixes.items())
                        [:max_entries]}
            if name in ("ct", "ct6"):
                tbl = self.ct if name == "ct" else self.ct6
                st = tbl.state[:, :tbl.slots].clone()
            elif name == "lb":
                svcs = self.lb.services()[:max_entries]
            elif name == "lb6":
                svcs6 = list(self.lb6_services.values())[:max_entries]
            elif name == "prefilter":
                cidrs, rev = self.prefilter.dump()
                return {"cidrs": cidrs[:max_entries], "revision": rev}
            else:
                raise KeyError(name)
        if name in ("ct", "ct6"):
            host = st.cpu().numpy()
            flds = dict(zip(CT_FIELDS, host))
            k3 = flds["k3"]
            idx = np.flatnonzero(k3)[:max_entries]
            k0 = flds["k0"].astype(np.uint32)
            k1 = flds["k1"].astype(np.uint32)
            k2 = flds["k2"].astype(np.uint32)
            exp = flds["expires"]
            rn = flds["rev_nat"]
            pp = flds["proxy_port"]
            return [{
                "saddr": int(k0[i]), "daddr": int(k1[i]),
                "sport": int(k2[i] >> 16),
                "dport": int(k2[i] & 0xFFFF),
                "proto": int((k3[i] >> 8) & 0xFF),
                "ingress": not bool((k3[i] >> 1) & 1),
                "expires": int(exp[i]),
                "rev-nat": int(rn[i]),
                "proxy-port": int(pp[i])} for i in idx.tolist()]
        if name == "lb":
            return [{"vip": int(np.uint32(s.vip & 0xFFFFFFFF)),
                     "port": s.port, "proto": s.proto,
                     "backends": len(s.backends),
                     "rev-nat": s.rev_nat_index} for s in svcs]
        return [{"vip": list(s.vip), "port": s.port,
                 "proto": s.proto, "backends": len(s.backends),
                 "rev-nat": s.rev_nat_index} for s in svcs6]

    # -- table-write accounting -----------------------------------------

    def pack_stats(self) -> Dict:
        """Table-write accounting under the reference's keys:
        ``full-packs`` counts whole table loads (generations built),
        ``row-writes`` the policy rows ``refresh_policy`` wrote in place,
        ``leaf-writes`` the single tensors written in place (threat
        config and weights, router address, endpoint identities)."""
        with self._lock:
            return dict(self._pack_stats)

    def dispatch_leaf_counts(self) -> Dict[str, int]:
        """The tensors each step is handed per batch, under the
        reference's keys: ``packed-step`` (``process_packed``: the table
        tensors, the CT table, the counter buffer, the [10, B] matrix,
        the timestamp and the enabled stages' state), ``v6-step``
        (``process6``, ten per-field packet tensors) and
        ``legacy-step`` (``process`` with the CT and counters split per
        field, as the reference counts its pytree form)."""
        with self._lock:
            if self._tables is None:
                raise RuntimeError("no policy loaded")
            extra = (2 if self.flows is not None else 0) + \
                (1 if self._l7_fast is not None else 0) + \
                (1 if self._threat is not None else 0) + \
                (1 if self.analytics_state is not None else 0)
            n_tables = _tensor_leaves(self._tables)
            n_tables6 = _tensor_leaves(self._tables6)
        n_packed = n_tables + 1 + 1 + 1 + 1 + extra
        n_legacy = n_tables + len(CT_FIELDS) + 2 + 1 + 1 + extra
        return {"packed-step": n_packed,
                "v6-step": n_tables6 + 1 + 1 + 10 + 1 + extra,
                "legacy-step": n_legacy,
                "reduction": round(n_legacy / n_packed, 2)}

    # -- conntrack surface ------------------------------------------------

    def ct_entries(self) -> Tuple[int, int]:
        """(v4, v6) live CT entry counts."""
        with self._lock:
            return self.ct.entry_count(), self.ct6.entry_count()

    def snapshot_ct(self):
        """(v4, v6) CT snapshots in the reference's npz layout."""
        with self._lock:
            return self.ct.snapshot(), self.ct6.snapshot()

    def restore_ct_snapshots(self, v4, v6) -> int:
        """Validate and swap in both CT snapshots together (both are
        prepared before either is assigned); returns entries restored.
        Raises ValueError/KeyError on a bad snapshot."""
        with self._lock:
            st4 = self.ct.prepare_snapshot(v4)
            st6 = self.ct6.prepare_snapshot(v6)
            self.ct.state = st4
            self.ct6.state = st6
            return self.ct.entry_count() + self.ct6.entry_count()

    def gc(self, now: Optional[int] = None) -> int:
        """Clear both CT tables' expired entries; returns how many.  The
        lock, the sweeps and the count's read are the span
        ``dp:ct.gc``, timed as the stage slice ("ct", "gc")."""
        with host_span("ct", "gc", "ct.gc"):
            with self._lock:
                ts = now if now is not None else int(time.time())
                n = self.ct.gc(ts) + self.ct6.gc(ts)
        CT_GC_RUNS.inc()
        if n:
            CT_GC_ENTRIES.inc(n, labels={"status": "deleted"})
        return n


def _tensor_leaves(tree) -> int:
    """Tensors in a (nested) NamedTuple of tables; None fields are
    absent tables and not counted."""
    if isinstance(tree, torch.Tensor):
        return 1
    if isinstance(tree, tuple):
        return sum(_tensor_leaves(t) for t in tree)
    return 0


def make_full_batch(endpoint, saddr, daddr, sport, dport, proto=None,
                    direction=None, tcp_flags=None, length=None,
                    is_fragment=None, from_overlay=None, tunnel_id=None,
                    mark_identity=None, device: DeviceLike = None
                    ) -> FullPacketBatch:
    """A FullPacketBatch on ``device`` from lists or numpy arrays;
    addresses may be dotted-quad strings or uint32 values.  Defaults:
    TCP, egress, SYN, 100 bytes, not a fragment."""
    dev = resolve_device(device)
    n = len(np.asarray(endpoint))

    def arr(x, default):
        a = np.asarray(x if x is not None else np.full(n, default))
        return torch.as_tensor(a.astype(np.int32), device=dev)

    def addr(x):
        a = np.asarray(x)
        if a.dtype.kind in ("U", "S", "O"):  # dotted-quad strings
            a = np.array([ipv4_to_u32(str(s)) for s in a.ravel()],
                         np.uint32).reshape(a.shape)
        if a.dtype != np.int32:
            a = a.astype(np.int64).astype(np.uint32).view(np.int32)
        return torch.as_tensor(a, device=dev)

    overlay_fields = {}
    if from_overlay is not None or tunnel_id is not None:
        overlay_fields = dict(from_overlay=arr(from_overlay, 0),
                              tunnel_id=arr(tunnel_id, 0))
    if mark_identity is not None:
        overlay_fields["mark_identity"] = arr(mark_identity, 0)
    return FullPacketBatch(
        endpoint=arr(endpoint, 0), saddr=addr(saddr), daddr=addr(daddr),
        sport=arr(sport, 0), dport=arr(dport, 0), proto=arr(proto, 6),
        direction=arr(direction, 1), tcp_flags=arr(tcp_flags, 0x02),
        length=arr(length, 100), is_fragment=arr(is_fragment, 0),
        **overlay_fields)


def make_full_batch6(endpoint, saddr, daddr, sport, dport, proto=None,
                     direction=None, tcp_flags=None, length=None,
                     is_fragment=None, from_overlay=None, tunnel_id=None,
                     mark_identity=None, icmp_type=None, nd_target=None,
                     device: DeviceLike = None) -> FullPacketBatch6:
    """A FullPacketBatch6 on ``device``: addresses (and ``nd_target``)
    as v6 strings or [B, 4] word arrays; ``icmp_type``/``nd_target``
    feed the ICMPv6/NDP responder.  Defaults as ``make_full_batch``."""
    dev = resolve_device(device)
    n = len(np.asarray(endpoint))

    def arr(x, default):
        a = np.asarray(x if x is not None else np.full(n, default))
        return torch.as_tensor(a.astype(np.int32), device=dev)

    def addr6(x):
        a = np.asarray(x)
        if a.dtype.kind in ("U", "S", "O"):
            a = ipv6_batch_words([str(s) for s in a.ravel()])
        if a.ndim != 2 or a.shape[1] != 4:
            raise ValueError(f"v6 addresses are [B, 4], got {a.shape}")
        if a.dtype != np.int32:
            a = a.astype(np.int64).astype(np.uint32).view(np.int32)
        return torch.as_tensor(a, device=dev)

    extra = {}
    if from_overlay is not None or tunnel_id is not None:
        extra = dict(from_overlay=arr(from_overlay, 0),
                     tunnel_id=arr(tunnel_id, 0))
    if mark_identity is not None:
        extra["mark_identity"] = arr(mark_identity, 0)
    if icmp_type is not None or nd_target is not None:
        extra["icmp_type"] = arr(icmp_type, 0)
        extra["nd_target"] = addr6(nd_target) if nd_target is not None \
            else torch.zeros((n, 4), dtype=torch.int32, device=dev)
    return FullPacketBatch6(
        endpoint=arr(endpoint, 0), saddr=addr6(saddr), daddr=addr6(daddr),
        sport=arr(sport, 0), dport=arr(dport, 0), proto=arr(proto, 6),
        direction=arr(direction, 1), tcp_flags=arr(tcp_flags, 0x02),
        length=arr(length, 100), is_fragment=arr(is_fragment, 0),
        **extra)
