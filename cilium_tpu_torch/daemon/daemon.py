"""The Daemon: the single-node agent on the card.

Reference: daemon/daemon.go:1090 NewDaemon (bootstrap order), daemon/
policy.go:171 PolicyAdd / :48 TriggerPolicyUpdates, daemon/endpoint.go
(REST endpoint lifecycle), daemon/state.go (restore), daemon/status.go.

Port of ``cilium_tpu/daemon/daemon.py``.  The daemon owns one torch
``Datapath`` (device tables and CT state on ``device``), or with
``dataplane_shards`` of 2 or more a ``ShardedDatapath`` of that many
shard engines (every shard on ``device``: the reference spans every
device of its backend) with a ``ShardedTableManager`` and the federated
``ShardedObserver``; one ``DeviceTableManager``-backed regeneration
pipeline and the ``ProxyManager`` on the same device, with the reference's controllers (``ct-gc``,
``policy-drift-audit``, ``ct-checkpoint``, ``analytics-drain``), the
serving supervision whose recovery gate is the full drift audit, and the
reference's state directory (endpoint JSON checkpoints, ``ct_state.npz``),
so a state directory either package wrote restores in the other.
With a kvstore backend it replicates control state (identities,
ipcache, nodes) through the kvstore as the reference does, behind the
same outage guard, so port and JAX agents share one store.
``serve_xds`` serves its proxy state to out-of-process proxies, and the
host integrations (``k8s``, ``cni``, ``docker_plugin``,
``runtime_watch``, ``health``, ``bugtool``) drive it from outside
through the same methods as the reference's; the agent refuses no path
of the reference.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import identity as idpkg
from ..clustermesh import ClusterMesh
from ..datapath.engine import Datapath
from ..datapath.lb import Backend, Service
from ..device import DeviceLike, resolve_device
from ..endpoint.endpoint import Endpoint, EndpointState
from ..endpoint.manager import EndpointManager
from ..endpoint.tables import DeviceTableManager
from ..hubble.federation import ShardedObserver
from ..identity import (Identity, IdentityCache, LocalIdentityAllocator,
                        is_local_scope_identity)
from ..ipcache.cidr import allocate_cidr_identities, release_cidr_identities
from ..ipcache.ipcache import SOURCE_AGENT_LOCAL, SOURCE_GENERATED, IPCache
from ..ipcache.kvstore_sync import (IP_IDENTITIES_PATH, IPIdentityWatcher,
                                    KVStoreIPCacheSyncer)
from ..kvstore.identity_allocator import (IDENTITY_PREFIX,
                                          DistributedIdentityAllocator,
                                          FallbackIdentityAllocator)
from ..kvstore.outage import OutageGuard
from ..ipam import HostScopeIPAM, IPAMError
from ..l7.dns import DNSCache, DNSPoller, inject_to_cidr_set
from ..labels import Labels
from ..monitor import MonitorHub
from ..node import NODES_PATH, Node, NodeManager, NodeRegistry
from ..observability import (PolicyPropagationTracker, pipeline_report,
                             slo_tracker, tracer)
from ..observability.events import recorder as flight_recorder
from ..parallel.sharded import ShardedDatapath, ShardedTableManager
from ..policy.api import Rule
from ..policy.mapstate import PolicyMapState
from ..policy.repository import Repository
from ..policy.trace import SearchContext, traced_context
from ..proxy import ProxyManager
from ..migrate import MigrationError
from ..utils.lock import RMutex
from ..utils.controller import ControllerManager, ControllerParams
from ..utils.metrics import (ENDPOINT_STATE_COUNT, IDENTITY_COUNT,
                             POLICY_COUNT, POLICY_IMPORT_ERRORS,
                             POLICY_REGENERATION_COUNT, POLICY_REVISION,
                             PROXY_REDIRECTS, registry as metrics_registry)
from ..utils.option import DaemonConfig, parse_option_value
from ..utils import resilience as transport_resilience
from ..utils.trigger import Trigger
from ..compiler.lpm import ipv4_to_u32

# /service/{id} API ids: v6 services offset into a disjoint range
# (each family allocates rev-NAT indices independently)
V6_SERVICE_ID_BASE = 1_000_000

class Daemon:
    """One agent instance; every tensor it holds lives on ``device``
    (``None``: ``cuda``, which raises without a card)."""

    def __init__(self, config: Optional[DaemonConfig] = None,
                 kvstore_backend=None, node_name: str = "node-local",
                 builders: int = 4, device: DeviceLike = None):
        self.config = config or DaemonConfig()
        self.device = resolve_device(device)
        self.node_name = node_name
        self.repo = Repository()
        self.ipcache = IPCache()
        self.monitor = MonitorHub()
        self.proxy = ProxyManager(self.config.proxy_port_min,
                                  self.config.proxy_port_max,
                                  device=self.device)
        self.controllers = ControllerManager()
        # the verdict dataplane: single-engine by default; with
        # dataplane_shards >= 2 the pipeline shards across the (dp, ep)
        # mesh — endpoint-axis table slices with per-shard CT/flow state
        # and per-shard fault domains (parallel/sharded.py), every shard
        # on this agent's device
        n_shards = self.config.dataplane_shards
        if n_shards >= 2:
            self.datapath = ShardedDatapath(
                n_shards=n_shards, devices=[self.device] * n_shards,
                ct_slots=self.config.ct_slots)
        else:
            self.datapath = Datapath(ct_slots=self.config.ct_slots,
                                     device=self.device)
        # runtime self-telemetry (observability/): span tracing across
        # the control plane, the policy-propagation latency tracker
        # closed by the engine's revision-served hook, and the
        # engine-side stage and verdict accounting — one config switch
        # gates all of it
        tracer.configure(enabled=self.config.enable_tracing,
                         capacity=self.config.trace_capacity)
        self.tracer = tracer
        # serving SLO tier defaults (observability/slo.py): lanes with
        # an admission deadline use it as their objective; everything
        # else is judged against this one
        slo_tracker.configure(
            objective_s=self.config.serving_slo_objective_s,
            error_budget=self.config.serving_slo_error_budget)
        self.propagation = PolicyPropagationTracker(tracer=tracer)
        self.datapath.telemetry_enabled = self.config.enable_tracing
        self.datapath.on_revision_served = \
            self.propagation.revision_served
        # dataplane supervision (datapath/supervisor.py): overload
        # admission control + device-fault circuit breaking with
        # fail-static host fallback on the serving lane; the recovery
        # gate is the FULL drift audit — a rebuilt device table
        # only resumes serving after replaying clean against the host
        # policy oracles
        self.datapath.configure_supervision(
            enabled=self.config.enable_supervision,
            watchdog_s=self.config.supervisor_watchdog_s,
            failure_threshold=self.config.supervisor_failure_threshold,
            reset_s=self.config.supervisor_reset_s,
            new_flow_policy=self.config.degraded_new_flow_policy,
            recovery_gate=self._dataplane_recovery_gate,
            max_pending=self.config.serving_max_pending,
            default_deadline=self.config.serving_deadline_s or None)
        # incremental policy realization: one endpoint's regeneration
        # writes one device-table row (syncPolicyMap analog); the
        # engine rebuilds only when the stack's geometry grows.  In
        # sharded mode the row write (and any grow) touches ONLY the
        # owning shard's slice.
        if n_shards >= 2:
            self.table_mgr = ShardedTableManager(
                n_shards, devices=[self.device] * n_shards)
        else:
            self.table_mgr = DeviceTableManager(device=self.device)
        self.datapath.use_table_manager(self.table_mgr)
        # host fast path: C++ per-endpoint verdict caches (the eBPF
        # hit-path analog); optional — the device path works without it
        try:
            from ..native.fastpath import HostVerdictPath
            self.host_path = HostVerdictPath()
        except (RuntimeError, OSError):
            self.host_path = None
        self.dns_cache = DNSCache()
        self.dns_poller: Optional[DNSPoller] = None
        self.started_at = time.time()

        # daemon-owned host-scope IPAM (daemon/ipam.go handlers): the
        # REST /ipam routes and the docker libnetwork driver allocate
        # from these; the router IP (offset 1) is the node's gateway
        self.ipam = HostScopeIPAM(self.config.ipv4_range)
        self.ipam6 = HostScopeIPAM(self.config.ipv6_range) \
            if self.config.enable_ipv6 else None
        self.host_ipv4 = self.ipam.router_ip()
        # NB: HostScopeIPAM defines __len__, so an empty pool is falsy
        # — identity checks only
        self.host_ipv6 = self.ipam6.router_ip() \
            if self.ipam6 is not None else ""
        if self.host_ipv6:
            # the ICMPv6/NDP responder answers NS/echo for this
            # address (icmp6.h ROUTER_IP; written by datapath init)
            self.datapath.set_router_ip6(self.host_ipv6)

        # L7 access-log records join the monitor stream
        # (LogRecordNotify analog: pkg/proxy/logger -> monitor)
        self.proxy.access_log.subscribers.append(self.monitor.notify_l7)
        self.monitor.notify_agent("agent-start", node_name)

        # Hubble flow observability (hubble/): the observer rings flow
        # records from the sampled datapath events + the structured L7
        # access log; the device aggregation table fuses into the
        # datapath steps; the relay federates /flows across peers
        # discovered through the node registry + clustermesh
        if getattr(self.config, "enable_hubble", True):
            from ..hubble import FlowFilter, FlowObserver, HubbleRelay
            if self.config.hubble_flow_slots > 0:
                self.datapath.enable_flow_aggregation(
                    slots=self.config.hubble_flow_slots,
                    max_probe=self.config.hubble_flow_probe)
            if n_shards >= 2:
                # the federated cross-shard observer (hubble/
                # federation.py): per-shard flow stores behind one
                # cursor, per-shard device-table drains, and merged
                # shard-attributed answers with fail-open flags
                self.hubble = ShardedObserver(
                    node=node_name, datapath=self.datapath,
                    capacity=self.config.hubble_ring_capacity)
                if self.config.hubble_drain_interval_s > 0:
                    self.controllers.update_controller(
                        "hubble-shard-drain", ControllerParams(
                            do_func=lambda: self.hubble.drain(),
                            run_interval=self.config
                            .hubble_drain_interval_s))
            else:
                self.hubble = FlowObserver(
                    node=node_name,
                    capacity=self.config.hubble_ring_capacity,
                    datapath=self.datapath)
            self.hubble.attach_monitor(self.monitor)
            self.hubble.attach_access_log(self.proxy.access_log)

            def _local_fetch(query, since, limit):
                flt = FlowFilter.from_query(query)
                if hasattr(self.hubble, "local_answer"):
                    # sharded: the answer carries per-shard fail-open
                    # statuses the relay propagates mesh-wide
                    return self.hubble.local_answer(
                        flt, since=since, limit=limit)
                return {"flows": self.hubble.get_flows(
                    flt, since=since, limit=limit)}

            self.hubble_relay = HubbleRelay(
                local_name=node_name, local_fetch=_local_fetch,
                node_source=self._hubble_peer_urls,
                deadline_s=self.config.hubble_relay_deadline_s)
        else:
            self.hubble = None
            self.hubble_relay = None

        # the node manager must exist before the registry: registry
        # construction synchronously replays pre-existing nodes into
        # _on_node_update, which programs it
        self.node_manager = NodeManager(
            f"{self.config.cluster_name}/{node_name}",
            ipcache=self.ipcache,
            mode="tunnel" if self.config.tunnel != "disabled" else "direct",
            datapath=self.datapath)

        # identity allocation: distributed when a kvstore is attached
        # (daemon.go:1295 InitIdentityAllocator).  The backend is
        # wrapped in the control-plane outage guard (kvstore/outage.py):
        # pass-through bookkeeping by default (the status() staleness
        # fix), full degrade/journal/reconcile machinery when
        # enable_kvstore_survival is on.
        self._kv_guard = None
        # promotion-time identity events must not fan a regeneration
        # storm across every endpoint; see _on_identity_change.  The
        # id-keyed map outlives the time window because the watch echo
        # of a promotion arrives only after the streams re-establish.
        self._suppress_regen_until = 0.0
        self._suppressed_ident_ids: Dict[int, float] = {}
        if kvstore_backend is not None:
            self._kv_guard = OutageGuard(
                kvstore_backend,
                degrade=self.config.enable_kvstore_survival,
                failure_threshold=self.config.kvstore_failure_threshold,
                probe_interval=self.config.kvstore_probe_interval_s,
                grace_s=self.config.kvstore_grace_s,
                journal_max=self.config.kvstore_journal_max,
                replay_ops_per_s=self.config
                .kvstore_reconcile_ops_per_s)
            kvstore_backend = self._kv_guard
        self.kv = kvstore_backend
        if self.kv is not None:
            # remote identity churn must retrigger endpoint policy
            # recompute (pkg/identity identityWatcher ->
            # TriggerPolicyUpdates): a peer node allocating a new
            # identity changes what our selectors match
            allocator = DistributedIdentityAllocator(
                self.kv, node=node_name,
                cluster_id=self.config.cluster_id,
                on_change=self._on_identity_change)
            if self.config.enable_kvstore_survival:
                # outage fallback: adopt cached bindings, else allocate
                # node-local ephemeral identities promoted on reconnect
                allocator = FallbackIdentityAllocator(
                    allocator, guard=self._kv_guard,
                    on_change=self._on_identity_change)
            self.identity_allocator = allocator
            self._ip_syncer = KVStoreIPCacheSyncer(self.kv)
            self.ipcache.add_listener(self._ip_syncer.listener(),
                                      replay=False)
            self._ip_watcher = IPIdentityWatcher(
                self.kv, self.ipcache,
                restart=self.config.enable_kvstore_survival,
                restart_backoff_s=self.config.kvstore_probe_interval_s)
            self._ip_watcher.start()
            self.node_registry = NodeRegistry(
                self.kv,
                on_node_update=self._on_node_update,
                on_node_delete=self._on_node_delete)
            # the reconnect relist-and-diff repairs locally owned keys
            # under exactly the replicated-store prefixes
            self._kv_guard.track_prefix(IDENTITY_PREFIX + "/")
            self._kv_guard.track_prefix(IP_IDENTITIES_PATH + "/")
            self._kv_guard.track_prefix(NODES_PATH + "/")
        else:
            self.identity_allocator = LocalIdentityAllocator(
                cluster_id=self.config.cluster_id)
            self._ip_syncer = None
            self._ip_watcher = None
            self.node_registry = None
        self.clustermesh = ClusterMesh(
            ipcache=self.ipcache,
            on_node_update=self.node_manager.node_updated,
            on_node_delete=self.node_manager.node_deleted)

        # policy-held CIDR identities: prefix -> (Identity, refcount);
        # refs are PER RULE occurrence so partial deletes balance
        self._cidr_idents: Dict[str, Tuple[Identity, int]] = {}
        # rule object -> prefixes it currently holds refs for
        self._rule_prefixes: Dict[int, List[str]] = {}
        self._fqdn_rules: List[Rule] = []
        self._lock = RMutex("daemon")

        # endpoint regeneration pipeline (daemon.go:1133 builders)
        self.endpoints = EndpointManager(
            regenerate_fn=self._regenerate_endpoint, builders=builders,
            on_outcome=lambda ep_id, ok: self.monitor.notify_agent(
                "endpoint-regenerate-success" if ok
                else "endpoint-regenerate-failure", f"id={ep_id}"))
        self._regen_trigger = Trigger(
            lambda reasons: self.endpoints.regenerate_all(
                ",".join(reasons) or "policy-update"),
            min_interval=0.01, name="policy-updates")

        # ipcache churn -> datapath LPM reload, debounced
        self._lpm_trigger = Trigger(
            lambda _r: self.datapath.load_ipcache(
                *self.ipcache.to_lpm_prefix_families()),
            min_interval=0.01, name="ipcache-lpm")
        self.ipcache.add_listener(
            lambda *_a: self._lpm_trigger.trigger("ipcache"), replay=False)

        # verdict provenance (datapath/verdict.py): per-packet
        # matched-rule + decision-tier attribution in the jitted
        # steps, plus the periodic drift audit — the continuous
        # correctness oracle for the policy compiler (replay through
        # the REAL device tables vs the host SearchContext /
        # compute_desired_policy_map_state simulations)
        if self.config.enable_provenance:
            self.datapath.enable_provenance()
        # inline threat scoring (cilium_tpu/threat/): fuse the
        # quantized per-packet anomaly scorer into both family
        # pipelines.  Bootstrap weights are the hand-seeded default
        # model; training (threat_train) hot-swaps better ones through
        # the delta-apply path with zero repacks.
        self._threat_trainer = None
        if self.config.enable_threat:
            from ..threat import ThreatTrainer, default_model
            from ..utils.metrics import THREAT_MODEL_GENERATION
            self._threat_trainer = ThreatTrainer()
            model = default_model(self._threat_config_from_options())
            self.datapath.enable_threat(
                model, buckets=self.config.threat_buckets,
                window_s=self.config.threat_window_s)
            THREAT_MODEL_GENERATION.set(model.config.generation)
        # device-resident traffic analytics (cilium_tpu/analytics/):
        # count-min sketches + cardinality registers fused into both
        # family pipelines; the drain controller swaps the A/B epoch,
        # decodes the quiesced section into the capped top-K byte
        # gauge, and rings heavy-hitter / scan-suspect transitions
        # into the incident flight recorder
        self._analytics_hh_live: set = set()
        self._analytics_scan_live: set = set()
        self._analytics_exported: set = set()
        self._analytics_last: Optional[Dict] = None
        if self.config.enable_analytics:
            self.datapath.enable_analytics(
                width=self.config.analytics_width,
                depth=self.config.analytics_depth,
                lanes=self.config.analytics_lanes,
                stripe=self.config.analytics_stripe)
            if self.config.analytics_drain_interval_s > 0:
                self.controllers.update_controller(
                    "analytics-drain", ControllerParams(
                        do_func=self.analytics_drain,
                        run_interval=self.config
                        .analytics_drain_interval_s))
        self._drift_report: Optional[Dict] = None
        self._last_replay: Optional[Dict] = None
        self._drift_rng = np.random.default_rng(0xC111)
        if self.config.drift_audit_interval_s > 0:
            self.controllers.update_controller(
                "policy-drift-audit", ControllerParams(
                    do_func=self.run_drift_audit,
                    run_interval=self.config.drift_audit_interval_s))

        # periodic CT GC (ctmap.go GC sweep analog)
        self.controllers.update_controller(
            "ct-gc", ControllerParams(
                do_func=lambda: self.datapath.gc(), run_interval=5.0))
        # the control-plane outage driver: probes the kvstore when
        # idle, detects sustained failure, and on reconnect runs the
        # journal replay + relist reconcile followed by local-identity
        # promotion (opt-in; kvstore/outage.py)
        if self._kv_guard is not None and \
                self.config.enable_kvstore_survival:
            self.controllers.update_controller(
                "kvstore-outage", ControllerParams(
                    do_func=self._kvstore_tick,
                    run_interval=self.config.kvstore_probe_interval_s))
        # periodic CT checkpoint: a kill -9'd agent otherwise loses
        # every established flow (shutdown() is the only other writer)
        self._ct_checkpoint_lock = threading.Lock()
        if self.config.state_dir and \
                self.config.ct_checkpoint_interval_s > 0:
            self._ct_checkpoint_armed = False
            self.controllers.update_controller(
                "ct-checkpoint", ControllerParams(
                    do_func=self._ct_checkpoint_tick,
                    run_interval=self.config.ct_checkpoint_interval_s))

    # ------------------------------------------------------------ nodes

    def _on_identity_change(self, _typ: str, ident) -> None:
        # may fire during __init__ (watch replay) before the trigger
        # exists; those identities are covered by the first build anyway
        now = time.monotonic()
        if now < getattr(self, "_suppress_regen_until", 0.0):
            # local-identity promotion window: the promotion path
            # queues regeneration for exactly the affected endpoints —
            # the watch echo of our own re-allocations must not fan a
            # full regeneration storm on top of it
            return
        suppressed = getattr(self, "_suppressed_ident_ids", None)
        if suppressed and ident is not None:
            until = suppressed.get(getattr(ident, "id", None))
            if until is not None:
                if now < until:
                    # the watch echo of a promoted identity: streams
                    # re-establish only after reconnect, so this event
                    # lands well past the promotion window — still our
                    # own re-allocation, still not a storm trigger
                    return
                suppressed.pop(ident.id, None)
        trigger = getattr(self, "_regen_trigger", None)
        if trigger is not None:
            trigger.trigger("identity-change")

    # ------------------------------------- control-plane survivability

    def _kvstore_tick(self) -> None:
        """The kvstore-outage controller body: drive the outage
        guard's detector/reconcile state machine, then promote any
        node-local ephemeral identities once the control plane is
        healthy again."""
        guard = self._kv_guard
        event = guard.tick()
        if event.get("reconciled"):
            self.monitor.notify_agent(
                "kvstore-reconnected",
                f"reconcile={event.get('report')}")
        if guard.mode == "ok" and \
                isinstance(self.identity_allocator,
                           FallbackIdentityAllocator) and \
                self.identity_allocator.local_count():
            self._promote_local_identities()

    def _promote_local_identities(self) -> Dict[str, int]:
        """Re-key everything holding a node-local ephemeral identity
        to a cluster-scope one through the (now healthy) distributed
        allocator, regenerating ONLY the affected endpoints: the
        re-keyed ones plus any endpoint whose realized policy map
        references a promoted ID — incremental delta-applies, never a
        full regeneration storm."""
        fb = self.identity_allocator
        mapping: Dict[int, int] = {}   # local id -> cluster id
        # two suppression layers for the watch echo of our own
        # re-allocations: a rolling time window (bumped per promoted
        # identity — a slow kvstore must not outlive it mid-loop) and
        # an id-keyed map (the echo can land only after the watch
        # streams re-establish, well past any fixed window)
        window = max(1.0, 4 * self.config.kvstore_probe_interval_s)
        suppress_for = max(30.0,
                           8 * self.config.kvstore_probe_interval_s)
        self._suppress_regen_until = time.monotonic() + window

        def _register(old_id: int, new_id: int) -> None:
            mapping[old_id] = new_id
            until = time.monotonic() + suppress_for
            self._suppressed_ident_ids[old_id] = until
            self._suppressed_ident_ids[new_id] = until
            self._suppress_regen_until = time.monotonic() + window

        promoted_cidrs = rekeyed = 0
        try:
            # policy-held CIDR identities first (prefix -> identity)
            with self._lock:
                local_cidrs = [
                    (p, ident, n)
                    for p, (ident, n) in self._cidr_idents.items()
                    if is_local_scope_identity(ident.id)]
            for prefix, old, refs in local_cidrs:
                # keep the window alive across each kvstore round-trip
                self._suppress_regen_until = time.monotonic() + window
                new = None
                for _ in range(refs):
                    new, _is_new = fb.allocate(old.labels)
                if new is None or is_local_scope_identity(new.id):
                    continue  # control plane flapped again; next tick
                _register(old.id, new.id)
                with self._lock:
                    self._cidr_idents[prefix] = (new, refs)
                self.ipcache.upsert(prefix, new.id, SOURCE_GENERATED,
                                    metadata="cidr-policy")
                for _ in range(refs):
                    fb.release(old)
                promoted_cidrs += 1
            # endpoint identities: re-resolve labels through the
            # healthy allocator (the normal update path — allocate new,
            # release local, device identity + ipcache in lockstep)
            rekeyed_ids = []
            for ep in self.endpoints.endpoints():
                old_id = ep.security_identity
                if not is_local_scope_identity(old_id):
                    continue
                self._suppress_regen_until = time.monotonic() + window
                changed = ep.update_labels(fb, ep.labels)
                if not changed or \
                        is_local_scope_identity(ep.security_identity):
                    continue
                _register(old_id, ep.security_identity)
                if ep.table_slot is not None:
                    self.datapath.set_endpoint_identity(
                        ep.table_slot, ep.security_identity)
                if ep.ipv4:
                    self.ipcache.upsert(ep.ipv4, ep.security_identity,
                                        SOURCE_AGENT_LOCAL,
                                        metadata=f"endpoint:{ep.id}")
                rekeyed_ids.append(ep.id)
                rekeyed += 1
            # the actually-diverged endpoint set: re-keyed endpoints,
            # endpoints whose realized maps name a promoted ID, and
            # endpoints with a build running: such a build may have
            # taken its identity snapshot before the re-keying and
            # realize a map naming a local ID after this scan (the
            # reference misses it, and the map stays stale).  The
            # running set is read before the maps, so a build that
            # ends between the two reads is seen by the second.
            referencing = []
            if mapping:
                building = self.endpoints.building()
                for ep in self.endpoints.endpoints():
                    if ep.id in rekeyed_ids:
                        continue
                    state = PolicyMapState(ep.realized)
                    if ep.id in building or \
                            any(k.identity in mapping for k in state.keys()):
                        referencing.append(ep.id)
                for eid in rekeyed_ids + referencing:
                    self.endpoints.queue_regeneration(eid)
        finally:
            IDENTITY_COUNT.set(len(self.identity_allocator))
        report = {"promoted": len(mapping), "rekeyed": rekeyed,
                  "cidrs": promoted_cidrs,
                  "regenerated": rekeyed + len(referencing)
                  if mapping else 0}
        if mapping:
            self.monitor.notify_agent(
                "identity-promotion",
                f"promoted={len(mapping)} rekeyed={rekeyed} "
                f"regenerated={report['regenerated']}")
        return report

    def _on_node_update(self, node: Node) -> None:
        self.node_manager.node_updated(node)

    def _on_node_delete(self, full_name: str) -> None:
        self.node_manager.node_deleted(full_name)

    def register_node(self, ipv4: str, pod_cidr: str,
                      hubble_address: str = "") -> Node:
        """Publish this node (pkg/node/store.go:60).  A non-empty
        ``hubble_address`` advertises this agent's /flows observer so
        peers' relays federate through it."""
        from ..node.node import NodeAddress
        node = Node(name=self.node_name,
                    cluster=self.config.cluster_name,
                    cluster_id=self.config.cluster_id,
                    addresses=[NodeAddress(type="InternalIP", ip=ipv4)],
                    ipv4_alloc_cidr=pod_cidr,
                    hubble_address=hubble_address or None)
        if hubble_address and self.hubble_relay is not None:
            # the registry will announce this node under its full
            # name; the relay must not treat that as a remote peer
            self.hubble_relay.local_names.add(node.full_name)
        if self.node_registry is not None:
            self.node_registry.register_local(node)
        return node

    def _hubble_peer_urls(self) -> Dict[str, str]:
        """Relay peer discovery: every node known through the local
        registry or the clustermesh that advertises a Hubble address
        (hubble-relay's peer service, fed from the node store)."""
        out: Dict[str, str] = {}
        registry = getattr(self, "node_registry", None)
        if registry is not None:
            for node in registry.nodes():
                if node.hubble_address:
                    out[node.full_name] = node.hubble_address
        mesh = getattr(self, "clustermesh", None)
        if mesh is not None:
            for node in mesh.peer_nodes():
                if node.hubble_address:
                    out[node.full_name] = node.hubble_address
        return out

    # ----------------------------------------------------------- policy

    def policy_add(self, rules: Sequence[Rule],
                   replace: bool = False) -> int:
        """Import rules (daemon/policy.go:171 PolicyAdd): mark/register
        ToFQDNs rules, allocate CIDR identities + ipcache entries for
        referenced prefixes (one ref per rule occurrence), insert into
        the repo, trigger regeneration.
        """
        t_import = time.perf_counter()
        try:
            for r in rules:
                r.sanitize()
        except Exception:
            POLICY_IMPORT_ERRORS.inc()
            raise
        # FQDN rules: register with the poller; DNS changes re-inject
        # ToCIDRSet and retrigger regeneration (pkg/fqdn/helpers.go:45)
        for r in rules:
            if self._rule_has_fqdn(r):
                with self._lock:
                    self._fqdn_rules.append(r)
                if self.dns_poller is not None:
                    self.dns_poller.register_rule(r)
                inject_to_cidr_set(r, self.dns_cache)

        with self._lock:
            if replace:
                for r in rules:
                    if len(r.labels):
                        self._forget_rules(self.repo.search(r.labels))
                        self.repo.delete_by_labels(r.labels)
            for r in rules:
                prefixes = self._rule_cidr_prefixes(r)
                self._retain_prefixes(prefixes)
                self._rule_prefixes[id(r)] = prefixes
            rev = self.repo.add_list(list(rules))
        POLICY_COUNT.set(len(self.repo))
        POLICY_REVISION.set(rev)
        # policy-propagation tracking: stamp the revision at import;
        # the regeneration pipeline and the engine's revision-served
        # hook fill in compile -> device-apply -> first-verdict, and
        # the delay histogram closes on the last hop
        self.propagation.revision_imported(
            rev, rules=len(rules),
            import_seconds=time.perf_counter() - t_import)
        self.monitor.notify_agent("policy-updated",
                                  f"revision={rev} rules={len(rules)}")
        self.trigger_policy_updates("policy-add")
        return rev

    def policy_delete(self, labels) -> Tuple[int, int]:
        """daemon/policy.go PolicyDelete: drop rules, release their CIDR
        identity refs, deregister their FQDN state."""
        with self._lock:
            doomed = self.repo.search(labels) if len(labels) else \
                self.repo.rules
            rev, deleted = self.repo.delete_by_labels(labels)
            if deleted:
                self._forget_rules(doomed)
        POLICY_COUNT.set(len(self.repo))
        POLICY_REVISION.set(rev)
        if deleted:
            self.monitor.notify_agent(
                "policy-deleted", f"revision={rev} rules={deleted}")
            self.trigger_policy_updates("policy-delete")
        return rev, deleted

    def _forget_rules(self, doomed: Sequence[Rule]) -> None:
        """Release per-rule CIDR refs + FQDN registration (lock held)."""
        doomed_ids = {id(r) for r in doomed}
        for r in doomed:
            self._release_prefixes(
                self._rule_prefixes.pop(id(r), None) or
                self._rule_cidr_prefixes(r))
        self._fqdn_rules = [r for r in self._fqdn_rules
                            if id(r) not in doomed_ids]

    def _resync_rule_prefixes_locked(self, rule: Rule) -> bool:
        """Re-diff one rule's CIDR prefixes against its held refs and
        retain/release the delta (newly referenced IPs need identities
        + ipcache entries or their CIDR labels never match). Returns
        True when anything changed. Lock held."""
        old = self._rule_prefixes.get(id(rule), [])
        new = self._rule_cidr_prefixes(rule)
        if new == old:
            return False
        old_set, new_set = set(old), set(new)
        self._retain_prefixes(sorted(new_set - old_set))
        self._release_prefixes(sorted(old_set - new_set))
        self._rule_prefixes[id(rule)] = new
        return True

    def resync_rule_prefixes(self, rules: Sequence[Rule]) -> int:
        """Public entry for translators that rewrite rules in place
        (k8s ToServices, FQDN): returns rules whose refs changed."""
        n = 0
        with self._lock:
            live = {id(x) for x in self.repo.rules}
            for r in rules:
                if id(r) in self._rule_prefixes or id(r) in live:
                    if self._resync_rule_prefixes_locked(r):
                        n += 1
        return n

    def _retain_prefixes(self, prefixes: Sequence[str]) -> None:
        """One ref per occurrence (lock held)."""
        for p in prefixes:
            if p in self._cidr_idents:
                ident, n = self._cidr_idents[p]
                self._cidr_idents[p] = (ident, n + 1)
            else:
                allocated = allocate_cidr_identities(
                    self.identity_allocator, self.ipcache, [p])
                self._cidr_idents[p] = (allocated[p], 1)

    def _release_prefixes(self, prefixes: Sequence[str]) -> None:
        for p in prefixes:
            ident, n = self._cidr_idents.get(p, (None, 0))
            if ident is None:
                continue
            if n <= 1:
                release_cidr_identities(
                    self.identity_allocator, self.ipcache, {p: ident})
                del self._cidr_idents[p]
            else:
                self._cidr_idents[p] = (ident, n - 1)

    @staticmethod
    def _rule_has_fqdn(rule: Rule) -> bool:
        return any(getattr(eg, "to_fqdns", None) for eg in rule.egress)

    @staticmethod
    def _rule_cidr_prefixes(rule: Rule) -> List[str]:
        """Every CIDR prefix one rule references (incl. FQDN-injected
        to_cidr_set entries)."""
        out: List[str] = []
        for ing in rule.ingress:
            out.extend(c for c in getattr(ing, "from_cidr", []) or [])
            out.extend(c.cidr for c in
                       getattr(ing, "from_cidr_set", []) or [])
        for eg in rule.egress:
            out.extend(c for c in getattr(eg, "to_cidr", []) or [])
            out.extend(c.cidr for c in
                       getattr(eg, "to_cidr_set", []) or [])
        return sorted(set(out))

    def trigger_policy_updates(self, reason: str) -> None:
        """daemon/policy.go:48 TriggerPolicyUpdates."""
        self._regen_trigger.trigger(reason)

    def policy_get(self, labels=None) -> Dict:
        from ..policy.jsonio import rule_to_dict
        rules = self.repo.search(labels) if labels else self.repo.rules
        return {"revision": self.repo.revision,
                "policy": [rule_to_dict(r) for r in rules]}

    def policy_resolve(self, from_labels, to_labels,
                       dports=None, verbose: bool = False) -> Dict:
        """GET /policy/resolve (daemon/policy.go:67): traced verdict."""
        from ..policy.trace import Port
        ports = [Port(port=p, protocol="TCP") if isinstance(p, int) else p
                 for p in (dports or [])]
        ctx = traced_context(from_labels=from_labels, to_labels=to_labels,
                             dports=ports, verbose=verbose)
        verdict = self.repo.allows_ingress(ctx)
        return {"verdict": str(verdict), "trace": ctx.trace_output()}

    # ------------------------------------- verdict provenance surfaces

    def policy_trace_replay(self, endpoint_id: int,
                            identity: Optional[int] = None,
                            labels: Optional[Sequence[str]] = None,
                            dport: int = 0, proto: int = 6,
                            direction: str = "egress") -> Dict:
        """`cilium policy trace --replay` / POST /policy/trace:
        synthesize a header tuple for one local endpoint, run it
        through the REAL compiled device tables, and explain the
        verdict per tier, naming the PolicyKey that matched.  The
        device result is diffed in-line against the host
        compute_desired_policy_map_state oracle (the endpoint's
        realized state), so a compiler bug surfaces as drift right in
        the trace output.  Raises KeyError for an unknown endpoint."""
        from ..compiler.policy_tables import oracle_provenance
        from ..datapath.events import tier_name
        from ..policy.mapstate import EGRESS, INGRESS
        ep = self.endpoints.lookup(endpoint_id)
        if ep is None or ep.table_slot is None:
            raise KeyError(endpoint_id)
        if identity is None:
            if not labels:
                raise ValueError("need identity or labels")
            ident = self.identity_allocator.lookup_by_labels(
                Labels.from_model(list(labels)))
            if ident is None:
                raise ValueError(f"no identity for labels {labels}")
            identity = ident.id
        dirc = EGRESS if str(direction).lower() in ("egress", "1") \
            else INGRESS
        realized = PolicyMapState(ep.realized)
        row = self.datapath.policy_replay(
            [ep.table_slot], [identity], [dport], [proto], [dirc])[0]
        o_verdict, o_tier, o_key = oracle_provenance(
            realized, identity, dport, proto, dirc)
        drift = row["verdict"] != o_verdict or row["tier"] != o_tier

        def key_str(k) -> str:
            if k is None:
                return "no entry"
            if isinstance(k, dict):
                return (f"PolicyKey(identity={k['identity']}, "
                        f"dport={k['dport']}, proto={k['proto']}, "
                        f"dir={'in' if k['direction'] == 0 else 'e'}"
                        f"gress)")
            return (f"PolicyKey(identity={k.identity}, "
                    f"dport={k.dest_port}, proto={k.nexthdr}, "
                    f"dir={'in' if k.direction == 0 else 'e'}gress)")

        stage_titles = (
            ("exact", "stage 1 exact (identity, dport, proto)"),
            ("l3", "stage 2 L3-only (identity)"),
            ("l4_wildcard", "stage 3 L4-wildcard (identity=0)"))
        lines = [f"Replaying endpoint {endpoint_id} (table slot "
                 f"{ep.table_slot}): identity {identity} -> "
                 f"dport {dport}/proto {proto} {direction} "
                 f"through compiled revision {self.datapath.revision}"]
        for name, title in stage_titles:
            st = row["stages"][name]
            if st["found"]:
                lines.append(
                    f"  {title}: MATCH {key_str(st['key'])}"
                    + (f" -> proxy {st['value']}" if st["value"] > 0
                       else " -> allow"))
            else:
                lines.append(f"  {title}: no match")
        lines.append(
            f"  decision: tier={row['tier-name']} "
            f"verdict={row['verdict']} "
            f"({key_str(row['matched'])})")
        lines.append(
            "  oracle: " +
            (f"DIVERGENCE — host oracle says verdict={o_verdict} "
             f"tier={tier_name(o_tier)} ({key_str(o_key)})" if drift
             else "device and host compute_desired_policy_map_state "
                  "agree"))
        out = {"endpoint": endpoint_id, "identity": identity,
               "dport": dport, "proto": proto, "direction": direction,
               "device": row,
               "oracle": {"verdict": o_verdict,
                          "tier": tier_name(o_tier),
                          "key": key_str(o_key)},
               "drift": drift, "explanation": lines}
        with self._lock:
            self._last_replay = out
        if drift:
            from ..utils.metrics import POLICY_DRIFT
            POLICY_DRIFT.inc()
        return out

    def run_drift_audit(self, samples: Optional[int] = None) -> Dict:
        """One drift-audit sweep: replay sampled tuples through the
        compiled device tables and diff verdict+tier against the host
        oracles.  Per endpoint the sample mixes installed keys (which
        must keep deciding exactly as computed) with random tuples
        (which must keep falling through identically); a handful of
        cached identities additionally cross-check the SearchContext
        label simulation against the realized L3 entries.  Divergences
        found on a first pass are re-replayed once against a fresh
        snapshot before counting, so an in-flight regeneration can't
        fake drift.  Updates policy_drift_total and the status()
        provenance block; returns the report."""
        from ..compiler.policy_tables import oracle_provenance
        from ..datapath.events import TIER_L3_ALLOW, tier_name
        from ..policy.api import Decision
        from ..policy.mapstate import INGRESS, PolicyKey
        from ..utils.metrics import POLICY_DRIFT, POLICY_DRIFT_AUDIT_RUNS
        t0 = time.time()
        budget = samples or self.config.drift_audit_samples
        eps = [ep for ep in self.endpoints.endpoints()
               if ep.table_slot is not None]
        report: Dict = {"status": "idle", "checked": 0,
                        "sc-checked": 0, "divergences": [],
                        "endpoints": len(eps), "skipped": 0,
                        "last-run": t0}
        if not eps or self.datapath._tables is None:
            with self._lock:
                self._drift_report = report
            return report
        rng = self._drift_rng
        per_ep = max(2, budget // len(eps))

        rows = []  # one audit probe per row
        for ep in eps:
            rev = ep.policy_revision
            state = PolicyMapState(ep.realized)
            keys = list(state.keys())
            picked = [keys[i] for i in
                      rng.permutation(len(keys))[:per_ep]] if keys else []
            tuples = []
            for k in picked:
                # wildcard keys get a random identity so the probe
                # exercises the stage-3 fallback, not slot 0
                ident = k.identity or int(rng.integers(256, 1 << 20))
                tuples.append((ident, k.dest_port, k.nexthdr,
                               k.direction))
            for _ in range(max(1, per_ep // 2)):
                tuples.append((int(rng.integers(256, 1 << 20)),
                               int(rng.integers(1, 65536)), 6,
                               int(rng.integers(0, 2))))
            for t in tuples:
                rows.append({"ep": ep, "slot": ep.table_slot,
                             "rev": rev, "state": state, "t": t})

        def replay_rows(batch):
            return self.datapath.policy_replay(
                [r["slot"] for r in batch],
                [r["t"][0] for r in batch],
                [r["t"][1] for r in batch],
                [r["t"][2] for r in batch],
                [r["t"][3] for r in batch])

        def diverges(row, dev) -> Optional[Dict]:
            ident, dport, proto, dirc = row["t"]
            o_verdict, o_tier, o_key = oracle_provenance(
                row["state"], ident, dport, proto, dirc)
            if dev["verdict"] == o_verdict and dev["tier"] == o_tier:
                return None
            return {"endpoint": row["ep"].id,
                    "tuple": {"identity": ident, "dport": dport,
                              "proto": proto, "direction": dirc},
                    "device": {"verdict": dev["verdict"],
                               "tier": dev["tier-name"],
                               "matched": dev["matched"]},
                    "oracle": {"verdict": o_verdict,
                               "tier": tier_name(o_tier),
                               "key": str(o_key)},
                    "source": "compute_desired_policy_map_state"}

        suspects = []
        checked = skipped = 0
        for row, dev in zip(rows, replay_rows(rows)):
            if row["ep"].policy_revision != row["rev"]:
                skipped += 1
                continue
            checked += 1
            d = diverges(row, dev)
            if d is not None:
                suspects.append((row, d))
        # second look: a regeneration between snapshot and replay can
        # fake drift — re-snapshot + re-replay just the suspects and
        # keep only the persistent ones
        divergences = []
        if suspects:
            retry = []
            for row, _d in suspects:
                retry.append({**row,
                              "rev": row["ep"].policy_revision,
                              "state": PolicyMapState(
                                  row["ep"].realized)})
            for row, dev in zip(retry, replay_rows(retry)):
                d = diverges(row, dev)
                if d is not None and \
                        row["ep"].policy_revision == row["rev"]:
                    divergences.append(d)

        # SearchContext cross-check (policy/trace.py simulation):
        # repo label decision -> realized L3 entry -> device l3-allow
        # tier must tell one story for identities with known labels
        sc_checked = 0
        cache = IdentityCache.snapshot(self.identity_allocator)
        # reserved identities are excluded: their L3 entries can be
        # installed by infrastructure, not selector policy (e.g. the
        # reserved:host allow that rides along with any L7 redirect,
        # mapstate.py LOCALHOST_KEY) — the label simulation would
        # report false drift against them
        sc_idents = [(n, la) for n, la in cache.items()
                     if not idpkg.is_reserved_identity(n)]
        sc_idents = [sc_idents[i]
                     for i in rng.permutation(len(sc_idents))]
        for ep in eps[:4]:
            if ep.policy_revision != self.repo.revision:
                # behind: not yet regenerated against current rules.
                # AHEAD: restored from checkpoint while the repo is
                # empty/older (the pinned-map window, daemon/state.go)
                # — the realized state deliberately outlives the repo
                # until re-import, so the label simulation would
                # report false drift
                continue
            cfg = ep.policy_config(self.config.always_allow_localhost())
            if not cfg.ingress_enforcement:
                continue  # every identity legitimately gets an L3 key
            state = PolicyMapState(ep.realized)
            ep_labels = ep.label_array()
            for num, id_labels in sc_idents[:4]:
                ctx = SearchContext(from_labels=id_labels,
                                    to_labels=ep_labels)
                decision = self.repo.allows_ingress_label_access(ctx)
                has_l3 = PolicyKey(identity=num,
                                   direction=INGRESS) in state
                dev = self.datapath.policy_replay(
                    [ep.table_slot], [num], [0], [0], [INGRESS])[0]
                dev_l3 = dev["tier"] == TIER_L3_ALLOW and \
                    dev["verdict"] == 0
                sc_checked += 1
                if (decision == Decision.ALLOWED) != has_l3 or \
                        has_l3 != dev_l3:
                    if ep.policy_revision != self.repo.revision:
                        continue  # regeneration raced the check
                    divergences.append({
                        "endpoint": ep.id,
                        "tuple": {"identity": num, "dport": 0,
                                  "proto": 0, "direction": INGRESS},
                        "device": {"verdict": dev["verdict"],
                                   "tier": dev["tier-name"]},
                        "oracle": {
                            "search-context": str(decision),
                            "realized-l3-entry": has_l3},
                        "source": "SearchContext"})

        if divergences:
            POLICY_DRIFT.inc(len(divergences))
        POLICY_DRIFT_AUDIT_RUNS.inc(labels={
            "result": "drift" if divergences else "ok"})
        report.update(
            status="FAILING" if divergences else "ok",
            checked=checked, skipped=skipped, sc_checked=sc_checked,
            divergences=divergences[:16],
            duration_s=round(time.time() - t0, 4))
        report["sc-checked"] = report.pop("sc_checked")
        report["duration-s"] = report.pop("duration_s")
        with self._lock:
            prev = (self._drift_report or {}).get("status")
            self._drift_report = report
        # flight recorder: every FAILING sweep is an incident event
        # (the compiler-correctness verdict), plus the all-clear
        # transition when a failing audit goes green again
        if report["status"] == "FAILING" or \
                (prev == "FAILING" and report["status"] == "ok"):
            from ..observability.events import (EVENT_DRIFT_AUDIT,
                                                recorder)
            recorder.record(
                EVENT_DRIFT_AUDIT, status=report["status"],
                divergences=len(report["divergences"]),
                checked=report["checked"],
                detail=str(report["divergences"][:1])
                if report["divergences"] else "audit back to ok")
        return report

    def _dataplane_recovery_gate(self) -> bool:
        """The device lane's resumption gate: after the supervisor
        rebuilds the tables from the host-of-record, a drift-audit
        replay must come back clean before the half-open probe may
        dispatch — a corrupted rebuild re-opens the breaker instead of
        serving wrong verdicts."""
        report = self.run_drift_audit(
            samples=min(32, self.config.drift_audit_samples))
        return report.get("status") in ("ok", "idle")

    def drift_report(self) -> Optional[Dict]:
        with self._lock:
            return self._drift_report

    def last_replay_report(self) -> Optional[Dict]:
        with self._lock:
            return self._last_replay

    # ------------------------------------- incident flight recorder

    def flight_events(self, since: int = 0, limit: int = 200,
                      event_type: Optional[str] = None,
                      shard: Optional[int] = None) -> Dict:
        """GET /debug/events / ``cilium-tpu events``: the ordered
        incident timeline — every degraded-condition transition the
        agent recorded, cursor-paginated like the monitor ring."""
        from ..observability.events import recorder
        return {"events": [e.to_dict() for e in
                           recorder.events(since, limit, event_type,
                                           shard)],
                "seq": recorder.last_seq,
                "stats": recorder.stats()}

    # ------------------------------------- inline threat scoring

    def _threat_config_from_options(self):
        from ..threat import ThreatConfig
        c = self.config
        return ThreatConfig(
            mode=c.threat_mode,
            drop_score=c.threat_drop_score,
            redirect_score=c.threat_redirect_score,
            ratelimit_score=c.threat_ratelimit_score,
            redirect_port=c.threat_redirect_port,
            rate_per_s=c.threat_rate_per_s, burst=c.threat_burst)

    def threat_status(self) -> Dict:
        """status()["threat"] / GET /threat: mode (off / shadow /
        enforce), the live thresholds + model generation, and verdict
        accounting.  An ENFORCING threat plane is a degraded-signal
        section by design — an operator must see that a model can now
        override policy-allowed traffic (DEGRADED_SIGNALS covers it
        with the threat-mode/model-push flight-recorder events)."""
        from ..utils.metrics import THREAT_VERDICTS
        report = self.datapath.threat_report() \
            if hasattr(self.datapath, "threat_report") else None
        if report is None:
            return {"mode": "off"}
        out = {"mode": report["config"]["mode"], "model": report,
               "verdicts": {
                   o: int(THREAT_VERDICTS.value(labels={"outcome": o}))
                   for o in ("scored", "rate-limited", "redirected",
                             "dropped")}}
        if out["mode"] == "enforce":
            out["status"] = ("ENFORCING: threat scores can drop/"
                             "rate-limit/redirect allowed traffic "
                             f"(thresholds {report['config']})")
        return out

    def threat_set_config(self, **changes) -> Dict:
        """Update the policy-controlled threat thresholds / mode (ONE
        region write into the live packed buffer — no repack, no
        re-jit, no serving pause).  Mode flips land in the incident
        flight recorder: enforcement changes are exactly the kind of
        transition an operator replays a timeline for."""
        from dataclasses import replace as _replace
        from ..observability.events import EVENT_THREAT_MODE
        report = self.datapath.threat_report()
        if report is None:
            raise KeyError("threat scoring not enabled")
        from ..threat import ThreatConfig
        cur = ThreatConfig(**{k.replace("-", "_"): v for k, v in
                              report["config"].items()
                              if k != "generation"},
                           generation=report["config"]["generation"])
        allowed = {"mode", "drop_score", "redirect_score",
                   "ratelimit_score", "redirect_port", "rate_per_s",
                   "burst"}
        bad = set(changes) - allowed
        if bad:
            raise ValueError(f"unknown threat config fields: {bad}")
        if changes.get("mode") not in (None, "shadow", "enforce"):
            raise ValueError("mode must be shadow|enforce")
        new = _replace(cur, **changes)
        self.datapath.set_threat_config(new)
        if new.mode != cur.mode:
            flight_recorder.record(EVENT_THREAT_MODE,
                                   f"threat mode {cur.mode} -> "
                                   f"{new.mode}", mode=new.mode)
            self.monitor.notify_agent("threat-mode", new.mode)
        return new.describe()

    def threat_push_model(self, model) -> Dict:
        """Hot-swap trained scorer weights through the delta-apply
        leaf-write path (same-geometry pushes never repack and never
        pause serving); bumps the generation gauge and rings the
        flight-recorder push event."""
        from dataclasses import replace as _replace
        from ..observability.events import EVENT_THREAT_MODEL
        from ..utils.metrics import THREAT_MODEL_GENERATION
        report = self.datapath.threat_report()
        if report is None:
            raise KeyError("threat scoring not enabled")
        gen = int(report["config"]["generation"]) + 1
        model = model.with_config(
            _replace(model.config, generation=gen))
        fast = self.datapath.apply_threat_weights(model)
        THREAT_MODEL_GENERATION.set(gen)
        flight_recorder.record(EVENT_THREAT_MODEL,
                               f"threat model generation {gen}",
                               generation=gen, repacked=not fast)
        return {"generation": gen, "hot-swap": bool(fast),
                "model": model.describe()}

    def threat_train(self, max_flows: int = 4096,
                     labels: Optional[List[int]] = None) -> Dict:
        """Fit a new scorer from the aggregated flow plane (the
        federated per-shard drains land in the same flow snapshot
        surface) and push it through the hot-swap path.  Returns the
        training report + push result."""
        if self._threat_trainer is None:
            raise KeyError("threat scoring not enabled")
        flows = self.datapath.flow_snapshot(max_flows)
        if not flows and self.hubble is not None:
            # no device flow table: fall back to the observer ring
            flows = [{"packets": 1, "bytes": f.length or 0,
                      "dport": f.dport, "proto": f.proto,
                      "event": f.event,
                      "src-identity": f.src_identity,
                      "dst-identity": f.dst_identity,
                      "last-seen": int(f.timestamp)}
                     for f in self.hubble.get_flows(limit=max_flows)]
        report = self.datapath.threat_report()
        from ..threat import ThreatConfig
        cfg = ThreatConfig(**{k.replace("-", "_"): v for k, v in
                              report["config"].items()})
        model = self._threat_trainer.fit(flows, labels=labels,
                                         config=cfg)
        push = self.threat_push_model(model)
        return {"training": self._threat_trainer.last_report,
                "push": push}

    # ------------------------------------- device traffic analytics

    def _analytics_sections(self, swap: bool) -> Optional[Dict]:
        """One decoded-epoch fetch shaped like the sharded answer for
        both dataplane shapes: the sharded datapath merges per-shard
        sections behind per-shard breakers (fail-open); the single
        engine swaps + snapshots locally."""
        dp = self.datapath
        if hasattr(dp, "analytics_sections"):
            return dp.analytics_sections(swap=swap)
        from ..analytics.decode import epoch_section, quiesced_section
        report = dp.analytics_report()
        if report is None:
            return None
        depth, lanes = report["depth"], report["lanes"]
        if swap:
            epoch = dp.swap_analytics_epoch()
            section = epoch_section(dp.analytics_snapshot(), epoch,
                                    depth, lanes)
        else:
            section = quiesced_section(dp.analytics_snapshot(), depth,
                                       lanes)
        return {"sections": [section], "shards": {"0": {"status": "ok"}},
                "partial": False, "depth": depth, "lanes": lanes}

    def analytics_drain(self) -> Dict:
        """The analytics-drain controller body: flip the device A/B
        epoch, decode the newly quiesced section, export the
        capped-cardinality ``analytics_top_bytes{identity}`` gauge,
        and ring heavy-hitter / scan-suspect THRESHOLD TRANSITIONS
        into the flight recorder (edge-triggered per identity — a
        sustained hitter is one event, not one per drain)."""
        from ..analytics.decode import (merge_sections, top_scanners,
                                        top_talkers)
        from ..observability.events import (EVENT_TRAFFIC_HEAVY_HITTER,
                                            EVENT_TRAFFIC_SCAN_SUSPECT)
        from ..utils.metrics import (ANALYTICS_DRAINS,
                                     ANALYTICS_SCAN_SUSPECTS,
                                     ANALYTICS_TOP_BYTES)
        secs = self._analytics_sections(swap=True)
        if secs is None:
            return {"status": "off"}
        k = self.config.analytics_top_k
        result = "partial" if secs["partial"] else "ok"
        ANALYTICS_DRAINS.inc(labels={"result": result})
        if not secs["sections"]:
            out = {"status": result, "shards": secs["shards"],
                   "top": [], "suspects": []}
            with self._lock:
                self._analytics_last = out
            return out
        merged = merge_sections(secs["sections"], secs["depth"],
                                secs["lanes"])
        top = top_talkers(merged, secs["depth"], k=k, metric="bytes")
        total = sum(e["count"] for e in top) or 1
        # capped-cardinality export: only the CURRENT top-K identities
        # carry a live series; evicted ones zero out, so the label set
        # never grows past k live values under identity churn
        current = {e["identity"] for e in top}
        for ident in self._analytics_exported - current:
            ANALYTICS_TOP_BYTES.set(0, labels={"identity": str(ident)})
        for e in top:
            ANALYTICS_TOP_BYTES.set(
                e["count"], labels={"identity": str(e["identity"])})
        self._analytics_exported = current
        # heavy-hitter share transitions (edge-triggered per identity)
        share_bar = self.config.analytics_hh_share
        hitters = {e["identity"]: e for e in top
                   if e["count"] / total >= share_bar}
        for ident in set(hitters) - self._analytics_hh_live:
            e = hitters[ident]
            flight_recorder.record(
                EVENT_TRAFFIC_HEAVY_HITTER,
                f"identity {ident} at "
                f"{e['count'] / total:.0%} of epoch bytes",
                identity=ident, share=round(e["count"] / total, 3),
                bytes=e["count"])
        self._analytics_hh_live = set(hitters)
        # scan-suspect transitions from the (identity, dport) view
        scans = top_scanners(merged, secs["depth"], k=k,
                             min_dports=self.config.analytics_scan_ports)
        suspects = {e["identity"]: e for e in scans if e["suspect"]}
        ANALYTICS_SCAN_SUSPECTS.set(len(suspects))
        for ident in set(suspects) - self._analytics_scan_live:
            e = suspects[ident]
            flight_recorder.record(
                EVENT_TRAFFIC_SCAN_SUSPECT,
                f"identity {ident} touched {e['dports']} distinct "
                f"dports in one epoch",
                identity=ident, ports=e["dports"],
                packets=e["packets"])
        self._analytics_scan_live = set(suspects)
        out = {"status": result, "shards": secs["shards"], "top": top,
               "suspects": sorted(suspects)}
        with self._lock:
            self._analytics_last = out
        return out

    def analytics_top(self, view: str = "talkers", k: int = 10,
                      metric: str = "bytes") -> Dict:
        """GET /analytics/top / ``cilium-tpu top``: one mesh-wide
        top-K answer decoded from the QUIESCED epoch sections (no
        swap — reads race nothing and serving never pauses).  Raises
        KeyError when analytics is not enabled or the view/metric is
        unknown."""
        from ..analytics.decode import (METRICS, VIEWS, decode_view,
                                        merge_sections)
        from ..utils.metrics import ANALYTICS_QUERIES
        if view not in VIEWS:
            raise KeyError(f"unknown analytics view {view!r} "
                           f"(expected one of {VIEWS})")
        if metric not in METRICS:
            raise KeyError(f"unknown analytics metric {metric!r} "
                           f"(expected one of {tuple(METRICS)})")
        secs = self._analytics_sections(swap=False)
        if secs is None:
            raise KeyError("traffic analytics not enabled")
        if secs["sections"]:
            merged = merge_sections(secs["sections"], secs["depth"],
                                    secs["lanes"])
            entries = decode_view(merged, view, secs["depth"],
                                  secs["lanes"], k=k, metric=metric)
        else:
            entries = []
        out = {"view": view, "metric": metric, "entries": entries,
               "partial": secs["partial"], "shards": secs["shards"]}
        ANALYTICS_QUERIES.inc(labels={
            "view": view,
            "result": "partial" if out["partial"] else "ok"})
        return out

    def analytics_status(self) -> Dict:
        """status()["analytics"] / GET /analytics: geometry + write
        epoch, the last drain's outcome, and live anomaly counts.  A
        partial drain reports loudly — the mesh-wide decode is missing
        a shard's traffic (fail-open, the federation precedent)."""
        report = self.datapath.analytics_report() \
            if hasattr(self.datapath, "analytics_report") else None
        if report is None:
            # "status" stays present so the loudness lint counts the
            # section as a covered degraded-signal surface
            return {"enabled": False, "status": "off"}
        with self._lock:
            last = self._analytics_last
        out = {"enabled": True, "report": report,
               "last-drain": last,
               "heavy-hitters": sorted(self._analytics_hh_live),
               "scan-suspects": sorted(self._analytics_scan_live)}
        if last is not None and last.get("status") == "partial":
            bad = [k for k, s in (last.get("shards") or {}).items()
                   if s.get("status") != "ok"]
            out["status"] = (
                f"PARTIAL: analytics shard(s) {bad} unreadable — "
                f"mesh-wide top-K decode is missing their traffic "
                f"(remaining shards still answer, fail-open)")
        else:
            out["status"] = "ok"
        return out

    # -------------------------------------------------- regeneration

    def _regenerate_endpoint(self, ep: Endpoint) -> None:
        """The per-endpoint build (endpoint/policy.go regenerate tail):
        resolve policy, allocate redirects, diff, swap device tables."""
        cache = IdentityCache.snapshot(self.identity_allocator)
        # stage spans parent on the revision's import trace via
        # explicit context — this runs on a build-worker thread, so
        # thread-local propagation cannot carry it
        with self.propagation.stage_span(
                self.repo.revision, "policy.compile",
                {"endpoint": ep.id}):
            res = ep.regenerate_policy(
                self.repo, cache, proxy=self.proxy,
                always_allow_localhost=self.config
                .always_allow_localhost())
        self.propagation.revision_compiled(res.revision)
        POLICY_REGENERATION_COUNT.inc()
        ep.apply_regeneration(res)
        PROXY_REDIRECTS.set(len(self.proxy))
        if self.host_path is not None:
            self.host_path.sync_endpoint(ep.id, ep.realized)
            # a delete racing this build could have already removed the
            # cache; re-check so we never resurrect a deleted endpoint
            if self.endpoints.lookup(ep.id) is None:
                self.host_path.remove_endpoint(ep.id)
        # incremental device sync: this endpoint's row only
        # (endpoint/bpf.go:607 syncPolicyMap analog)
        with self.propagation.stage_span(
                res.revision, "policy.device-apply",
                {"endpoint": ep.id}):
            self.table_mgr.sync_endpoint(ep.id, ep.realized,
                                         res.revision)
            self.datapath.refresh_policy(res.revision)
        self.propagation.revision_applied(res.revision)
        if self.config.state_dir:
            try:
                ep.write_checkpoint(self.config.state_dir)
            except OSError:
                pass

    # -------------------------------------------------- endpoints

    def addressing(self) -> Dict:
        """Node addressing block (models.NodeAddressing analog) served
        in GET /config — what the docker libnetwork driver and CNI use
        to build pools/routes (plugins/cilium-docker/driver/driver.go
        NewDriver's ConfigGet)."""
        out = {"ipv4": {"ip": self.host_ipv4,
                        "alloc-range": str(self.ipam.network),
                        "enabled": self.config.enable_ipv4}}
        if self.ipam6 is not None:
            out["ipv6"] = {"ip": self.host_ipv6,
                           "alloc-range": str(self.ipam6.network),
                           "enabled": True}
        return out

    def ipam_allocate(self, family: str = "ipv4",
                      owner: str = "") -> Dict:
        """POST /ipam (daemon/ipam.go AllocateIP): next free address
        of the family, plus current host addressing (the reference
        returns it so clients can refresh routes after a restart)."""
        if family not in ("ipv4", "ipv6"):
            raise IPAMError(f"unknown address family {family!r}")
        # the pool object always exists for v4 (host addressing and
        # endpoint lifecycle claims need it) but allocation honours the
        # enable flag, matching how ipam6 is gated at construction
        if family == "ipv4" and not self.config.enable_ipv4:
            raise IPAMError("family 'ipv4' not enabled")
        pool = self.ipam6 if family == "ipv6" else self.ipam
        if pool is None:
            raise IPAMError(f"family {family!r} not enabled")
        ip = pool.allocate_next(owner)
        return {"address": {family: ip},
                "host-addressing": self.addressing()}

    def ipam_release(self, ip: str) -> bool:
        """DELETE /ipam/{ip}: release from whichever family owns it."""
        if self.ipam.release(ip):
            return True
        return self.ipam6.release(ip) if self.ipam6 is not None \
            else False

    def endpoint_create(self, endpoint_id: int, ipv4: str = "",
                        container_name: str = "",
                        labels: Optional[Sequence[str]] = None
                        ) -> Endpoint:
        """PUT /endpoint/{id} (daemon/endpoint.go + CNI ADD path):
        allocate identity, publish ip->identity, queue first build.

        Claims the IP in the host-scope allocator FIRST: an address
        another live endpoint already holds is a hard conflict
        (IPAMError -> 409), while a docker-flow claim ("docker" owner
        from POST /ipam) is the expected hand-off and stands."""
        if ipv4:
            try:
                self.ipam.allocate_ip(ipv4,
                                      owner=f"endpoint:{endpoint_id}")
            except IPAMError:
                holder = self.ipam.owner_of(ipv4)
                if holder is not None and \
                        holder.startswith("endpoint:") and \
                        holder != f"endpoint:{endpoint_id}":
                    raise IPAMError(
                        f"{ipv4} already in use by {holder}")
                # outside the pool, or a non-endpoint claim (docker
                # flow) whose owner releases it — proceed
        did_upsert = False
        try:
            ep = Endpoint(endpoint_id, ipv4=ipv4,
                          container_name=container_name,
                          opts=self.config.opts.fork())
            ep.table_slot = self.table_mgr.attach(endpoint_id)
            self.endpoints.insert(ep)
            ep.update_labels(self.identity_allocator,
                             Labels.from_model(list(labels or [])))
            self.datapath.set_endpoint_identity(ep.table_slot,
                                                ep.security_identity)
            IDENTITY_COUNT.set(len(self.identity_allocator))
            if ipv4:
                self.ipcache.upsert(ipv4, ep.security_identity,
                                    SOURCE_AGENT_LOCAL,
                                    metadata=f"endpoint:{endpoint_id}")
                did_upsert = True
        except BaseException:
            # failed create must not strand ANY of its claims on a
            # ghost endpoint: IP, ipcache entry, device-table slot,
            # identity refcount (detach/release are no-ops for steps
            # that never ran).  The ipcache delete is gated on OUR
            # upsert having happened: an out-of-pool IP that failed
            # earlier may still be another endpoint's live mapping
            if ipv4:
                self.ipam.release_if_owner(ipv4,
                                           f"endpoint:{endpoint_id}")
                if did_upsert:
                    self.ipcache.delete(ipv4, SOURCE_AGENT_LOCAL)
            ghost = self.endpoints.remove(endpoint_id)
            if ghost is not None and ghost.identity is not None:
                self.identity_allocator.release(ghost.identity)
            self.table_mgr.detach(endpoint_id)
            raise
        self.monitor.notify_agent("endpoint-created",
                                  f"id={endpoint_id} ipv4={ipv4}")
        self.endpoints.queue_regeneration(endpoint_id)
        return ep

    def endpoint_delete(self, endpoint_id: int) -> bool:
        ep = self.endpoints.remove(endpoint_id)
        if ep is None:
            return False
        ep.set_state(EndpointState.DISCONNECTING, "delete")
        if ep.ipv4:
            self.ipcache.delete(ep.ipv4, SOURCE_AGENT_LOCAL)
            # free only our own lifecycle claim (docker-flow addresses
            # are released by IpamDriver.ReleaseAddress)
            self.ipam.release_if_owner(ep.ipv4,
                                       f"endpoint:{endpoint_id}")
        for rid in list(ep.proxy_redirects):
            self.proxy.remove_redirect(rid)
        ep.proxy_redirects = {}
        if ep.identity is not None:
            self.identity_allocator.release(ep.identity)
            IDENTITY_COUNT.set(len(self.identity_allocator))
        ep.set_state(EndpointState.DISCONNECTED, "delete")
        if self.host_path is not None:
            self.host_path.remove_endpoint(endpoint_id)
        if self.config.state_dir:
            try:
                os.remove(os.path.join(self.config.state_dir,
                                       f"ep_{endpoint_id}.json"))
            except OSError:
                pass
        self.table_mgr.detach(endpoint_id)
        self.datapath.refresh_policy()
        self.monitor.notify_agent("endpoint-deleted",
                                  f"id={endpoint_id}")
        return True

    def endpoint_update_labels(self, endpoint_id: int,
                               labels: Sequence[str]) -> bool:
        """Returns True if the identity changed; raises KeyError for an
        unknown endpoint (the REST layer 404s)."""
        ep = self.endpoints.lookup(endpoint_id)
        if ep is None:
            raise KeyError(endpoint_id)
        changed = ep.update_labels(self.identity_allocator,
                                   Labels.from_model(list(labels)))
        if changed:
            if ep.table_slot is not None:
                self.datapath.set_endpoint_identity(ep.table_slot,
                                                    ep.security_identity)
            if ep.ipv4:
                self.ipcache.upsert(ep.ipv4, ep.security_identity,
                                    SOURCE_AGENT_LOCAL,
                                    metadata=f"endpoint:{endpoint_id}")
            self.endpoints.queue_regeneration(endpoint_id)
        return changed

    def endpoint_config_patch(self, endpoint_id: int,
                              changes: Dict[str, object]) -> int:
        """PATCH /endpoint/{id}/config — option change triggers rebuild
        (pkg/option applyOptsLocked semantics)."""
        ep = self.endpoints.lookup(endpoint_id)
        if ep is None:
            raise KeyError(endpoint_id)
        parsed = {k: parse_option_value(v) for k, v in changes.items()}
        n = ep.opts.apply_validated(parsed)
        if n:
            ep.set_state(EndpointState.WAITING_TO_REGENERATE,
                         "config change")
            self.endpoints.queue_regeneration(endpoint_id)
        return n

    def config_patch(self, changes: Dict[str, object]) -> int:
        """PATCH /config — daemon-wide option change regenerates all."""
        parsed = {k: parse_option_value(v) for k, v in changes.items()}
        n = self.config.opts.apply_validated(parsed)
        if n:
            for ep in self.endpoints.endpoints():
                ep.opts.apply_validated(parsed)
            self.trigger_policy_updates("config-change")
        return n

    # -------------------------------------------------- state restore

    def restore_endpoints(self) -> int:
        """daemon/state.go restoreOldEndpoints: reload checkpoints,
        re-resolve identities, queue rebuilds.  Also reloads the CT
        checkpoint so established flows keep forwarding."""
        state_dir = self.config.state_dir
        if not state_dir or not os.path.isdir(state_dir):
            return 0
        self.restore_ct()
        restored = []
        for fname in sorted(os.listdir(state_dir)):
            if not (fname.startswith("ep_") and fname.endswith(".json")):
                continue
            try:
                with open(os.path.join(state_dir, fname)) as f:
                    snap = json.load(f)
                ep = Endpoint.restore(snap)
            except (OSError, ValueError, KeyError, MigrationError):
                # one unmigratable checkpoint (e.g. from a newer agent)
                # must not block restoring the rest
                continue
            ep.table_slot = self.table_mgr.attach(ep.id)
            self.endpoints.insert(ep)
            ep.update_labels(self.identity_allocator, ep.labels)
            self.datapath.set_endpoint_identity(ep.table_slot,
                                                ep.security_identity)
            if ep.ipv4:
                self.ipcache.upsert(ep.ipv4, ep.security_identity,
                                    SOURCE_AGENT_LOCAL,
                                    metadata=f"endpoint:{ep.id}")
                # re-claim the IP in the host-scope allocator so a
                # post-restart POST /ipam can never hand it out again
                # (ipam.AllocateIP restore path, daemon/state.go)
                try:
                    self.ipam.allocate_ip(ep.ipv4,
                                          owner=f"endpoint:{ep.id}")
                except IPAMError:
                    # outside this node's range (config changed) or
                    # already claimed — either way not double-bookable
                    pass
            restored.append((ep, snap.get("identity")))
        # Pinned-map parity (daemon/state.go + bpffs pinned maps: the
        # dataplane keeps enforcing the OLD policy while the agent is
        # down and until fresh policy arrives).  If every restored
        # endpoint's re-resolved identity matches its checkpoint — the
        # allocator reproduced the identity universe, which a
        # kvstore-backed allocator guarantees and the local one gives
        # deterministically for an unchanged endpoint set — realize the
        # checkpointed verdict state directly: allowed flows keep
        # flowing BEFORE the orchestrator re-imports policy, and denied
        # ones stay denied.  Any mismatch means numeric identities in
        # the snapshots may now name different workloads, so fail
        # closed: queue regenerations against the (empty) repo instead,
        # which drops new flows until policy import.  The next
        # policy_add regenerates everything either way.
        stable = all(ck is not None and ep.security_identity == ck
                     for ep, ck in restored)
        for ep, _ck in restored:
            if stable:
                # L7 redirect entries are scrubbed, not restored: their
                # proxy_port names a listener of the DEAD agent's proxy
                # child (gone, or worse re-bound by someone else).
                # Those flows fail closed until policy re-import
                # re-creates redirects on live ports; plain L3/L4
                # allows restore verbatim.
                scrubbed = PolicyMapState(
                    {k: v for k, v in ep.realized.items()
                     if v.proxy_port == 0})
                ep.realized = scrubbed
                if self.host_path is not None:
                    self.host_path.sync_endpoint(ep.id, scrubbed)
                self.table_mgr.sync_endpoint(ep.id, scrubbed,
                                             ep.policy_revision)
            else:
                self.endpoints.queue_regeneration(ep.id)
        if stable and restored:
            self.datapath.refresh_policy()
        return len(restored)

    # -------------------------------------------------- services / lb

    def service_upsert(self, vip: str, port: int,
                       backends: Sequence[Tuple[str, int]],
                       proto: int = 6) -> None:
        """PUT /service (daemon/loadbalancer.go) — family-routed: v6
        VIPs program the lb6 tables (lb.h lb6_* family)."""
        if ":" in vip:
            from ..compiler.lpm import ipv6_to_words
            from ..datapath.lb import Backend6, Service6
            svc6 = Service6(vip=ipv6_to_words(vip), port=port,
                            proto=proto,
                            backends=[Backend6(ipv6_to_words(ip), p)
                                      for ip, p in backends])
            self.datapath.upsert_service6(svc6)
            return
        svc = Service(vip=ipv4_to_u32(vip), port=port, proto=proto,
                      backends=[Backend(ipv4_to_u32(ip), p)
                                for ip, p in backends])
        self.datapath.lb.upsert_service(svc)
        self.datapath.reload_services()

    def service_find_by_id(self, sid: int):
        """Service lookup by API id — the reference addresses services
        by numeric id in GET/DELETE /service/{id}
        (daemon/loadbalancer.go).  The API id is the family's
        rev_nat_index, offset by V6_SERVICE_ID_BASE for v6: the two
        families allocate rev-NAT indices independently (both device
        tables index by them), so the raw indices collide across
        families and only the offset id is unique.  Returns a
        Service/Service6 or None."""
        if sid >= V6_SERVICE_ID_BASE:
            target = sid - V6_SERVICE_ID_BASE
            for svc6 in self.datapath.lb6_service_list():
                if svc6.rev_nat_index == target:
                    return svc6
            return None
        for svc in self.datapath.lb.services():
            if svc.rev_nat_index == sid:
                return svc
        return None

    def service_delete_by_id(self, sid: int) -> bool:
        svc = self.service_find_by_id(sid)
        if svc is None:
            return False
        return self._service_delete_raw(svc.vip, svc.port, svc.proto)

    def _service_delete_raw(self, vip_raw, port: int,
                            proto: int) -> bool:
        """One delete body for both address families and both the
        by-id and by-(vip,port) surfaces."""
        if isinstance(vip_raw, tuple):          # v6 family
            return self.datapath.delete_service6(vip_raw, port, proto)
        ok = self.datapath.lb.delete_service(vip_raw, port, proto)
        if ok:
            self.datapath.reload_services()
        return ok

    def service_delete(self, vip: str, port: int, proto: int = 6) -> bool:
        if ":" in vip:
            from ..compiler.lpm import ipv6_to_words
            return self._service_delete_raw(ipv6_to_words(vip), port,
                                            proto)
        return self._service_delete_raw(ipv4_to_u32(vip), port, proto)

    # -------------------------------------------------- prefilter

    def prefilter_update(self, cidrs: List[str]) -> int:
        """PATCH /prefilter (pkg/datapath/prefilter:125 Insert)."""
        self.datapath.prefilter.insert(cidrs)
        self.datapath.reload_prefilter()
        return self.datapath.prefilter.revision

    def prefilter_delete(self, cidrs: List[str]) -> int:
        self.datapath.prefilter.delete(cidrs)
        self.datapath.reload_prefilter()
        return self.datapath.prefilter.revision

    # -------------------------------------------------- identity / fqdn

    def identity_get(self, numeric_id: Optional[int] = None,
                     labels: Optional[Sequence[str]] = None
                     ) -> Optional[Dict]:
        if numeric_id is not None:
            ident = self.identity_allocator.lookup_by_id(numeric_id)
        else:
            ident = self.identity_allocator.lookup_by_labels(
                Labels.from_model(list(labels or [])))
        if ident is None:
            return None
        return {"id": ident.id,
                "labels": [str(l) for l in ident.label_array]}

    def identity_list(self) -> List[Dict]:
        out = [{"id": i.id, "labels": [str(l) for l in i.label_array]}
               for i in self.identity_allocator.snapshot_identities()]
        for num, ident in sorted(idpkg.RESERVED_IDENTITY_CACHE.items()):
            out.append({"id": num,
                        "labels": [str(l) for l in ident.label_array]})
        return sorted(out, key=lambda d: d["id"])

    def start_fqdn_poller(self, lookup, interval: float = 5.0) -> DNSPoller:
        """pkg/fqdn/dnspoller.go:50 — poll loop; when any matchName's
        IP set changes, re-inject ToCIDRSet into the registered FQDN
        rules and retrigger regeneration. ``lookup(names)`` returns
        {name: (ips, ttl)}."""
        def on_change(changed_names) -> None:
            dirty = False
            with self._lock:
                for r in self._fqdn_rules:
                    inject_to_cidr_set(r, self.dns_cache)
                    if self._resync_rule_prefixes_locked(r):
                        dirty = True
            if dirty:
                self.trigger_policy_updates("fqdn-update")

        self.dns_poller = DNSPoller(self.dns_cache, lookup=lookup,
                                    on_change=on_change, interval=interval,
                                    access_log=self.proxy.access_log)
        with self._lock:
            for r in self._fqdn_rules:
                self.dns_poller.register_rule(r)
        self.dns_poller.start()
        return self.dns_poller

    # -------------------------------------------------- status

    def status(self) -> Dict:
        """GET /healthz (daemon/status.go status collector)."""
        from .. import __version__
        return {
            "version": __version__,
            "uptime-seconds": round(time.time() - self.started_at, 3),
            "kvstore": self._kvstore_status(),
            "policy": {"revision": self.repo.revision,
                       "rules": len(self.repo)},
            "endpoints": {
                "total": len(self.endpoints),
                "by-state": self._endpoint_state_counts()},
            "identities": len(self.identity_allocator),
            "ipcache": len(self.ipcache),
            "nodes": len(self.node_manager),
            "proxy": {"redirects": len(self.proxy)},
            "clustermesh": self.clustermesh.status(),
            "controllers": self.controllers.status_model(),
            # top-level controller degraded signal: a reconcile loop
            # failing repeatedly must not stay buried inside the
            # controller list (`cilium-tpu status` prints it loudly)
            "controller-health": self._controller_health(),
            # breaker/retry/relist counters from the transport
            # resilience layer (utils/resilience.py) — the same series
            # /metrics exposes, summarized for the status path
            "transports": transport_resilience.status_summary(),
            "datapath": {"revision": self.datapath.revision,
                         "conntrack-slots": self.datapath.ct.slots},
            # dataplane serving mode (datapath/supervisor.py): fails
            # LOUDLY while the device lane is degraded — traffic is
            # being served fail-static from the host oracle, which is
            # correct-but-slow; an operator must see it immediately
            "dataplane": self._dataplane_status(),
            # device-table fill fractions + threshold warnings
            # (cilium_bpf_map_pressure analog); `cilium-tpu status
            # --verbose` renders the same report
            "map-pressure": self.datapath.map_pressure(
                self.config.map_pressure_warn),
            # runtime self-telemetry: tracer health and recent
            # policy-propagation delays
            "telemetry": {
                "tracing": self.tracer.stats(),
                "propagation": self.propagation.report(5)},
            # serving SLO tier (observability/slo.py): per-lane
            # latency percentiles, deadline-budget burn rates and the
            # latest queue-flight sample — `status --verbose` renders
            # the cilium-tpu-top-style table from this block
            "slo": slo_tracker.snapshot(),
            # incident flight recorder health: how much of the ordered
            # degraded-condition timeline is buffered for
            # `cilium-tpu events` / GET /debug/events
            "flight-recorder": flight_recorder.stats(),
            # flow observability health (hubble observer + relay)
            "hubble": self.hubble.stats()
            if self.hubble is not None else None,
            # verdict provenance + the drift audit's correctness
            # verdict on the policy compiler: "FAILING" here means the
            # compiled device tables and the host oracle disagree —
            # the loudest signal status() can carry
            "provenance": self._provenance_status(),
            # inline threat scoring: mode (off/shadow/enforce), live
            # thresholds + model generation, verdict accounting; an
            # enforcing plane reports loudly (a model may now override
            # policy-allowed traffic)
            "threat": self.threat_status(),
            # device traffic analytics: sketch geometry + write epoch,
            # the last drain's (possibly partial) outcome, and the
            # live heavy-hitter / scan-suspect sets
            "analytics": self.analytics_status(),
            # runtime capability probes (bpf/run_probes.sh analog)
            "features": self._features(),
        }

    def _kvstore_status(self) -> Dict:
        """status()["kvstore"]: no longer a bare echo of kv.status() —
        the outage guard contributes breaker state and the
        seconds-since-last-successful-op staleness age, so a dead
        backend can never report 'ok' between calls; while degraded
        the mode/staleness/journal fields ARE the loud signal."""
        if self.kv is None:
            return {"state": "ok", "backend": "none"}
        inner = getattr(self.kv, "inner", self.kv)
        out = {"state": self.kv.status(),
               "backend": type(inner).__name__}
        if self._kv_guard is not None:
            out.update(self._kv_guard.report())
            fb = self.identity_allocator
            if isinstance(fb, FallbackIdentityAllocator):
                out["local-identities"] = fb.local_count()
                out["fallback-allocations"] = fb.fallback_allocations
        return out

    def _controller_health(self) -> Dict:
        failing = self.controllers.failing()
        if not failing:
            return {"status": "ok", "failing": []}
        names = ", ".join(f["name"] for f in failing)
        return {"status": f"DEGRADED: controller(s) {names} failing "
                          f">=3x consecutively",
                "failing": failing}

    def _dataplane_status(self) -> Dict:
        out = self.datapath.supervision_status()
        mode = out.get("mode", "ok")
        if mode == "ok":
            out["status"] = "ok"
        elif "shards" in out:
            # sharded dataplane: name EXACTLY the degraded shards —
            # the rest of the mesh is still serving bit-exact on
            # device, and the operator must see the blast radius
            bad = out.get("degraded-shards", [])
            faults = []
            for k in bad:
                sup = ((out["shards"].get(str(k)) or {})
                       .get("serving") or {}).get("supervisor") or {}
                faults.append(f"shard {k}: {sup.get('last-fault')}")
            out["status"] = (
                f"{mode.upper()}: shard(s) {bad} serving fail-static "
                f"from the host oracle ({'; '.join(faults)}); "
                f"remaining shards on device")
        else:
            sup = (out.get("serving") or {}).get("supervisor") or {}
            out["status"] = (
                f"{mode.upper()}: device lane faulted "
                f"({sup.get('last-fault')}); serving fail-static "
                f"from the host oracle")
        return out

    def _provenance_status(self) -> Dict:
        report = self.drift_report()
        summary = None
        if report is not None:
            summary = {"status": report.get("status"),
                       "checked": report.get("checked", 0),
                       "sc-checked": report.get("sc-checked", 0),
                       "last-run": report.get("last-run"),
                       "divergences":
                       len(report.get("divergences") or [])}
            if summary["divergences"]:
                summary["detail"] = report["divergences"][:5]
        return {"enabled": self.datapath.provenance_enabled,
                "drift-audit": summary,
                "top-dropped-rules": self.monitor.top_dropped_rules(5)}

    def _features(self) -> Dict:
        """What this agent runs on (bpf/run_probes.sh analog), keyed as
        the reference's ``probe_features``: the torch device type as the
        backend, the device count and name, whether the dense engine's
        CUDA kernel launches here (``cuda``, the reference's ``pallas``),
        whether the host fast path built, and the engines on offer with
        ``dense-cuda`` for ``dense-pallas``.  The native probe is the one
        made at start, so the status path never compiles."""
        on_card = self.device.type == "cuda"
        native = self.host_path is not None
        return {"definitive": True, "backend": self.device.type,
                "device_count": torch.cuda.device_count() if on_card
                else 1,
                "device_kind": torch.cuda.get_device_name(self.device)
                if on_card else "cpu",
                "platform_version": torch.__version__,
                "on_accelerator": on_card,
                "cuda": on_card,
                "native_fastpath": native,
                "verdict_engines": ["hash", "dense"] +
                (["dense-cuda"] if on_card else []) + ["bucket2choice"] +
                (["host-cache"] if native else [])}

    def _endpoint_state_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for ep in self.endpoints.endpoints():
            counts[ep.state] = counts.get(ep.state, 0) + 1
        # keep the per-state gauge in lockstep, zeroing states no
        # endpoint is in anymore (EndpointStateCount analog)
        _ES = EndpointState
        for state in (_ES.CREATING, _ES.WAITING_FOR_IDENTITY,
                      _ES.READY, _ES.WAITING_TO_REGENERATE,
                      _ES.REGENERATING, _ES.RESTORING,
                      _ES.DISCONNECTING, _ES.DISCONNECTED,
                      _ES.NOT_READY):
            ENDPOINT_STATE_COUNT.set(counts.get(state, 0),
                                     labels={"state": state})
        return counts

    def metrics_text(self) -> str:
        # scrape-time collection: drain the deferred verdict-outcome
        # accounting and refresh the map-pressure gauges (computed
        # gauges, Prometheus collector semantics) so a bare /metrics
        # scrape never under-reports or reads stale fill fractions
        self.datapath.flush_telemetry()
        self.datapath.map_pressure(self.config.map_pressure_warn)
        return metrics_registry.expose_text()

    def pipeline_report(self) -> Dict:
        """Host-timed pipeline stage breakdown (/debug/pipeline)."""
        return pipeline_report()

    def traces(self, trace_id: Optional[str] = None,
               revision: Optional[int] = None, limit: int = 50):
        """Span-trace surface (/debug/traces, `cilium-tpu trace`):
        summaries by default, one span tree for an explicit trace id
        or policy revision."""
        if revision is not None:
            trace_id = self.propagation.trace_id_of(revision)
            if trace_id is None:
                return None
        if trace_id is not None:
            return self.tracer.tree(trace_id)
        return {"traces": self.tracer.traces(limit),
                "tracer": self.tracer.stats(),
                "propagation": self.propagation.report(limit)}

    # -------------------------------------------------- lifecycle

    def wait_for_quiesce(self, timeout: float = 30.0) -> bool:
        return self.endpoints.wait_for_quiesce(timeout)

    def wait_for_regenerations(self, timeout: float = 30.0) -> bool:
        """Block until no ``trigger_policy_updates`` run is pending or
        running and no build is queued or running.  An identity change
        regenerates without a new revision, so
        ``wait_for_policy_revision`` alone does not see it."""
        deadline = time.monotonic() + timeout
        while True:
            left = max(0.0, deadline - time.monotonic())
            if self._regen_trigger.wait_idle(left) and \
                    self.endpoints.wait_for_quiesce(
                        max(0.0, deadline - time.monotonic())) and \
                    self._regen_trigger.wait_idle(0):
                return True
            if time.monotonic() >= deadline:
                return False

    def wait_for_policy_revision(self, revision: Optional[int] = None,
                                 timeout: float = 30.0) -> bool:
        """Block until every live endpoint has applied ``revision``
        (default: the current repo revision) and the build queue is
        idle. The synchronous wait the async TriggerPolicyUpdates path
        needs (the reference tracks the same via Endpoint.policyRevision
        waitForPolicyRevision)."""
        rev = revision if revision is not None else self.repo.revision
        deadline = time.time() + timeout

        def applied() -> bool:
            return all(ep.policy_revision >= rev or
                       ep.state in (EndpointState.DISCONNECTING,
                                    EndpointState.DISCONNECTED)
                       for ep in self.endpoints.endpoints())

        while time.time() < deadline:
            if applied() and self.endpoints.wait_for_quiesce(0.05):
                return True
            time.sleep(0.01)
        return applied() and self.endpoints.wait_for_quiesce(0.0)

    # ----------------------------------------------------- monitor wire

    def serve_monitor(self, port: int = 0):
        """Serve the monitor event stream to subscriber processes
        (monitor/main.go:81-119 unix-socket fan-out analog); the CLI's
        ``monitor --socket`` follows from a separate process."""
        from ..monitor import MonitorServer
        if getattr(self, "_monitor_server", None) is None:
            self._monitor_server = MonitorServer(self.monitor,
                                                 port=port).start()
        return self._monitor_server

    # -------------------------------------------------------- xDS wire

    def serve_xds(self, port: int = 0):
        """Serve NPDS (proxy redirects as NetworkPolicy resources) and
        NPHDS (ip -> identity) to out-of-process proxies over TCP —
        the process boundary of pkg/envoy/server.go:114.  Policy pushes
        can then block on cross-process ACKs via
        ``xds_cache.wait_for_acks``."""
        from ..l7.xds_wire import XDSWireServer
        from ..xds import (Cache, TYPE_NETWORK_POLICY,
                           TYPE_NETWORK_POLICY_HOSTS,
                           host_mapping_resources)
        if getattr(self, "_xds_server", None) is not None:
            return self._xds_server
        self.xds_cache = Cache()
        self._xds_server = XDSWireServer(self.xds_cache,
                                         port=port).start()

        def publish_hosts(*_a):
            pairs = {p.prefix: p.identity for p in self.ipcache.dump()}
            self.xds_cache.set_resources(
                TYPE_NETWORK_POLICY_HOSTS,
                host_mapping_resources(pairs))

        self.ipcache.add_listener(lambda *a: publish_hosts(),
                                  replay=False)
        publish_hosts()

        def publish_npds():
            resources = {}
            for r in self.proxy.redirects():
                http_rules = []
                if r.l7_filter is not None:
                    for rules in r.l7_filter.l7_rules_per_ep.values():
                        for hr in getattr(rules, "http", []) or []:
                            http_rules.append({
                                "method": hr.method, "path": hr.path,
                                "host": hr.host})
                # the child's orig-dst: for an ingress redirect the
                # upstream is the endpoint itself on the original port
                ep = self.endpoints.lookup(r.endpoint_id)
                up_host = (ep.ipv4 if ep is not None and ep.ipv4
                           else "127.0.0.1")
                resources[r.id] = {
                    "name": r.id, "policy": self.repo.revision,
                    "proxy_port": r.proxy_port,
                    "upstream": [up_host, r.to_port],
                    "http_rules": http_rules}
            self.xds_cache.set_resources(TYPE_NETWORK_POLICY, resources)

        self.proxy.on_change = publish_npds
        publish_npds()
        return self._xds_server

    def shutdown(self) -> None:
        if getattr(self, "hubble", None) is not None:
            self.hubble.close()
        if getattr(self, "_monitor_server", None) is not None:
            self._monitor_server.shutdown()
        if getattr(self, "_xds_server", None) is not None:
            self._xds_server.shutdown()
        self.endpoints.shutdown()
        self._regen_trigger.shutdown()
        self._lpm_trigger.shutdown()
        self.controllers.remove_all()
        self.clustermesh.close()
        if self.dns_poller is not None:
            self.dns_poller.stop()
        if self._ip_watcher is not None:
            self._ip_watcher.stop()
        if self.node_registry is not None:
            self.node_registry.close()
        if self._kv_guard is not None:
            # the allocator's watch, then the guard and the backend it
            # wraps (the reference leaves both to its caller)
            self.identity_allocator.close()
            self._kv_guard.close()
        self.checkpoint_ct()

    # ------------------------------------------- conntrack persistence

    def _ct_checkpoint_tick(self) -> None:
        """The ct-checkpoint controller body.  A controller runs once
        as it starts, before ``restore_endpoints`` has read the previous
        agent's ``ct_state.npz``; that first run writes nothing, since an
        empty table written then would replace the checkpoint the
        restart is about to restore (the reference writes it, and its
        restore races the controller thread)."""
        if not self._ct_checkpoint_armed:
            self._ct_checkpoint_armed = True
            return
        self.checkpoint_ct()

    def checkpoint_ct(self) -> bool:
        """Persist both CT tables (the pinned-ctmap analog): on the
        next start, restore_ct() lets established flows keep their
        verdicts while the agent was down (daemon/state.go + pinned
        bpf maps semantics).  Calls are serialized: the controller and
        an explicit call (or ``shutdown``) share one tmp name, and the
        reference, which does not serialize them, can lose the second
        writer's rename (it then returns False)."""
        if not self.config.state_dir:
            return False
        with self._ct_checkpoint_lock:
            return self._write_ct_checkpoint()

    def _write_ct_checkpoint(self) -> bool:
        try:
            os.makedirs(self.config.state_dir, exist_ok=True)
            path = os.path.join(self.config.state_dir, "ct_state.npz")
            v4, v6 = self.datapath.snapshot_ct()
            # tmp + rename, like Endpoint.write_checkpoint: a crash
            # mid-write must not destroy the previous good checkpoint
            # (tmp keeps the .npz suffix — numpy appends one otherwise)
            tmp = f"{path[:-4]}.tmp{os.getpid()}.npz"
            np.savez_compressed(
                tmp, __version__=np.array([1], np.int64),
                **{f"v4_{k}": v for k, v in v4.items()},
                **{f"v6_{k}": v for k, v in v6.items()})
            os.replace(tmp, path)
            return True
        except OSError:
            return False

    def restore_ct(self) -> int:
        """Reload checkpointed CT state; returns live entries restored
        (0 when absent or geometry-incompatible — a cold start)."""
        if not self.config.state_dir:
            return 0
        path = os.path.join(self.config.state_dir, "ct_state.npz")
        # prepare BOTH tables before assigning either, and treat any
        # corruption (truncated zip, missing members, geometry change,
        # unknown version) as a cold start — never a crash, never a
        # half-restored table
        try:
            with np.load(path) as z:
                if int(np.asarray(z["__version__"])[0]) != 1:
                    return 0
                v4 = {k[3:]: z[k] for k in z.files
                      if k.startswith("v4_")}
                v6 = {k[3:]: z[k] for k in z.files
                      if k.startswith("v6_")}
            return self.datapath.restore_ct_snapshots(v4, v6)
        except Exception:  # noqa: BLE001 — np.load raises zipfile/
            return 0       # zlib/pickle errors beyond OSError; a bad
            # snapshot (geometry/fields) is a cold start, never a
            # crash or a half-restored table
