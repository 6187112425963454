"""Configuration: static daemon config + runtime-mutable option maps.

A whole copy of ``cilium_tpu/utils/option.py``; the defaults are the
reference's.

Reference: pkg/option — ``DaemonConfig`` (flags bound in
daemon/main.go:169-343) plus mutable ``IntOptions`` maps with a spec
library (dependencies between options, verify hooks) and per-endpoint
override; option changes trigger endpoint regeneration
(``applyOptsLocked``), surfaced as PATCH /config and
PATCH /endpoint/{id}/config (api/v1/openapi.yaml:41,189).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

OPTION_DISABLED = 0
OPTION_ENABLED = 1


@dataclass
class OptionSpec:
    """One mutable option's metadata (option.go Option)."""

    name: str
    description: str = ""
    # options that must be enabled for this one (option.go Requires)
    requires: List[str] = field(default_factory=list)
    immutable: bool = False
    verify: Optional[Callable[[int], None]] = None  # raises on bad value


# The daemon/endpoint mutable-option library (reference:
# pkg/option/config.go specs; datapath ones become engine switches here).
SPEC_DEBUG = OptionSpec("Debug", "Enable debugging trace statements")
SPEC_DROP_NOTIFY = OptionSpec("DropNotification",
                              "Enable drop notifications")
SPEC_TRACE_NOTIFY = OptionSpec("TraceNotification",
                               "Enable trace notifications")
SPEC_POLICY_VERDICT_NOTIFY = OptionSpec(
    "PolicyVerdictNotification", "Enable policy-verdict notifications")
SPEC_CONNTRACK_ACCOUNTING = OptionSpec(
    "ConntrackAccounting", "Enable per-CT packet/byte counters",
    requires=["Conntrack"])
SPEC_CONNTRACK = OptionSpec("Conntrack", "Enable stateful connection tracking")
SPEC_POLICY = OptionSpec("Policy", "Enable policy enforcement")
SPEC_INGRESS_POLICY = OptionSpec("IngressPolicy",
                                 "Enable ingress policy enforcement")
SPEC_EGRESS_POLICY = OptionSpec("EgressPolicy",
                                "Enable egress policy enforcement")

DAEMON_OPTION_LIBRARY: Dict[str, OptionSpec] = {
    s.name: s for s in [
        SPEC_DEBUG, SPEC_DROP_NOTIFY, SPEC_TRACE_NOTIFY,
        SPEC_POLICY_VERDICT_NOTIFY, SPEC_CONNTRACK,
        SPEC_CONNTRACK_ACCOUNTING, SPEC_POLICY, SPEC_INGRESS_POLICY,
        SPEC_EGRESS_POLICY,
    ]
}


class IntOptions:
    """A mutable option map with spec-driven validation.

    Reference: pkg/option/option.go IntOptions (ApplyValidated, dependency
    resolution when enabling an option that Requires others, change
    callbacks used to kick regeneration).
    """

    def __init__(self, library: Optional[Dict[str, OptionSpec]] = None,
                 defaults: Optional[Dict[str, int]] = None):
        self.library = library or DAEMON_OPTION_LIBRARY
        self._lock = threading.RLock()
        self._opts: Dict[str, int] = dict(defaults or {})

    def get(self, name: str) -> int:
        with self._lock:
            return self._opts.get(name, OPTION_DISABLED)

    def is_enabled(self, name: str) -> bool:
        return self.get(name) > 0

    def _validate_one(self, name: str, value: int) -> OptionSpec:
        spec = self.library.get(name)
        if spec is None:
            raise KeyError(f"unknown option {name!r}")
        if spec.immutable:
            raise ValueError(f"option {name!r} is immutable")
        if spec.verify:
            spec.verify(value)
        return spec

    def _requires_closure(self, name: str, seen: set) -> None:
        if name in seen:
            return
        seen.add(name)
        spec = self.library.get(name)
        if spec is None:
            raise KeyError(f"unknown option {name!r} (required dependency)")
        for dep in spec.requires:
            self._requires_closure(dep, seen)

    def _dependents_closure(self, name: str, seen: set) -> None:
        if name in seen:
            return
        seen.add(name)
        for other, spec in self.library.items():
            if name in spec.requires:
                self._dependents_closure(other, seen)

    def apply_validated(self, changes: Dict[str, int],
                        changed: Optional[Callable[[str, int], None]] = None
                        ) -> int:
        """Apply a set of option changes. Enabling an option enables its
        ``requires`` closure; disabling one disables dependents
        (option.go ApplyValidated/enable/disable). The full closure is
        validated before anything mutates: all-or-nothing, and the
        immutable/verify guards cover cascaded options too. Returns the
        number of options whose value actually changed."""
        n_changed = 0
        with self._lock:
            enable_closure: set = set()
            disable_closure: set = set()
            for name, value in changes.items():
                self._validate_one(name, value)
                if value > 0:
                    self._requires_closure(name, enable_closure)
                else:
                    self._dependents_closure(name, disable_closure)
            for name in enable_closure:
                if name not in changes:
                    self._validate_one(name, OPTION_ENABLED)
            for name in disable_closure:
                if name not in changes:
                    self._validate_one(name, OPTION_DISABLED)
            for name, value in changes.items():
                if value > 0:
                    n_changed += self._enable(name, value, changed)
                else:
                    n_changed += self._disable(name, changed)
        return n_changed

    def _enable(self, name, value, changed) -> int:
        n = 0
        spec = self.library[name]
        for dep in spec.requires:
            if self._opts.get(dep, 0) <= 0:
                n += self._enable(dep, OPTION_ENABLED, changed)
        if self._opts.get(name, 0) != value:
            self._opts[name] = value
            n += 1
            if changed:
                changed(name, value)
        return n

    def _disable(self, name, changed) -> int:
        n = 0
        if self._opts.get(name, 0) != 0:
            self._opts[name] = 0
            n += 1
            if changed:
                changed(name, 0)
        # cascade: disable options that Require this one
        for other, spec in self.library.items():
            if name in spec.requires and self._opts.get(other, 0) > 0:
                n += self._disable(other, changed)
        return n

    def dump(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._opts)

    def fork(self) -> "IntOptions":
        """Copy for per-endpoint override (endpoint opts start from the
        daemon's, then diverge)."""
        with self._lock:
            return IntOptions(self.library, dict(self._opts))


def parse_option_value(value) -> int:
    """User input -> option int (option.go NormalizeBool)."""
    if isinstance(value, bool):
        return OPTION_ENABLED if value else OPTION_DISABLED
    if isinstance(value, int):
        return value
    s = str(value).strip().lower()
    if s in ("true", "on", "enable", "enabled", "1"):
        return OPTION_ENABLED
    if s in ("false", "off", "disable", "disabled", "0"):
        return OPTION_DISABLED
    raise ValueError(f"invalid option value {value!r}")


@dataclass
class DaemonConfig:
    """Static (start-time) configuration (pkg/option/config.go
    DaemonConfig; flag binding daemon/main.go:169-343)."""

    cluster_name: str = "default"
    cluster_id: int = 0
    state_dir: str = "/var/run/cilium_tpu"
    # node pod CIDRs served by the daemon's host-scope IPAM
    # (reference: daemon/ipam.go AllocateIP + pkg/ipam)
    ipv4_range: str = "10.200.0.0/16"
    ipv6_range: str = "f00d::/96"
    device_count: int = 1
    tunnel: str = "vxlan"              # vxlan | geneve | disabled
    enable_ipv4: bool = True
    enable_ipv6: bool = True
    enable_policy: str = "default"     # default | always | never
    allow_localhost: str = "auto"      # auto | always | policy
    proxy_port_min: int = 10000        # reference: daemon.go:1326
    proxy_port_max: int = 20000
    ct_slots: int = 1 << 16
    # periodic CT snapshot interval (0 disables).  The reference's CT
    # lives in pinned bpffs maps that survive agent death for free
    # (SURVEY §5 checkpoint/resume); a periodic snapshot is the analog
    # that lets a SIGKILLed agent restart with its established flows.
    ct_checkpoint_interval_s: float = 10.0
    monitor_queue_size: int = 4096
    # Hubble flow observability (hubble/): the host flow ring, and the
    # on-device aggregation table fused into the datapath steps
    # (0 slots = host ring only, no device table)
    enable_hubble: bool = True
    hubble_ring_capacity: int = 8192
    hubble_flow_slots: int = 1 << 12
    hubble_flow_probe: int = 8
    # relay fan-out deadline (a dead peer costs at most this per query)
    hubble_relay_deadline_s: float = 2.0
    # sharded daemons (dataplane_shards >= 2): the federated observer
    # (hubble/federation.py) drains every shard's device flow table
    # into its per-shard flow store on this cadence (0 disables the
    # drain controller; drain() stays callable on demand)
    hubble_drain_interval_s: float = 1.0
    # serving SLO tier (observability/slo.py): the latency objective a
    # resolved ticket is judged against when its lane has no admission
    # deadline, and the error-budget fraction the burn rate divides by
    # (0.001 = a 99.9% latency SLO)
    serving_slo_objective_s: float = 0.050
    serving_slo_error_budget: float = 0.001
    # runtime self-telemetry (observability/): span tracing +
    # stage and verdict accounting.  Disabling drops the datapath's
    # telemetry cost to ~0 (the tracing-overhead bench's off leg).
    enable_tracing: bool = True
    trace_capacity: int = 4096
    # map-pressure warning threshold (pkg/metrics BPFMapPressure
    # analog): tables at or above this fill fraction surface warnings
    # in status() / `cilium-tpu status --verbose`
    map_pressure_warn: float = 0.9
    # verdict provenance (datapath/verdict.py): per-packet matched-rule
    # attribution + decision tiers emitted by the jitted steps.  Off by
    # default — the provenance-overhead bench's disabled leg is the
    # baseline program; replay (`policy trace --replay`) and the drift
    # audit work either way (they compile their own read-only step)
    enable_provenance: bool = False
    # periodic drift audit: replay sampled identity/port tuples through
    # the LIVE compiled device tables and diff against the host policy
    # oracles (compute_desired_policy_map_state + SearchContext).
    # Divergence increments policy_drift_total and fails status()
    # loudly.  0 disables the controller (run_drift_audit stays
    # callable on demand).
    drift_audit_interval_s: float = 30.0
    drift_audit_samples: int = 64
    # dataplane supervision (datapath/supervisor.py): overload
    # admission control + device-fault circuit breaking with
    # fail-static host fallback on the serving lane.  Disabling
    # restores the exact pre-supervision dispatch path (the compiled
    # device program is byte-identical either way).
    enable_supervision: bool = True
    # weight bound on the serving lane's pending queue (records);
    # overflow is shed fail-closed with serving_shed_total{reason}
    serving_max_pending: int = 1 << 17
    # optional default serving deadline (seconds; 0 = none): queued
    # work older than this is shed instead of dispatched
    serving_deadline_s: float = 0.0
    # degraded-mode policy for NEW flows while serving fail-static
    # from the host oracle (established flows always keep their
    # verdicts): "oracle" = enforce last-known-good policy on host,
    # "deny" = no new flows while degraded, "allow" = open
    degraded_new_flow_policy: str = "oracle"
    # a finalize (the one blocking device sync) outliving this
    # deadline is a device fault — the hung-complete watchdog
    supervisor_watchdog_s: float = 10.0
    # consecutive transient faults before the breaker opens (fatal
    # faults trip it immediately)
    supervisor_failure_threshold: int = 3
    # first half-open probe delay; doubles per failed probe up to
    # the resilience layer's max_reset
    supervisor_reset_s: float = 1.0
    # shard the verdict dataplane across the device mesh
    # (parallel/sharded.py): >= 2 builds a (dp, ep=dataplane_shards)
    # mesh over the visible devices, shards the endpoint axis of the
    # policy tables across ep with per-shard CT/flow state and
    # per-shard fault domains (a device fault degrades ONE shard to
    # fail-static while the rest keep serving on device).  0/1 = the
    # single-engine dataplane.  Device count must divide evenly.
    dataplane_shards: int = 0
    # control-plane outage survivability (kvstore/outage.py): opt-in.
    # When enabled, sustained kvstore failure (breaker-open /
    # lease-keepalive loss) flips kvstore_mode to degraded: consumers
    # pin last-known-good state with a tracked staleness age, kvstore
    # mutations are journaled for reconnect replay, and identity
    # allocation falls back to node-local ephemeral IDs promoted to
    # cluster scope on reconnect.  Disabled = behavior-identical to the
    # unwrapped backend (status-path staleness bookkeeping only).
    enable_kvstore_survival: bool = False
    # consecutive op/probe failures before the outage breaker opens
    kvstore_failure_threshold: int = 3
    # the kvstore-outage controller's tick cadence: idle-probe period
    # while ok, half-open probe cadence floor while degraded
    kvstore_probe_interval_s: float = 0.5
    # lease grace window: an outage shorter than this is expected to
    # leave our lease-backed keys intact server-side; the reconnect
    # reconcile re-asserts them either way and flags exceeded-grace
    kvstore_grace_s: float = 60.0
    # write-journal depth bound (per-key-coalesced entries; overflow
    # evicts oldest with accounting)
    kvstore_journal_max: int = 8192
    # reconnect reconcile rate limit (journal replay + local-key
    # repair ops per second; 0 = unthrottled)
    kvstore_reconcile_ops_per_s: float = 2000.0
    # inline per-packet threat scoring (cilium_tpu/threat/): when
    # enabled, both jitted family pipelines fuse the quantized anomaly
    # scorer; default mode is SHADOW (score-only — verdicts are
    # bit-exact pre-threat until an operator flips to enforce, and
    # every enforcement arm threshold defaults to disabled anyway).
    enable_threat: bool = False
    threat_mode: str = "shadow"        # shadow | enforce
    threat_buckets: int = 1024         # per-identity window/bucket slots
    threat_window_s: int = 8           # claim-window span (seconds)
    threat_drop_score: int = 0         # score >= this drops (0 = off)
    threat_redirect_score: int = 0     # score >= this redirects (0 = off)
    threat_ratelimit_score: int = 0    # score >= this rate-limits (0 = off)
    threat_redirect_port: int = 0      # the redirect arm's proxy port
    threat_rate_per_s: float = 256.0   # token-bucket refill rate
    threat_burst: int = 1024           # token-bucket capacity
    # device-resident traffic analytics (cilium_tpu/analytics/): fuse
    # the count-min sketch + cardinality-register stage into both
    # family pipelines.  Disabled = the jitted programs are
    # byte-identical pre-analytics (the with_threat precedent); the
    # drain controller swaps the A/B epoch and decodes the quiesced
    # section into capped top-K gauges + anomaly events
    enable_analytics: bool = False
    analytics_width: int = 1 << 12     # sketch columns (power of two)
    analytics_depth: int = 2           # salted hash rows per sketch
    analytics_lanes: int = 4           # cardinality hash-max lanes
    analytics_stripe: int = 16         # 1-in-N update stripe (the
    #   fused-overhead budget: scatter cost scales with the sampled
    #   fraction; 16 holds the analytics-overhead bench gate)
    analytics_drain_interval_s: float = 1.0  # 0 disables the controller
    analytics_top_k: int = 8           # exported heavy-hitter gauge cap
    analytics_scan_ports: int = 16     # scan-suspect distinct-dport bar
    analytics_hh_share: float = 0.25   # heavy-hitter byte-share bar
    kvstore: str = "memory"
    kvstore_opts: Dict[str, str] = field(default_factory=dict)
    # runtime-mutable option map shared by new endpoints
    opts: IntOptions = field(default_factory=lambda: IntOptions(defaults={
        "Policy": OPTION_ENABLED,
        "IngressPolicy": OPTION_ENABLED,
        "EgressPolicy": OPTION_ENABLED,
        "Conntrack": OPTION_ENABLED,
        "ConntrackAccounting": OPTION_ENABLED,
        "DropNotification": OPTION_ENABLED,
        "TraceNotification": OPTION_ENABLED,
    }))

    def always_allow_localhost(self) -> bool:
        return self.allow_localhost == "always"
