"""The Endpoint: workload attachment point with its own policy state.

Reference: pkg/endpoint/endpoint.go (state machine :237-254,
SetStateLocked transition rules), pkg/endpoint/policy.go
(regeneratePolicy :482, computeDesiredPolicyMapState :254) and
pkg/endpoint/bpf.go (regenerateBPF :467, syncPolicyMap :607,
writeHeaderfile :88 — here a JSON checkpoint instead of a C header).

A whole copy of ``cilium_tpu/endpoint/endpoint.py``; its checkpoint
JSON is byte-compatible with the reference's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import identity as idpkg
from ..labels import LabelArray, Labels
from ..policy.l4 import L4Filter, L4Policy
from ..policy.mapstate import (EndpointPolicyConfig, PolicyKey,
                               PolicyMapState, PolicyMapStateEntry,
                               compute_desired_policy_map_state,
                               diff_map_state)
from ..policy.repository import Repository
from ..policy.trace import SearchContext
from ..utils.option import OPTION_ENABLED, IntOptions
from ..utils.spanstat import SpanStat

# New endpoints enforce policy with conntrack on unless overridden
# (reference: endpoints inherit the daemon's option map; see
# DaemonConfig.opts defaults in utils/option.py).
_DEFAULT_ENDPOINT_OPTS = {
    "Policy": OPTION_ENABLED,
    "IngressPolicy": OPTION_ENABLED,
    "EgressPolicy": OPTION_ENABLED,
    "Conntrack": OPTION_ENABLED,
    "ConntrackAccounting": OPTION_ENABLED,
}


class EndpointState:
    """Reference: endpoint.go:237-254 state set."""

    CREATING = "creating"
    WAITING_FOR_IDENTITY = "waiting-for-identity"
    READY = "ready"
    WAITING_TO_REGENERATE = "waiting-to-regenerate"
    REGENERATING = "regenerating"
    RESTORING = "restoring"
    DISCONNECTING = "disconnecting"
    DISCONNECTED = "disconnected"
    NOT_READY = "not-ready"


# Allowed transitions (reference: endpoint.go SetStateLocked's switch;
# disconnecting is reachable from everything, disconnected only from
# disconnecting).
_ALLOWED: Dict[str, Tuple[str, ...]] = {
    EndpointState.CREATING: (
        EndpointState.WAITING_FOR_IDENTITY, EndpointState.READY,
        EndpointState.DISCONNECTING),
    EndpointState.WAITING_FOR_IDENTITY: (
        EndpointState.READY, EndpointState.DISCONNECTING),
    EndpointState.READY: (
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.WAITING_TO_REGENERATE, EndpointState.REGENERATING,
        EndpointState.NOT_READY, EndpointState.DISCONNECTING),
    EndpointState.WAITING_TO_REGENERATE: (
        EndpointState.REGENERATING, EndpointState.DISCONNECTING),
    EndpointState.REGENERATING: (
        EndpointState.READY, EndpointState.NOT_READY,
        EndpointState.WAITING_TO_REGENERATE, EndpointState.DISCONNECTING),
    EndpointState.RESTORING: (
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.WAITING_TO_REGENERATE, EndpointState.REGENERATING,
        EndpointState.READY, EndpointState.DISCONNECTING),
    EndpointState.NOT_READY: (
        EndpointState.WAITING_FOR_IDENTITY,
        EndpointState.WAITING_TO_REGENERATE, EndpointState.READY,
        EndpointState.DISCONNECTING),
    EndpointState.DISCONNECTING: (EndpointState.DISCONNECTED,),
    EndpointState.DISCONNECTED: (),
}


class StateTransitionError(ValueError):
    pass


@dataclass
class RegenerationResult:
    """Outcome of one policy regeneration (spanstat timings included —
    reference logs these per stage, endpoint/policy.go:667-678)."""

    revision: int
    adds: List[Tuple[PolicyKey, PolicyMapStateEntry]]
    deletes: List[PolicyKey]
    redirects_added: List[str]
    redirects_removed: List[str]
    policy_calculation: SpanStat
    table_sync: SpanStat
    total: SpanStat


class Endpoint:
    """One managed endpoint."""

    def __init__(self, endpoint_id: int, ipv4: str = "",
                 container_name: str = "",
                 labels: Optional[Labels] = None,
                 opts: Optional[IntOptions] = None):
        self.id = endpoint_id
        self.ipv4 = ipv4
        self.container_name = container_name
        self.labels = labels or Labels()
        self.opts = opts or IntOptions(defaults=dict(_DEFAULT_ENDPOINT_OPTS))
        self.state = EndpointState.CREATING
        self.status_log: List[Tuple[float, str, str]] = []
        self.identity: Optional[idpkg.Identity] = None
        # realized vs desired policy map state (bpf.go realizedMapState)
        self.realized: PolicyMapState = PolicyMapState()
        self.desired: PolicyMapState = PolicyMapState()
        self.policy_revision = 0          # last fully-applied repo revision
        self.next_policy_revision = 0
        self.l4_policy: Optional[L4Policy] = None
        self.proxy_redirects: Dict[str, int] = {}  # proxy_id -> port
        self.table_slot: Optional[int] = None      # row in device tables
        self._lock = threading.RLock()

    # ------------------------------------------------------------- state

    def set_state(self, new_state: str, reason: str = "") -> bool:
        """Validated transition (endpoint.go SetStateLocked). Returns
        False (no raise) when the move is disallowed, mirroring the
        reference's boolean contract — except unknown states, which are
        programming errors."""
        with self._lock:
            if new_state not in _ALLOWED:
                raise StateTransitionError(f"unknown state {new_state!r}")
            if new_state == self.state:
                return False
            if new_state not in _ALLOWED[self.state]:
                return False
            self.state = new_state
            self.status_log.append((time.time(), new_state, reason))
            if len(self.status_log) > 128:
                self.status_log = self.status_log[-128:]
            return True

    # ---------------------------------------------------------- identity

    def update_labels(self, allocator, labels: Labels) -> bool:
        """Resolve security-relevant labels to an identity; returns True
        if the identity changed (triggering regeneration). Reference:
        endpoint label update path (endpoint.go UpdateLabels ->
        identityLabelsChanged)."""
        with self._lock:
            self.labels = Labels(labels)
            old = self.identity
            if self.state == EndpointState.CREATING:
                self.set_state(EndpointState.WAITING_FOR_IDENTITY,
                               "resolving identity")
            ident, _ = allocator.allocate(labels)
            self.identity = ident
            if self.state == EndpointState.WAITING_FOR_IDENTITY:
                self.set_state(EndpointState.READY, "identity resolved")
            changed = old is None or old.id != ident.id
        if old is not None:
            # drop the previous reference: on a same-labels resolve this
            # cancels the duplicate ref allocate() just took
            allocator.release(old)
        return changed

    @property
    def security_identity(self) -> int:
        with self._lock:
            return self.identity.id if self.identity else 0

    def label_array(self) -> LabelArray:
        with self._lock:
            return self.labels.to_array()

    # ------------------------------------------------------ regeneration

    def policy_config(self, always_allow_localhost: bool = False
                      ) -> EndpointPolicyConfig:
        return EndpointPolicyConfig(
            ingress_enforcement=self.opts.is_enabled("IngressPolicy") and
            self.opts.is_enabled("Policy"),
            egress_enforcement=self.opts.is_enabled("EgressPolicy") and
            self.opts.is_enabled("Policy"),
            always_allow_localhost=always_allow_localhost)

    def regenerate_policy(self, repo: Repository,
                          identity_cache: Dict[int, LabelArray],
                          proxy=None,
                          always_allow_localhost: bool = False
                          ) -> RegenerationResult:
        """Recompute desired policy state and the delta vs realized.

        Reference stack: endpoint/policy.go:482 regeneratePolicy →
        resolveL4Policy → computeDesiredPolicyMapState; redirects via
        proxy.CreateOrUpdateRedirect (bpf.go:356 addNewRedirects /
        :255 removeOldRedirects). The caller applies the delta to the
        device tables, then calls ``apply_regeneration``.
        """
        total = SpanStat().start()
        calc = SpanStat().start()
        with self._lock:
            ep_labels = self.labels.to_array()
            cfg = self.policy_config(always_allow_localhost)
            rev = repo.revision

            ingress_ctx = SearchContext(to_labels=ep_labels)
            egress_ctx = SearchContext(from_labels=ep_labels)
            l4 = L4Policy(
                ingress=repo.resolve_l4_ingress_policy(ingress_ctx),
                egress=repo.resolve_l4_egress_policy(egress_ctx),
                revision=rev)
            self.l4_policy = l4

            # redirects first: desired map entries need the proxy ports
            added_redirects: List[str] = []
            wanted_redirects: Dict[str, int] = {}

            def redirect_port(flt: L4Filter) -> int:
                if proxy is None:
                    return 0
                redir = proxy.create_or_update_redirect(flt, self.id)
                wanted_redirects[redir.id] = redir.proxy_port
                if redir.id not in self.proxy_redirects:
                    added_redirects.append(redir.id)
                return redir.proxy_port

            desired = compute_desired_policy_map_state(
                repo, identity_cache, ep_labels, l4_policy=l4,
                redirect_port_for=redirect_port, config=cfg)
            calc.end()

            removed_redirects = [rid for rid in self.proxy_redirects
                                 if rid not in wanted_redirects]
            if proxy is not None:
                for rid in removed_redirects:
                    proxy.remove_redirect(rid)
            self.proxy_redirects = wanted_redirects

            sync = SpanStat().start()
            adds, deletes = diff_map_state(self.realized, desired)
            sync.end()
            self.desired = desired
            self.next_policy_revision = rev
            total.end()
            return RegenerationResult(
                revision=rev, adds=adds, deletes=deletes,
                redirects_added=added_redirects,
                redirects_removed=removed_redirects,
                policy_calculation=calc, table_sync=sync, total=total)

    def apply_regeneration(self, result: RegenerationResult) -> None:
        """Mark the desired state realized (device sync succeeded)."""
        with self._lock:
            self.realized = PolicyMapState(self.desired)
            self.policy_revision = result.revision

    # -------------------------------------------------------- checkpoint

    def checkpoint(self) -> Dict:
        """Serializable endpoint state (the writeHeaderfile analog:
        everything needed to restore the endpoint after agent restart,
        daemon/state.go)."""
        from ..migrate import CHECKPOINT_VERSION
        with self._lock:
            return {
                "version": CHECKPOINT_VERSION,
                "family": 4,
                "id": self.id,
                "ipv4": self.ipv4,
                "container_name": self.container_name,
                "labels": [str(l) for l in self.labels.to_array()],
                "state": self.state,
                "policy_revision": self.policy_revision,
                "identity": self.security_identity,
                "realized": [
                    {"identity": k.identity, "dest_port": k.dest_port,
                     "nexthdr": k.nexthdr, "direction": k.direction,
                     "proxy_port": v.proxy_port}
                    for k, v in sorted(
                        self.realized.items(),
                        key=lambda kv: (kv[0].identity, kv[0].dest_port,
                                        kv[0].nexthdr, kv[0].direction))],
                "options": self.opts.dump(),
            }

    def write_checkpoint(self, state_dir: str) -> str:
        os.makedirs(state_dir, exist_ok=True)
        path = os.path.join(state_dir, f"ep_{self.id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.checkpoint(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def restore(cls, snapshot: Dict,
                opts: Optional[IntOptions] = None) -> "Endpoint":
        """Rebuild an endpoint from a checkpoint (daemon/state.go
        restoreOldEndpoints). Restored endpoints start in RESTORING and
        need a regeneration to become READY with fresh policy.  Old
        checkpoint versions are migrated forward first
        (cilium-map-migrate analog, migrate.py)."""
        from ..migrate import migrate_snapshot
        snapshot = migrate_snapshot(snapshot)
        ep = cls(endpoint_id=snapshot["id"], ipv4=snapshot.get("ipv4", ""),
                 container_name=snapshot.get("container_name", ""),
                 labels=Labels.from_model(snapshot.get("labels", [])),
                 opts=opts)
        ep.state = EndpointState.RESTORING
        ep.policy_revision = snapshot.get("policy_revision", 0)
        for e in snapshot.get("realized", []):
            ep.realized[PolicyKey(
                identity=e["identity"], dest_port=e["dest_port"],
                nexthdr=e["nexthdr"], direction=e["direction"])] = \
                PolicyMapStateEntry(proxy_port=e.get("proxy_port", 0))
        for name, value in (snapshot.get("options") or {}).items():
            # per-key so one stale option name from an older version
            # can't discard the rest of the checkpointed settings
            try:
                ep.opts.apply_validated({name: value})
            except (KeyError, ValueError):
                pass
        return ep

    def model(self) -> Dict:
        """REST model (api/v1 Endpoint)."""
        with self._lock:
            return {
                "id": self.id,
                "container-name": self.container_name,
                "addressing": {"ipv4": self.ipv4},
                "state": self.state,
                "identity": {
                    "id": self.security_identity,
                    "labels": [str(l) for l in
                               (self.identity.label_array
                                if self.identity else [])]},
                "labels": [str(l) for l in self.labels.to_array()],
                "policy-revision": self.policy_revision,
                "policy-enabled": self.opts.is_enabled("Policy"),
                # device-table row: verdict-service clients address
                # packets by this slot, not the endpoint id
                "table-slot": self.table_slot,
            }
