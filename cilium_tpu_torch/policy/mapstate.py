"""Desired policy-map state: the per-endpoint key/value verdict set.

A whole copy of ``cilium_tpu/policy/mapstate.py``, except that
``PolicyKey`` raises ``ValueError`` for a field out of range where the
reference asserts.

Mirrors the reference's per-endpoint policy map computation
(pkg/endpoint/policy.go:254 computeDesiredPolicyMapState +
convertL4FilterToPolicyMapKeys + computeDesiredL3PolicyMapEntries) and the
datapath key layout (bpf/lib/common.h:180-193 policy_key/policy_entry,
pkg/maps/policymap/policymap.go:64-80).

One deliberate TPU-first divergence: an L4 filter that allows all peers at
L3 compiles to a single wildcard key ``(identity=0, port, proto)`` —
exactly the eBPF stage-3 fallback key — instead of one key per known
identity. This collapses the reference's O(identities × rules) blow-up for
wildcard rules while preserving verdict semantics under the 3-stage lookup.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import identity as idpkg
from ..labels import LabelArray
from . import api
from .api import Decision, EndpointSelector
from .l4 import L4Filter, L4Policy
from .repository import Repository
from .trace import SearchContext

# Traffic direction (reference: pkg/maps/policymap — Ingress/Egress).
INGRESS = 0
EGRESS = 1

# Max entries per endpoint policy map (reference: policymap.go:37).
POLICYMAP_MAX_ENTRIES = 16384


@dataclass(frozen=True)
class PolicyKey:
    """Reference: policymap.go:64 PolicyKey (host byte-order port)."""

    identity: int = 0
    dest_port: int = 0
    nexthdr: int = 0
    direction: int = INGRESS

    def __post_init__(self):
        if not (0 <= self.identity < 2 ** 32 and
                0 <= self.dest_port < 2 ** 16 and
                0 <= self.nexthdr < 2 ** 8):
            raise ValueError(f"PolicyKey field out of range: {self}")


@dataclass
class PolicyMapStateEntry:
    """Reference: policymap.go:73 PolicyEntry (counters live on-device)."""

    proxy_port: int = 0


class PolicyMapState(Dict[PolicyKey, PolicyMapStateEntry]):
    """The desired verdict set for one endpoint."""


# Keys always considered (reference: endpoint/policy.go localHostKey/worldKey).
LOCALHOST_KEY = PolicyKey(identity=idpkg.RESERVED_HOST, direction=INGRESS)
WORLD_KEY = PolicyKey(identity=idpkg.RESERVED_WORLD, direction=INGRESS)


def get_security_identities(identity_cache: Dict[int, LabelArray],
                            selector: EndpointSelector) -> List[int]:
    """All identities whose labels the selector matches.

    Reference: endpoint/policy.go:85 getSecurityIdentities.
    """
    return sorted(numeric for numeric, labels in identity_cache.items()
                  if selector.matches(labels))


def convert_l4_filter_to_policy_map_keys(
        flt: L4Filter, direction: int,
        identity_cache: Dict[int, LabelArray],
        proxy_port: int = 0,
        wildcard_compression: bool = True) -> Dict[PolicyKey, PolicyMapStateEntry]:
    """L4 filter -> policy map keys.

    Reference: endpoint/policy.go:111 convertL4FilterToPolicyMapKeys; with
    ``wildcard_compression`` an allow-all-at-L3 filter emits the single
    stage-3 wildcard key instead of per-identity keys.
    """
    out: Dict[PolicyKey, PolicyMapStateEntry] = {}
    port = flt.port
    proto = flt.u8proto
    if wildcard_compression and flt.allows_all_at_l3():
        out[PolicyKey(identity=0, dest_port=port, nexthdr=proto,
                      direction=direction)] = PolicyMapStateEntry(proxy_port)
        return out
    for sel in flt.endpoints:
        for numeric in get_security_identities(identity_cache, sel):
            out[PolicyKey(identity=numeric, dest_port=port, nexthdr=proto,
                          direction=direction)] = PolicyMapStateEntry(proxy_port)
    return out


@dataclass
class EndpointPolicyConfig:
    """Per-endpoint enforcement switches (reference: endpoint option
    model — ingress/egress enforcement + daemon host-allow options)."""

    ingress_enforcement: bool = True
    egress_enforcement: bool = True
    always_allow_localhost: bool = False
    host_allows_world: bool = False


def compute_desired_policy_map_state(
        repo: Repository,
        identity_cache: Dict[int, LabelArray],
        endpoint_labels: LabelArray,
        l4_policy: Optional[L4Policy] = None,
        redirect_port_for: Optional[Callable[[L4Filter], int]] = None,
        config: Optional[EndpointPolicyConfig] = None) -> PolicyMapState:
    """Full desired map state for one endpoint.

    Reference: endpoint/policy.go:254 computeDesiredPolicyMapState:
    L4 entries, then allow-localhost / allow-world, then the
    per-identity L3 loop (policy.go:298-371).
    """
    cfg = config or EndpointPolicyConfig()
    state = PolicyMapState()

    if l4_policy is None:
        ingress_ctx = SearchContext(to_labels=endpoint_labels)
        egress_ctx = SearchContext(from_labels=endpoint_labels)
        l4_policy = L4Policy(
            ingress=repo.resolve_l4_ingress_policy(ingress_ctx),
            egress=repo.resolve_l4_egress_policy(egress_ctx),
            revision=repo.revision)

    # L4 entries (+ redirect proxy ports).
    for flt in l4_policy.ingress.values():
        pp = redirect_port_for(flt) if (redirect_port_for and
                                        flt.is_redirect()) else 0
        state.update(convert_l4_filter_to_policy_map_keys(
            flt, INGRESS, identity_cache, proxy_port=pp))
    for flt in l4_policy.egress.values():
        pp = redirect_port_for(flt) if (redirect_port_for and
                                        flt.is_redirect()) else 0
        state.update(convert_l4_filter_to_policy_map_keys(
            flt, EGRESS, identity_cache, proxy_port=pp))

    # Allow localhost (policy.go:263 determineAllowLocalhost).
    if cfg.always_allow_localhost or l4_policy.has_redirect():
        state[LOCALHOST_KEY] = PolicyMapStateEntry()
        # Legacy world-allow rides on localhost-allow (policy.go:283).
        if cfg.host_allows_world:
            state[WORLD_KEY] = PolicyMapStateEntry()

    # L3 (label-based) entries: one per allowed identity
    # (policy.go:298-371 computeDesiredL3PolicyMapEntries).
    ingress_ctx = SearchContext(to_labels=endpoint_labels)
    egress_ctx = SearchContext(from_labels=endpoint_labels)
    for numeric, labels in identity_cache.items():
        ingress_ctx.from_labels = labels
        egress_ctx.to_labels = labels
        if not cfg.ingress_enforcement or \
                repo.allows_ingress_label_access(ingress_ctx) == Decision.ALLOWED:
            state[PolicyKey(identity=numeric,
                            direction=INGRESS)] = PolicyMapStateEntry()
        if not cfg.egress_enforcement or \
                repo.allows_egress_label_access(egress_ctx) == Decision.ALLOWED:
            state[PolicyKey(identity=numeric,
                            direction=EGRESS)] = PolicyMapStateEntry()

    if len(state) > POLICYMAP_MAX_ENTRIES:
        raise api.PolicyError(
            f"policy map overflow: {len(state)}/{POLICYMAP_MAX_ENTRIES}")
    return state


def diff_map_state(realized: PolicyMapState,
                   desired: PolicyMapState
                   ) -> Tuple[List[Tuple[PolicyKey, PolicyMapStateEntry]],
                              List[PolicyKey]]:
    """(adds/updates, deletes) to turn ``realized`` into ``desired``.

    Reference: endpoint/bpf.go:607,762 syncPolicyMap — the incremental
    diff that becomes a minimal device-buffer delta.
    """
    adds = [(k, v) for k, v in desired.items()
            if k not in realized or realized[k].proxy_port != v.proxy_port]
    deletes = [k for k in realized if k not in desired]
    return adds, deletes
