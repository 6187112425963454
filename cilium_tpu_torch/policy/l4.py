"""Resolved L4 policy: per-port filters with L7 payload, and merge logic.

A whole copy of ``cilium_tpu/policy/l4.py``.

Reference: pkg/policy/l4.go (L4Filter, L4PolicyMap, L4Policy) and the merge
functions in pkg/policy/rule.go:36-135 (mergeL4Port / mergeL4IngressPort),
including L7 parser-conflict detection.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..labels import LabelArray
from . import api
from .api import (Decision, EndpointSelector, EndpointSelectorSlice, L7Rules,
                  PolicyError, PortProtocol, PortRule, WILDCARD_SELECTOR)
from .trace import Port, SearchContext

# L7 parser types (reference: l4.go:80-87).
PARSER_TYPE_NONE = ""
PARSER_TYPE_HTTP = "http"
PARSER_TYPE_KAFKA = "kafka"


class L7DataMap(Dict[EndpointSelector, L7Rules]):
    """Per-source-selector L7 rules (reference: l4.go:32 L7DataMap)."""

    def add_rules_for_endpoints(self, rules: L7Rules,
                                endpoints: Sequence[EndpointSelector]) -> None:
        """Reference: l4.go:146 addRulesForEndpoints."""
        if len(rules) == 0 and not rules.l7proto:
            return
        if endpoints:
            for sel in endpoints:
                self[sel] = rules.copy()
        else:
            self[WILDCARD_SELECTOR] = rules.copy()

    def get_relevant_rules(self, identity_labels: Optional[LabelArray]) -> L7Rules:
        """Collect L7 rules whose selector matches the remote identity.

        Reference: l4.go:118 GetRelevantRules.
        """
        out = L7Rules()
        if identity_labels is not None:
            for sel, rules in self.items():
                if sel.is_wildcard():
                    continue
                if sel.matches(identity_labels):
                    _extend_l7(out, rules)
        wildcard = self.get(WILDCARD_SELECTOR)
        if wildcard is not None:
            _extend_l7(out, wildcard)
        return out


def _extend_l7(dst: L7Rules, src: L7Rules) -> None:
    dst.http.extend(src.http)
    dst.kafka.extend(src.kafka)
    if src.l7proto:
        dst.l7proto = src.l7proto
    dst.l7.extend(src.l7)


@dataclass
class L4Filter:
    """A resolved per-port filter (reference: l4.go:89)."""

    port: int
    protocol: str
    u8proto: int
    endpoints: EndpointSelectorSlice = field(default_factory=EndpointSelectorSlice)
    l7_parser: str = PARSER_TYPE_NONE
    l7_rules_per_ep: L7DataMap = field(default_factory=L7DataMap)
    ingress: bool = True
    derived_from_rules: List[LabelArray] = field(default_factory=list)

    def allows_all_at_l3(self) -> bool:
        return self.endpoints.selects_all()

    def is_redirect(self) -> bool:
        return self.l7_parser != PARSER_TYPE_NONE

    def matches_labels(self, labels: LabelArray) -> bool:
        if self.allows_all_at_l3():
            return True
        if len(labels) == 0:
            return False
        return any(sel.matches(labels) for sel in self.endpoints)


def create_l4_filter(peer_endpoints: Sequence[EndpointSelector],
                     rule: PortRule, port: PortProtocol, protocol: str,
                     rule_labels: LabelArray, ingress: bool) -> L4Filter:
    """Reference: l4.go:162 CreateL4Filter."""
    p = int(port.port)
    u8p = api.U8PROTO.get(protocol, 0)
    filter_endpoints = EndpointSelectorSlice(peer_endpoints)
    if filter_endpoints.selects_all():
        filter_endpoints = EndpointSelectorSlice([WILDCARD_SELECTOR])

    l4 = L4Filter(port=p, protocol=protocol, u8proto=u8p,
                  endpoints=filter_endpoints, ingress=ingress,
                  derived_from_rules=[rule_labels])

    if protocol == api.PROTO_TCP and rule.rules is not None:
        if rule.rules.http:
            l4.l7_parser = PARSER_TYPE_HTTP
        elif rule.rules.kafka:
            l4.l7_parser = PARSER_TYPE_KAFKA
        elif rule.rules.l7proto:
            l4.l7_parser = rule.rules.l7proto
        if not rule.rules.is_empty():
            if filter_endpoints:
                for sel in filter_endpoints:
                    l4.l7_rules_per_ep[sel] = rule.rules.copy()
            else:
                l4.l7_rules_per_ep[WILDCARD_SELECTOR] = rule.rules.copy()
    return l4


def create_l4_ingress_filter(from_endpoints: Sequence[EndpointSelector],
                             endpoints_with_l3_override: Sequence[EndpointSelector],
                             rule: PortRule, port: PortProtocol, protocol: str,
                             rule_labels: LabelArray) -> L4Filter:
    """Reference: l4.go CreateL4IngressFilter — L3-override endpoints get
    their L7 rules wildcarded (allow-all via proxy)."""
    f = create_l4_filter(from_endpoints, rule, port, protocol, rule_labels, True)
    if rule.rules is not None and not rule.rules.is_empty():
        for sel in endpoints_with_l3_override:
            f.l7_rules_per_ep[sel] = L7Rules()
    return f


def create_l4_egress_filter(to_endpoints: Sequence[EndpointSelector],
                            rule: PortRule, port: PortProtocol, protocol: str,
                            rule_labels: LabelArray) -> L4Filter:
    return create_l4_filter(to_endpoints, rule, port, protocol, rule_labels, False)


class L4PolicyMap(Dict[str, L4Filter]):
    """Filters keyed ``"port/proto"`` (reference: l4.go:275)."""

    def has_redirect(self) -> bool:
        return any(f.is_redirect() for f in self.values())

    def contains_all_l3_l4(self, labels: LabelArray,
                           ports: Sequence[Port]) -> Decision:
        """Coverage check used by the trace API.

        Reference: l4.go:300 containsAllL3L4.
        """
        if len(self) == 0:
            return Decision.ALLOWED
        if len(ports) == 0:
            return Decision.DENIED
        for l4ctx in ports:
            proto = (l4ctx.protocol or "ANY").upper()
            if proto == "ANY":
                ok = False
                for pr in (api.PROTO_TCP, api.PROTO_UDP):
                    f = self.get(f"{l4ctx.port}/{pr}")
                    if f is not None and f.matches_labels(labels):
                        ok = True
                if not ok:
                    return Decision.DENIED
            else:
                f = self.get(f"{l4ctx.port}/{proto}")
                if f is None or not f.matches_labels(labels):
                    return Decision.DENIED
        return Decision.ALLOWED

    def ingress_covers_context(self, ctx: SearchContext) -> Decision:
        return self.contains_all_l3_l4(ctx.from_labels, ctx.dports)

    def egress_covers_context(self, ctx: SearchContext) -> Decision:
        return self.contains_all_l3_l4(ctx.to_labels, ctx.dports)


@dataclass
class L4Policy:
    """Reference: l4.go:337 (L4Policy)."""

    ingress: L4PolicyMap = field(default_factory=L4PolicyMap)
    egress: L4PolicyMap = field(default_factory=L4PolicyMap)
    revision: int = 0

    def has_redirect(self) -> bool:
        return self.ingress.has_redirect() or self.egress.has_redirect()

    def requires_conntrack(self) -> bool:
        return len(self.ingress) > 0 or len(self.egress) > 0


# ---------------------------------------------------------------------------
# Merge logic (reference: pkg/policy/rule.go:36-135)
# ---------------------------------------------------------------------------

def merge_l4_port(ctx: SearchContext, endpoints: Sequence[EndpointSelector],
                  existing: L4Filter, to_merge: L4Filter) -> None:
    """Merge ``to_merge`` into ``existing`` (same port/proto).

    Raises PolicyError on L7 parser / rule-type conflicts.
    Reference: rule.go:36 mergeL4Port.
    """
    if existing.allows_all_at_l3() or to_merge.allows_all_at_l3():
        existing.endpoints = EndpointSelectorSlice([WILDCARD_SELECTOR])
    else:
        existing.endpoints.extend(endpoints)

    if to_merge.l7_parser != PARSER_TYPE_NONE:
        if existing.l7_parser == PARSER_TYPE_NONE:
            existing.l7_parser = to_merge.l7_parser
        elif to_merge.l7_parser != existing.l7_parser:
            ctx.policy_trace("   Merge conflict: mismatching parsers %s/%s\n",
                             to_merge.l7_parser, existing.l7_parser)
            raise PolicyError(
                f"cannot merge conflicting L7 parsers "
                f"({to_merge.l7_parser}/{existing.l7_parser})")

    for sel, new_rules in to_merge.l7_rules_per_ep.items():
        ep = existing.l7_rules_per_ep.get(sel)
        if ep is None:
            existing.l7_rules_per_ep[sel] = new_rules.copy()
            continue
        if new_rules.http:
            if ep.kafka or ep.l7proto:
                ctx.policy_trace("   Merge conflict: mismatching L7 rule types.\n")
                raise PolicyError("cannot merge conflicting L7 rule types")
            for r in new_rules.http:
                if not r.exists(ep.http):
                    ep.http.append(r)
        elif new_rules.kafka:
            if ep.http or ep.l7proto:
                ctx.policy_trace("   Merge conflict: mismatching L7 rule types.\n")
                raise PolicyError("cannot merge conflicting L7 rule types")
            for r in new_rules.kafka:
                if not r.exists(ep.kafka):
                    ep.kafka.append(r)
        elif new_rules.l7proto:
            if ep.kafka or ep.http or (ep.l7proto and
                                       ep.l7proto != new_rules.l7proto):
                ctx.policy_trace("   Merge conflict: mismatching L7 rule types.\n")
                raise PolicyError("cannot merge conflicting L7 rule types")
            if not ep.l7proto:
                ep.l7proto = new_rules.l7proto
            for r in new_rules.l7:
                if not r.exists(ep.l7):
                    ep.l7.append(r)
        else:
            ctx.policy_trace("   No L7 rules to merge.\n")


def merge_l4_ingress_port(ctx: SearchContext,
                          endpoints: Sequence[EndpointSelector],
                          endpoints_with_l3_override: Sequence[EndpointSelector],
                          rule: PortRule, port: PortProtocol, proto: str,
                          rule_labels: LabelArray,
                          res_map: L4PolicyMap) -> int:
    """Reference: rule.go:121 mergeL4IngressPort."""
    key = f"{port.port}/{proto}"
    existing = res_map.get(key)
    if existing is None:
        res_map[key] = create_l4_ingress_filter(
            endpoints, endpoints_with_l3_override, rule, port, proto, rule_labels)
        return 1
    to_merge = create_l4_ingress_filter(
        endpoints, endpoints_with_l3_override, rule, port, proto, rule_labels)
    merge_l4_port(ctx, endpoints, existing, to_merge)
    existing.derived_from_rules.append(rule_labels)
    return 1


def merge_l4_egress_port(ctx: SearchContext,
                         endpoints: Sequence[EndpointSelector],
                         rule: PortRule, port: PortProtocol, proto: str,
                         rule_labels: LabelArray,
                         res_map: L4PolicyMap) -> int:
    """Reference: rule.go mergeL4EgressPort."""
    key = f"{port.port}/{proto}"
    existing = res_map.get(key)
    if existing is None:
        res_map[key] = create_l4_egress_filter(endpoints, rule, port, proto,
                                               rule_labels)
        return 1
    to_merge = create_l4_egress_filter(endpoints, rule, port, proto, rule_labels)
    merge_l4_port(ctx, endpoints, existing, to_merge)
    existing.derived_from_rules.append(rule_labels)
    return 1
