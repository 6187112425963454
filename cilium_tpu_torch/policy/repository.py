"""Policy repository: ordered rule list, revisioning, verdict evaluation,
L4/CIDR policy resolution.

A whole copy of ``cilium_tpu/policy/repository.py``.

Reference: pkg/policy/repository.go + the per-rule evaluation logic from
pkg/policy/rule.go. Verdict precedence: an unmet ``FromRequires`` constraint
always denies (short-circuits); otherwise any matching allow rule allows;
otherwise undecided (which hardens to deny at the Allows* level).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import labels as lbl
from ..labels import LabelArray
from . import api
from .api import (Decision, EndpointSelector, EndpointSelectorSlice,
                  IngressRule, EgressRule, PolicyError, Requirement, Rule)
from .l3 import CIDRPolicy, merge_cidr
from .l4 import (L4Policy, L4PolicyMap, merge_l4_egress_port,
                 merge_l4_ingress_port)
from .trace import SearchContext


@dataclass
class RepositoryConfig:
    """Daemon options that alter resolution (reference: pkg/option —
    AlwaysAllowLocalhost / HostAllowsWorld)."""

    always_allow_localhost: bool = False
    host_allows_world: bool = False


@dataclass
class _TraceState:
    """Reference: repository.go:50 traceState."""

    selected_rules: int = 0
    matched_rules: int = 0
    constrained_rules: int = 0
    rule_id: int = 0

    def trace(self, repo: "Repository", ctx: SearchContext) -> None:
        ctx.policy_trace("%d/%d rules selected\n", self.selected_rules,
                         len(repo._rules))
        if self.constrained_rules > 0:
            ctx.policy_trace("Found unsatisfied FromRequires constraint\n")
        elif self.matched_rules > 0:
            ctx.policy_trace("Found allow rule\n")
        else:
            ctx.policy_trace("Found no allow rule\n")

    def select_rule(self, ctx: SearchContext, r: Rule) -> None:
        ctx.policy_trace("* Rule {%s}: selected\n", _rule_name(r))
        self.selected_rules += 1

    def unselect_rule(self, ctx: SearchContext, labels: LabelArray,
                      r: Rule) -> None:
        ctx.policy_trace_verbose("  Rule {%s}: did not select %r\n",
                                 _rule_name(r), labels)


def _rule_name(r: Rule) -> str:
    return repr(r.endpoint_selector)


def _expand_proto(proto: str) -> List[str]:
    """ANY expands to TCP+UDP everywhere a concrete protocol is needed
    (matches the expansion in merge_l4_*; the reference's wildcard pass
    passes ANY through verbatim and thereby never matches the TCP/UDP
    filters it created — a fail-closed mismatch we do not reproduce)."""
    if proto == api.PROTO_ANY:
        return [api.PROTO_TCP, api.PROTO_UDP]
    return [proto]


def _with_requirements(sel: EndpointSelector,
                       reqs: Sequence[Requirement]) -> EndpointSelector:
    """Selector with extra requirements appended (used to fold FromRequires
    into FromEndpoints during L4 resolution; reference: rule.go:243-252)."""
    if not reqs:
        return sel
    merged = EndpointSelector(match_labels=dict(sel.match_labels),
                              _raw_keys=True)
    merged.requirements = tuple(sel.requirements) + tuple(reqs)
    merged._key = (sel._key, tuple((r.key, r.operator, r.values) for r in reqs))
    return merged


class Repository:
    """Ordered rule list + revision counter (reference: repository.go:31)."""

    def __init__(self, config: Optional[RepositoryConfig] = None):
        self.mutex = threading.RLock()
        self._rules: List[Rule] = []
        self._revision = 1
        self.config = config or RepositoryConfig()

    # -- rule management ----------------------------------------------------

    @property
    def revision(self) -> int:
        return self._revision

    def __len__(self):
        return len(self._rules)

    @property
    def rules(self) -> List[Rule]:
        return list(self._rules)

    def add(self, r: Rule) -> int:
        """Sanitize + insert one rule; returns new revision."""
        with self.mutex:
            r.sanitize()
            return self.add_list_locked([r])

    def add_list(self, rules: Sequence[Rule]) -> int:
        with self.mutex:
            for r in rules:
                r.sanitize()
            return self.add_list_locked(rules)

    def add_list_locked(self, rules: Sequence[Rule]) -> int:
        """Reference: repository.go:544 AddListLocked (rules pre-sanitized)."""
        self._rules.extend(rules)
        self._revision += 1
        return self._revision

    def delete_by_labels(self, labels: LabelArray) -> Tuple[int, int]:
        """Delete rules whose labels contain ``labels``; returns
        (revision, deleted). Reference: repository.go:566."""
        with self.mutex:
            kept = [r for r in self._rules if not r.labels.contains(labels)]
            deleted = len(self._rules) - len(kept)
            if deleted > 0:
                self._rules = kept
                self._revision += 1
            return self._revision, deleted

    def search(self, labels: LabelArray) -> List[Rule]:
        """Rules carrying all of ``labels`` (reference: repository.go
        SearchRLocked)."""
        with self.mutex:
            return [r for r in self._rules if r.labels.contains(labels)]

    def get_rules_matching(self, labels: LabelArray) -> Tuple[List[Rule], bool]:
        """(rules whose selector matches labels, any-match)."""
        with self.mutex:
            out = [r for r in self._rules
                   if r.endpoint_selector.matches(labels)]
            return out, bool(out)

    def contains_all_labels(self, labels_list: Sequence[LabelArray]) -> bool:
        """True if for each label set there is a rule carrying it."""
        with self.mutex:
            return all(any(r.labels.contains(ls) for r in self._rules)
                       for ls in labels_list)

    def to_model(self) -> List[Dict]:
        with self.mutex:
            return [_rule_to_model(r) for r in self._rules]

    # -- label-level verdict (L3) ------------------------------------------

    def can_reach_ingress(self, ctx: SearchContext) -> Decision:
        """Reference: repository.go:80 CanReachIngressRLocked."""
        with self.mutex:
            return self._can_reach_ingress_locked(ctx)

    def _can_reach_ingress_locked(self, ctx: SearchContext) -> Decision:
        decision = Decision.UNDECIDED
        state = _TraceState()
        for i, r in enumerate(self._rules):
            state.rule_id = i
            d = self._rule_can_reach_ingress(r, ctx, state)
            if d == Decision.DENIED:
                decision = Decision.DENIED
                break
            elif d == Decision.ALLOWED:
                decision = Decision.ALLOWED
        state.trace(self, ctx)
        return decision

    def can_reach_egress(self, ctx: SearchContext) -> Decision:
        with self.mutex:
            return self._can_reach_egress_locked(ctx)

    def _can_reach_egress_locked(self, ctx: SearchContext) -> Decision:
        decision = Decision.UNDECIDED
        state = _TraceState()
        for i, r in enumerate(self._rules):
            state.rule_id = i
            d = self._rule_can_reach_egress(r, ctx, state)
            if d == Decision.DENIED:
                decision = Decision.DENIED
                break
            elif d == Decision.ALLOWED:
                decision = Decision.ALLOWED
        state.trace(self, ctx)
        return decision

    def _rule_can_reach_ingress(self, r: Rule, ctx: SearchContext,
                                state: _TraceState) -> Decision:
        """Reference: rule.go:352 canReachIngress — FromRequires failure
        takes precedence over any FromEndpoints allow."""
        if not r.endpoint_selector.matches(ctx.to_labels):
            state.unselect_rule(ctx, ctx.to_labels, r)
            return Decision.UNDECIDED
        state.select_rule(ctx, r)
        for ing in r.ingress:
            for sel in ing.from_requires:
                ctx.policy_trace("    Requires from labels %r", sel)
                if not sel.matches(ctx.from_labels):
                    ctx.policy_trace("-     Labels %r not found\n",
                                     ctx.from_labels)
                    state.constrained_rules += 1
                    return Decision.DENIED
                ctx.policy_trace("+     Found all required labels\n")
        for ing in r.ingress:
            for sel in ing.get_source_endpoint_selectors():
                ctx.policy_trace("    Allows from labels %r", sel)
                if sel.matches(ctx.from_labels):
                    ctx.policy_trace("      Found all required labels")
                    if not ing.to_ports:
                        ctx.policy_trace("+       No L4 restrictions\n")
                        state.matched_rules += 1
                        return Decision.ALLOWED
                    ctx.policy_trace(
                        "        Rule restricts traffic to specific L4 "
                        "destinations; deferring policy decision to L4 "
                        "policy stage\n")
                else:
                    ctx.policy_trace("      Labels %r not found\n",
                                     ctx.from_labels)
        return Decision.UNDECIDED

    def _rule_can_reach_egress(self, r: Rule, ctx: SearchContext,
                               state: _TraceState) -> Decision:
        """Reference: rule.go canReachEgress (selector applies to ctx.From)."""
        if not r.endpoint_selector.matches(ctx.from_labels):
            state.unselect_rule(ctx, ctx.from_labels, r)
            return Decision.UNDECIDED
        state.select_rule(ctx, r)
        for eg in r.egress:
            for sel in eg.to_requires:
                ctx.policy_trace("    Requires to labels %r", sel)
                if not sel.matches(ctx.to_labels):
                    ctx.policy_trace("-     Labels %r not found\n",
                                     ctx.to_labels)
                    state.constrained_rules += 1
                    return Decision.DENIED
                ctx.policy_trace("+     Found all required labels\n")
        for eg in r.egress:
            for sel in eg.get_destination_endpoint_selectors():
                ctx.policy_trace("    Allows to labels %r", sel)
                if sel.matches(ctx.to_labels):
                    ctx.policy_trace("      Found all required labels")
                    if not eg.to_ports:
                        ctx.policy_trace("+       No L4 restrictions\n")
                        state.matched_rules += 1
                        return Decision.ALLOWED
                    ctx.policy_trace(
                        "        Rule restricts traffic to specific L4 "
                        "destinations; deferring policy decision to L4 "
                        "policy stage\n")
                else:
                    ctx.policy_trace("      Labels %r not found\n",
                                     ctx.to_labels)
        return Decision.UNDECIDED

    # -- full verdict (L3 + L4) --------------------------------------------

    def allows_ingress_label_access(self, ctx: SearchContext) -> Decision:
        """Label-only verdict; undecided hardens to deny.
        Reference: repository.go:107 AllowsIngressLabelAccess."""
        with self.mutex:
            return self._allows_ingress_label_access_locked(ctx)

    def _allows_ingress_label_access_locked(self, ctx: SearchContext) -> Decision:
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = Decision.DENIED
        if not self._rules:
            ctx.policy_trace("  No rules found\n")
        elif self.can_reach_ingress(ctx) == Decision.ALLOWED:
            decision = Decision.ALLOWED
        ctx.policy_trace("Label verdict: %s", str(decision))
        return decision

    def allows_egress_label_access(self, ctx: SearchContext) -> Decision:
        with self.mutex:
            return self._allows_egress_label_access_locked(ctx)

    def _allows_egress_label_access_locked(self, ctx: SearchContext) -> Decision:
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = Decision.DENIED
        if not self._rules:
            ctx.policy_trace("  No rules found\n")
        elif self.can_reach_egress(ctx) == Decision.ALLOWED:
            decision = Decision.ALLOWED
        ctx.policy_trace("Egress label verdict: %s", str(decision))
        return decision

    def allows_ingress(self, ctx: SearchContext) -> Decision:
        """L3 verdict, falling back to L4 when ports are given.
        Reference: repository.go:397 AllowsIngressRLocked."""
        with self.mutex:
            return self._allows_ingress_locked(ctx)

    def _allows_ingress_locked(self, ctx: SearchContext) -> Decision:
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = self.can_reach_ingress(ctx)
        ctx.policy_trace("Label verdict: %s", str(decision))
        if decision == Decision.ALLOWED:
            ctx.policy_trace("L4 ingress policies skipped")
            return decision
        if ctx.dports:
            decision = self._allows_l4_ingress(ctx)
        if decision != Decision.ALLOWED:
            decision = Decision.DENIED
        return decision

    def allows_egress(self, ctx: SearchContext) -> Decision:
        with self.mutex:
            return self._allows_egress_locked(ctx)

    def _allows_egress_locked(self, ctx: SearchContext) -> Decision:
        ctx.policy_trace("Tracing %s\n", str(ctx))
        decision = self.can_reach_egress(ctx)
        ctx.policy_trace("Egress label verdict: %s", str(decision))
        if decision == Decision.ALLOWED:
            ctx.policy_trace("L4 egress policies skipped")
            return decision
        if ctx.dports:
            decision = self._allows_l4_egress(ctx)
        if decision != Decision.ALLOWED:
            decision = Decision.DENIED
        return decision

    def _allows_l4_ingress(self, ctx: SearchContext) -> Decision:
        l4 = self.resolve_l4_ingress_policy(ctx)
        verdict = Decision.UNDECIDED
        if len(l4) > 0:
            verdict = l4.ingress_covers_context(ctx)
        ctx.policy_trace("L4 ingress verdict: %s", str(verdict))
        return verdict

    def _allows_l4_egress(self, ctx: SearchContext) -> Decision:
        l4 = self.resolve_l4_egress_policy(ctx)
        verdict = Decision.UNDECIDED
        if len(l4) > 0:
            verdict = l4.egress_covers_context(ctx)
        ctx.policy_trace("L4 egress verdict: %s", str(verdict))
        return verdict

    # -- L4 policy resolution ----------------------------------------------

    def _l3_override_endpoints(self) -> List[EndpointSelector]:
        """Reference: rule.go mergeL4Ingress — daemon options may force L3
        allows for host/world; L7 rules on those become allow-all."""
        out: List[EndpointSelector] = []
        if self.config.always_allow_localhost:
            out.append(api.RESERVED_ENDPOINT_SELECTORS[lbl.ID_NAME_HOST])
            if self.config.host_allows_world:
                out.append(api.RESERVED_ENDPOINT_SELECTORS[lbl.ID_NAME_WORLD])
        return out

    def resolve_l4_ingress_policy(self, ctx: SearchContext) -> L4PolicyMap:
        """Reference: repository.go:245 ResolveL4IngressPolicy."""
        with self.mutex:
            return self._resolve_l4_ingress_policy_locked(ctx)

    def _resolve_l4_ingress_policy_locked(self, ctx: SearchContext) -> L4PolicyMap:
        result = L4PolicyMap()
        ctx.policy_trace("\n")
        ctx.policy_trace("Resolving ingress port policy for %r\n",
                         ctx.to_labels)
        state = _TraceState()

        # Fold all FromRequires of rules selecting ctx.To into requirements
        # appended to every FromEndpoints selector (rule.go:243-252).
        requirements: List[Requirement] = []
        for r in self._rules:
            if r.endpoint_selector.matches(ctx.to_labels):
                for ing in r.ingress:
                    for sel in ing.from_requires:
                        requirements.extend(sel.requirements)

        for r in self._rules:
            found = self._resolve_l4_ingress_rule(r, ctx, state, result,
                                                  requirements)
            state.rule_id += 1
            if found:
                state.matched_rules += 1
        self._wildcard_l3_l4_rules(ctx, True, result)
        state.trace(self, ctx)
        return result

    def resolve_l4_egress_policy(self, ctx: SearchContext) -> L4PolicyMap:
        with self.mutex:
            return self._resolve_l4_egress_policy_locked(ctx)

    def _resolve_l4_egress_policy_locked(self, ctx: SearchContext) -> L4PolicyMap:
        result = L4PolicyMap()
        ctx.policy_trace("\n")
        ctx.policy_trace("Resolving egress port policy for %r\n",
                         ctx.from_labels)
        state = _TraceState()
        requirements: List[Requirement] = []
        for r in self._rules:
            if r.endpoint_selector.matches(ctx.from_labels):
                for eg in r.egress:
                    for sel in eg.to_requires:
                        requirements.extend(sel.requirements)
        for r in self._rules:
            found = self._resolve_l4_egress_rule(r, ctx, state, result,
                                                 requirements)
            state.rule_id += 1
            if found:
                state.matched_rules += 1
        self._wildcard_l3_l4_rules(ctx, False, result)
        state.trace(self, ctx)
        return result

    def _resolve_l4_ingress_rule(self, r: Rule, ctx: SearchContext,
                                 state: _TraceState, result: L4PolicyMap,
                                 requirements: Sequence[Requirement]) -> int:
        if not r.endpoint_selector.matches(ctx.to_labels):
            state.unselect_rule(ctx, ctx.to_labels, r)
            return 0
        state.select_rule(ctx, r)
        found = 0
        if not r.ingress:
            ctx.policy_trace("    No L4 ingress rules\n")
        for ing in r.ingress:
            if requirements:
                ing = IngressRule(
                    from_endpoints=[_with_requirements(s, requirements)
                                    for s in ing.from_endpoints],
                    from_requires=list(ing.from_requires),
                    to_ports=ing.to_ports,
                    from_cidr=list(ing.from_cidr),
                    from_cidr_set=list(ing.from_cidr_set),
                    from_entities=list(ing.from_entities))
            found += self._merge_l4_ingress(ing, ctx, r.labels, result)
        return found

    def _merge_l4_ingress(self, rule: IngressRule, ctx: SearchContext,
                          rule_labels: LabelArray,
                          res_map: L4PolicyMap) -> int:
        """Reference: rule.go:143 mergeL4Ingress."""
        if not rule.to_ports:
            ctx.policy_trace("    No L4 Ingress rules\n")
            return 0
        from_endpoints = rule.get_source_endpoint_selectors()
        if ctx.from_labels and len(from_endpoints) > 0:
            if not from_endpoints.matches(ctx.from_labels):
                ctx.policy_trace("    Labels %r not found", ctx.from_labels)
                return 0
        ctx.policy_trace("    Found all required labels")
        overrides = self._l3_override_endpoints()
        found = 0
        for pr in rule.to_ports:
            ctx.policy_trace("    Allows Ingress port %r from endpoints %r\n",
                             pr.ports, from_endpoints)
            for p in pr.ports:
                protos = ([p.protocol] if p.protocol != api.PROTO_ANY
                          else [api.PROTO_TCP, api.PROTO_UDP])
                for proto in protos:
                    found += merge_l4_ingress_port(
                        ctx, from_endpoints, overrides, pr, p, proto,
                        rule_labels, res_map)
        return found

    def _resolve_l4_egress_rule(self, r: Rule, ctx: SearchContext,
                                state: _TraceState, result: L4PolicyMap,
                                requirements: Sequence[Requirement]) -> int:
        if not r.endpoint_selector.matches(ctx.from_labels):
            state.unselect_rule(ctx, ctx.from_labels, r)
            return 0
        state.select_rule(ctx, r)
        found = 0
        if not r.egress:
            ctx.policy_trace("    No L4 egress rules\n")
        for eg in r.egress:
            if requirements:
                eg = EgressRule(
                    to_endpoints=[_with_requirements(s, requirements)
                                  for s in eg.to_endpoints],
                    to_requires=list(eg.to_requires),
                    to_ports=eg.to_ports,
                    to_cidr=list(eg.to_cidr),
                    to_cidr_set=list(eg.to_cidr_set),
                    to_entities=list(eg.to_entities),
                    to_services=list(eg.to_services),
                    to_fqdns=list(eg.to_fqdns))
            found += self._merge_l4_egress(eg, ctx, r.labels, result)
        return found

    def _merge_l4_egress(self, rule: EgressRule, ctx: SearchContext,
                         rule_labels: LabelArray,
                         res_map: L4PolicyMap) -> int:
        if not rule.to_ports:
            ctx.policy_trace("    No L4 Egress rules\n")
            return 0
        to_endpoints = rule.get_destination_endpoint_selectors()
        if ctx.to_labels and len(to_endpoints) > 0:
            if not to_endpoints.matches(ctx.to_labels):
                ctx.policy_trace("    Labels %r not found", ctx.to_labels)
                return 0
        ctx.policy_trace("    Found all required labels")
        found = 0
        for pr in rule.to_ports:
            ctx.policy_trace("    Allows Egress port %r to endpoints %r\n",
                             pr.ports, to_endpoints)
            for p in pr.ports:
                protos = ([p.protocol] if p.protocol != api.PROTO_ANY
                          else [api.PROTO_TCP, api.PROTO_UDP])
                for proto in protos:
                    found += merge_l4_egress_port(
                        ctx, to_endpoints, pr, p, proto, rule_labels, res_map)
        return found

    def _wildcard_l3_l4_rules(self, ctx: SearchContext, ingress: bool,
                              l4_policy: L4PolicyMap) -> None:
        """Duplicate L3-only allows into L7 wildcards of overlapping
        L7 filters. Reference: repository.go:170 wildcardL3L4Rules."""
        for r in self._rules:
            if ingress:
                if not r.endpoint_selector.matches(ctx.to_labels):
                    continue
                for ing in r.ingress:
                    if ing.from_requires or ing.from_cidr or ing.from_cidr_set:
                        continue  # non-label-based (IsLabelBased, ingress.go:120)
                    endpoints = ing.get_source_endpoint_selectors()
                    if not ing.to_ports:
                        _wildcard_l3_l4_rule(api.PROTO_TCP, 0, endpoints,
                                             r.labels, l4_policy)
                        _wildcard_l3_l4_rule(api.PROTO_UDP, 0, endpoints,
                                             r.labels, l4_policy)
                    else:
                        for pr in ing.to_ports:
                            if pr.rules is None or pr.rules.is_empty():
                                for p in pr.ports:
                                    for proto in _expand_proto(p.protocol):
                                        _wildcard_l3_l4_rule(
                                            proto, int(p.port), endpoints,
                                            r.labels, l4_policy)
            else:
                if not r.endpoint_selector.matches(ctx.from_labels):
                    continue
                for eg in r.egress:
                    if eg.to_requires or eg.to_cidr or eg.to_cidr_set \
                            or eg.to_services:
                        continue  # egress.go:148 IsLabelBased
                    endpoints = eg.get_destination_endpoint_selectors()
                    if not eg.to_ports:
                        _wildcard_l3_l4_rule(api.PROTO_TCP, 0, endpoints,
                                             r.labels, l4_policy)
                        _wildcard_l3_l4_rule(api.PROTO_UDP, 0, endpoints,
                                             r.labels, l4_policy)
                    else:
                        for pr in eg.to_ports:
                            if pr.rules is None or pr.rules.is_empty():
                                for p in pr.ports:
                                    for proto in _expand_proto(p.protocol):
                                        _wildcard_l3_l4_rule(
                                            proto, int(p.port), endpoints,
                                            r.labels, l4_policy)

    def resolve_l4_policy(self, ctx: SearchContext) -> L4Policy:
        with self.mutex:
            return self._resolve_l4_policy_locked(ctx)

    def _resolve_l4_policy_locked(self, ctx: SearchContext) -> L4Policy:
        pol = L4Policy(revision=self._revision)
        pol.ingress = self.resolve_l4_ingress_policy(ctx)
        pol.egress = self.resolve_l4_egress_policy(ctx)
        return pol

    # -- CIDR policy resolution --------------------------------------------

    def resolve_cidr_policy(self, ctx: SearchContext) -> CIDRPolicy:
        """Reference: repository.go:340 ResolveCIDRPolicy."""
        with self.mutex:
            return self._resolve_cidr_policy_locked(ctx)

    def _resolve_cidr_policy_locked(self, ctx: SearchContext) -> CIDRPolicy:
        result = CIDRPolicy()
        ctx.policy_trace("Resolving L3 (CIDR) policy for %r\n", ctx.to_labels)
        state = _TraceState()
        for r in self._rules:
            self._resolve_cidr_rule(r, ctx, state, result)
            state.rule_id += 1
        state.trace(self, ctx)
        return result

    def _resolve_cidr_rule(self, r: Rule, ctx: SearchContext,
                           state: _TraceState, result: CIDRPolicy) -> None:
        """Reference: rule.go:296 resolveCIDRPolicy: ingress counts L3-only
        CIDRs (CIDR+L4 handled by L4 resolution); egress counts CIDR+L4 too
        (for ipcache prefix-length computation)."""
        if not r.endpoint_selector.matches(ctx.to_labels):
            state.unselect_rule(ctx, ctx.to_labels, r)
            return
        state.select_rule(ctx, r)
        for ing in r.ingress:
            all_cidrs = list(ing.from_cidr)
            all_cidrs.extend(api.compute_resultant_cidr_set(ing.from_cidr_set))
            if all_cidrs and ing.to_ports:
                continue
            merge_cidr(ctx, "Ingress", all_cidrs, r.labels, result.ingress)
        for eg in r.egress:
            all_cidrs = list(eg.to_cidr)
            all_cidrs.extend(api.compute_resultant_cidr_set(eg.to_cidr_set))
            merge_cidr(ctx, "Egress", all_cidrs, r.labels, result.egress)


def _wildcard_l3_l4_rule(proto: str, port: int,
                         endpoints: EndpointSelectorSlice,
                         rule_labels: LabelArray,
                         l4_policy: L4PolicyMap) -> None:
    """Reference: repository.go:128 wildcardL3L4Rule — for each existing
    L7 filter covering (proto, port), wildcard L7 for L3/L4-allowed peers
    and add those peers to the filter's endpoint list."""
    from .l4 import PARSER_TYPE_HTTP, PARSER_TYPE_KAFKA, PARSER_TYPE_NONE
    for key, flt in l4_policy.items():
        if proto != flt.protocol or (port != 0 and port != flt.port):
            continue
        if flt.l7_parser == PARSER_TYPE_NONE:
            continue
        if flt.l7_parser == PARSER_TYPE_HTTP:
            for sel in endpoints:
                flt.l7_rules_per_ep[sel] = api.L7Rules(
                    http=[api.PortRuleHTTP()])
        elif flt.l7_parser == PARSER_TYPE_KAFKA:
            for sel in endpoints:
                flt.l7_rules_per_ep[sel] = api.L7Rules(
                    kafka=[api.PortRuleKafka()])
        else:
            for sel in endpoints:
                flt.l7_rules_per_ep[sel] = api.L7Rules(
                    l7proto=flt.l7_parser)
        flt.endpoints.extend(endpoints)
        flt.derived_from_rules.append(rule_labels)


def _rule_to_model(r: Rule) -> Dict:
    """JSON-able rule representation (API surface parity with GetJSON)."""
    def selector_model(s: EndpointSelector) -> Dict:
        return s.to_model()

    def port_rule_model(pr) -> Dict:
        d: Dict = {"ports": [{"port": p.port, "protocol": p.protocol}
                             for p in pr.ports]}
        if pr.rules is not None:
            rd: Dict = {}
            if pr.rules.http:
                rd["http"] = [{"path": h.path, "method": h.method,
                               "host": h.host, "headers": list(h.headers)}
                              for h in pr.rules.http]
            if pr.rules.kafka:
                rd["kafka"] = [{"role": k.role, "apiKey": k.api_key,
                                "apiVersion": k.api_version,
                                "clientID": k.client_id, "topic": k.topic}
                               for k in pr.rules.kafka]
            if pr.rules.l7proto:
                rd["l7proto"] = pr.rules.l7proto
                rd["l7"] = [l.as_dict() for l in pr.rules.l7]
            d["rules"] = rd
        return d

    model: Dict = {
        "endpointSelector": selector_model(r.endpoint_selector),
        "labels": r.labels.get_model(),
    }
    if r.description:
        model["description"] = r.description
    if r.ingress:
        model["ingress"] = []
        for ing in r.ingress:
            d: Dict = {}
            if ing.from_endpoints:
                d["fromEndpoints"] = [selector_model(s)
                                      for s in ing.from_endpoints]
            if ing.from_requires:
                d["fromRequires"] = [selector_model(s)
                                     for s in ing.from_requires]
            if ing.to_ports:
                d["toPorts"] = [port_rule_model(pr) for pr in ing.to_ports]
            if ing.from_cidr:
                d["fromCIDR"] = list(ing.from_cidr)
            if ing.from_cidr_set:
                d["fromCIDRSet"] = [{"cidr": c.cidr,
                                     "except": list(c.except_cidrs)}
                                    for c in ing.from_cidr_set]
            if ing.from_entities:
                d["fromEntities"] = list(ing.from_entities)
            model["ingress"].append(d)
    if r.egress:
        model["egress"] = []
        for eg in r.egress:
            d = {}
            if eg.to_endpoints:
                d["toEndpoints"] = [selector_model(s) for s in eg.to_endpoints]
            if eg.to_requires:
                d["toRequires"] = [selector_model(s) for s in eg.to_requires]
            if eg.to_ports:
                d["toPorts"] = [port_rule_model(pr) for pr in eg.to_ports]
            if eg.to_cidr:
                d["toCIDR"] = list(eg.to_cidr)
            if eg.to_cidr_set:
                d["toCIDRSet"] = [{"cidr": c.cidr,
                                   "except": list(c.except_cidrs)}
                                  for c in eg.to_cidr_set]
            if eg.to_entities:
                d["toEntities"] = list(eg.to_entities)
            if eg.to_fqdns:
                d["toFQDNs"] = [{"matchName": f.match_name,
                                 "matchPattern": f.match_pattern}
                                for f in eg.to_fqdns]
            model["egress"].append(d)
    return model
