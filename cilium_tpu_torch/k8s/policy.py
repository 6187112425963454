"""k8s policy object -> api.Rule parsing.

Reference: pkg/k8s/network_policy.go — both CiliumNetworkPolicy CRDs
(whose spec *is* an api.Rule, namespace-scoped on parse) and native
k8s NetworkPolicy objects (podSelector/namespaceSelector/ipBlock
translated into selectors and CIDR sets).

A whole copy of ``cilium_tpu/k8s/policy.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..labels import SOURCE_K8S, Label, LabelArray
from ..policy.api import (CIDRRule, EgressRule, EndpointSelector,
                          IngressRule, PolicyError, PortProtocol,
                          PortRule, Rule)
from ..policy.api import Operator, Requirement
from ..policy.jsonio import rule_from_dict, selector_from_dict

# Reference: pkg/k8s/network_policy.go k8sConst — the namespace label
# every pod carries and the derived-policy bookkeeping labels.
NAMESPACE_LABEL_KEY = "io.kubernetes.pod.namespace"
POLICY_LABEL_NAME = "io.cilium.k8s.policy.name"
POLICY_LABEL_NAMESPACE = "io.cilium.k8s.policy.namespace"


def _ns_requirement(namespace: str) -> Dict[str, str]:
    return {f"k8s:{NAMESPACE_LABEL_KEY}": namespace}


def _scope_selector(sel: EndpointSelector,
                    namespace: str) -> EndpointSelector:
    """Inject the namespace match unless the selector already pins a
    namespace (network_policy.go parseToCiliumRule)."""
    key = f"k8s.{NAMESPACE_LABEL_KEY}"
    ml = dict(sel.match_labels)
    if any(k.endswith(NAMESPACE_LABEL_KEY) for k in ml):
        return sel
    ml[key] = namespace
    return EndpointSelector(match_labels=ml,
                            match_expressions=[
                                r for r in sel.requirements
                                if r.key not in sel.match_labels],
                            _raw_keys=True)


def _derived_labels(name: str, namespace: str) -> LabelArray:
    return LabelArray([
        Label(key=POLICY_LABEL_NAME, value=name, source=SOURCE_K8S),
        Label(key=POLICY_LABEL_NAMESPACE, value=namespace,
              source=SOURCE_K8S),
    ])


def _scope_rule(rule: Rule, namespace: str, name: str) -> Rule:
    rule.endpoint_selector = _scope_selector(rule.endpoint_selector,
                                             namespace)
    for ing in rule.ingress:
        ing.from_endpoints = [_scope_selector(s, namespace)
                              for s in ing.from_endpoints]
        ing.from_requires = [_scope_selector(s, namespace)
                             for s in ing.from_requires]
    for eg in rule.egress:
        eg.to_endpoints = [_scope_selector(s, namespace)
                           for s in eg.to_endpoints]
        eg.to_requires = [_scope_selector(s, namespace)
                          for s in eg.to_requires]
    rule.labels = LabelArray(tuple(rule.labels) +
                             tuple(_derived_labels(name, namespace)))
    return rule


def parse_cnp(obj: Dict) -> List[Rule]:
    """CiliumNetworkPolicy -> namespace-scoped rules.

    Accepts ``spec`` (one rule) or ``specs`` (list) —
    network_policy.go's CNP parse path."""
    meta = obj.get("metadata") or {}
    name = meta.get("name", "")
    namespace = meta.get("namespace", "default")
    if not name:
        raise PolicyError("CNP missing metadata.name")
    specs = []
    if obj.get("spec"):
        specs.append(obj["spec"])
    specs.extend(obj.get("specs") or [])
    if not specs:
        raise PolicyError(f"CNP {name}: neither spec nor specs present")
    rules = []
    for spec in specs:
        rule = rule_from_dict(spec)
        rules.append(_scope_rule(rule, namespace, name).sanitize())
    return rules


# shared with the watcher's endpoint-label side: selectors built from
# namespaceSelector use "k8s." + this base as their key prefix, and the
# watcher stamps endpoint labels with source k8s + the same base —
# they must stay in lockstep or namespaceSelector policies silently
# stop matching
NS_LABELS_BASE = "io.cilium.k8s.namespace.labels"
_NS_LABELS_PREFIX = f"k8s.{NS_LABELS_BASE}."


def _parse_np_peer(peer: Dict, namespace: str):
    """One NetworkPolicyPeer -> (selector | None, cidr_rule | None)."""
    ip_block = peer.get("ipBlock")
    if ip_block:
        return None, CIDRRule(
            cidr=ip_block["cidr"],
            except_cidrs=tuple(ip_block.get("except", ())))
    pod = peer.get("podSelector")
    ns = peer.get("namespaceSelector")
    ml: Dict[str, str] = {}
    exprs: List[Requirement] = []
    if ns is not None:
        # namespaceSelector matches namespace *labels*; the reference
        # prefixes them into the namespace-labels key space
        for k, v in (ns.get("matchLabels") or {}).items():
            ml[f"{_NS_LABELS_PREFIX}{k}"] = v
        for e in ns.get("matchExpressions") or []:
            exprs.append(Requirement(
                key=f"{_NS_LABELS_PREFIX}{e['key']}",
                operator=Operator(e["operator"]),
                values=tuple(e.get("values") or ())))
        # empty namespaceSelector == all namespaces (no constraint)
    else:
        ml[f"k8s.{NAMESPACE_LABEL_KEY}"] = namespace
    if pod is not None:
        scoped = selector_from_dict(pod)
        for k, v in scoped.match_labels.items():
            ml[k] = v
        # keep matchExpressions — dropping them would over-match
        exprs.extend(r for r in scoped.requirements
                     if r.key not in scoped.match_labels)
    sel = EndpointSelector(match_labels=ml, match_expressions=exprs,
                           _raw_keys=True)
    return sel, None


def _parse_np_ports(ports: List[Dict]) -> List[PortRule]:
    if not ports:
        return []
    pps = []
    for p in ports:
        port = p.get("port")
        if port is None:
            continue
        pps.append(PortProtocol(port=str(port),
                                protocol=p.get("protocol", "TCP")))
    return [PortRule(ports=pps)] if pps else []


def parse_network_policy(obj: Dict) -> List[Rule]:
    """Native k8s NetworkPolicy -> rules (network_policy.go
    ParseNetworkPolicy)."""
    meta = obj.get("metadata") or {}
    name = meta.get("name", "")
    namespace = meta.get("namespace", "default")
    spec = obj.get("spec") or {}
    pod_sel = selector_from_dict(spec.get("podSelector") or {})
    pod_sel = _scope_selector(pod_sel, namespace)

    ingress: List[IngressRule] = []
    for ing in spec.get("ingress") or []:
        froms = ing.get("from") or []
        selectors, cidr_rules = [], []
        for peer in froms:
            sel, cidr = _parse_np_peer(peer, namespace)
            if sel is not None:
                selectors.append(sel)
            if cidr is not None:
                cidr_rules.append(cidr)
        ports = _parse_np_ports(ing.get("ports") or [])
        # L3 member exclusivity: selectors and CIDRs become separate
        # IngressRules; CIDR peers carry no L4 restriction in this rule
        # model (rule_validation.go: FromCIDRSet + ToPorts unsupported)
        if selectors or not cidr_rules:
            ingress.append(IngressRule(from_endpoints=selectors,
                                       to_ports=list(ports)))
        if cidr_rules:
            ingress.append(IngressRule(from_cidr_set=cidr_rules))
    egress: List[EgressRule] = []
    for eg in spec.get("egress") or []:
        tos = eg.get("to") or []
        selectors, cidr_rules = [], []
        for peer in tos:
            sel, cidr = _parse_np_peer(peer, namespace)
            if sel is not None:
                selectors.append(sel)
            if cidr is not None:
                cidr_rules.append(cidr)
        ports = _parse_np_ports(eg.get("ports") or [])
        if selectors or not cidr_rules:
            egress.append(EgressRule(to_endpoints=selectors,
                                     to_ports=list(ports)))
        if cidr_rules:
            # ToCIDRSet supports L4 on egress (rule_validation.go)
            egress.append(EgressRule(to_cidr_set=cidr_rules,
                                     to_ports=list(ports)))
    rule = Rule(endpoint_selector=pod_sel, ingress=ingress, egress=egress,
                labels=_derived_labels(name, namespace))
    return [rule.sanitize()]
