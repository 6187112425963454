"""JSON (de)serialization of policy rules.

A whole copy of ``cilium_tpu/policy/jsonio.py``.

Mirrors the reference's JSON rule format (pkg/policy/api JSON tags:
``endpointSelector{matchLabels,matchExpressions}``, ``ingress``/
``egress`` with ``fromEndpoints``/``toPorts``/``fromCIDR``/
``fromCIDRSet``/``fromEntities``/``fromRequires``/``toFQDNs``…), the
wire format of ``cilium policy import`` and GET/PUT ``/policy``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Union

from ..labels import LabelArray, parse_label
from .api import (CIDRRule, EgressRule, EndpointSelector, FQDNSelector,
                  IngressRule, K8sServiceNamespace, L7Rules, Operator,
                  PortProtocol, PortRule, PortRuleHTTP, PortRuleKafka,
                  PortRuleL7, PolicyError, Requirement, Rule, Service)

# ---------------------------------------------------------------- selectors


def selector_to_dict(sel: EndpointSelector) -> Dict:
    out: Dict = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    exprs = [r for r in sel.requirements
             if r.key not in sel.match_labels or
             r.operator != Operator.IN]
    if exprs:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator.value,
             "values": list(r.values)} for r in exprs]
    return out


def selector_from_dict(d: Dict) -> EndpointSelector:
    exprs = [Requirement(key=e["key"],
                         operator=Operator(e["operator"]),
                         values=tuple(e.get("values") or ()))
             for e in d.get("matchExpressions", [])]
    return EndpointSelector(match_labels=d.get("matchLabels"),
                            match_expressions=exprs)


# ---------------------------------------------------------------- L4 / L7

def _port_rule_to_dict(pr: PortRule) -> Dict:
    out: Dict = {"ports": [{"port": p.port, "protocol": p.protocol}
                           for p in pr.ports]}
    if pr.rules is not None and not pr.rules.is_empty():
        rules: Dict = {}
        if pr.rules.http:
            rules["http"] = [
                {k: v for k, v in (("path", h.path), ("method", h.method),
                                   ("host", h.host)) if v} |
                ({"headers": list(h.headers)} if h.headers else {})
                for h in pr.rules.http]
        if pr.rules.kafka:
            rules["kafka"] = [
                {k: v for k, v in (
                    ("role", kf.role), ("apiKey", kf.api_key),
                    ("apiVersion", kf.api_version),
                    ("clientID", kf.client_id), ("topic", kf.topic)) if v}
                for kf in pr.rules.kafka]
        if pr.rules.l7proto:
            rules["l7proto"] = pr.rules.l7proto
            rules["l7"] = [dict(r.fields) for r in pr.rules.l7]
        out["rules"] = rules
    return out


def _port_rule_from_dict(d: Dict) -> PortRule:
    ports = [PortProtocol(port=str(p.get("port", "0")),
                          protocol=p.get("protocol", "ANY"))
             for p in d.get("ports", [])]
    rules: Optional[L7Rules] = None
    rd = d.get("rules")
    if rd:
        rules = L7Rules(
            http=[PortRuleHTTP(path=h.get("path", ""),
                               method=h.get("method", ""),
                               host=h.get("host", ""),
                               headers=tuple(h.get("headers", ())))
                  for h in rd.get("http", [])],
            kafka=[PortRuleKafka(role=k.get("role", ""),
                                 api_key=k.get("apiKey", ""),
                                 api_version=str(k.get("apiVersion", "")),
                                 client_id=k.get("clientID", ""),
                                 topic=k.get("topic", ""))
                   for k in rd.get("kafka", [])],
            l7proto=rd.get("l7proto", ""),
            l7=[PortRuleL7.from_dict(r) for r in rd.get("l7", [])])
    return PortRule(ports=ports, rules=rules)


def _cidr_rule_to_dict(c: CIDRRule) -> Dict:
    out: Dict = {"cidr": c.cidr}
    if c.except_cidrs:
        out["except"] = list(c.except_cidrs)
    if c.generated:
        out["generated"] = True
    return out


def _cidr_rule_from_dict(d: Dict) -> CIDRRule:
    # The ``generated`` flag marks entries the agent derives internally
    # (ToServices/FQDN translation); accepting it from user input would
    # bypass the L3 member-exclusivity check, so parsing always clears
    # it — derived entries are recreated by the translators on import.
    return CIDRRule(cidr=d["cidr"],
                    except_cidrs=tuple(d.get("except", ())),
                    generated=False)


# ------------------------------------------------------------------- rules

def rule_to_dict(rule: Rule) -> Dict:
    out: Dict = {
        "endpointSelector": selector_to_dict(rule.endpoint_selector)}
    if rule.ingress:
        out["ingress"] = []
        for ing in rule.ingress:
            d: Dict = {}
            if ing.from_endpoints:
                d["fromEndpoints"] = [selector_to_dict(s)
                                      for s in ing.from_endpoints]
            if ing.from_requires:
                d["fromRequires"] = [selector_to_dict(s)
                                     for s in ing.from_requires]
            if ing.to_ports:
                d["toPorts"] = [_port_rule_to_dict(p)
                                for p in ing.to_ports]
            if ing.from_cidr:
                d["fromCIDR"] = list(ing.from_cidr)
            if ing.from_cidr_set:
                d["fromCIDRSet"] = [_cidr_rule_to_dict(c)
                                    for c in ing.from_cidr_set]
            if ing.from_entities:
                d["fromEntities"] = list(ing.from_entities)
            out["ingress"].append(d)
    if rule.egress:
        out["egress"] = []
        for eg in rule.egress:
            d = {}
            if eg.to_endpoints:
                d["toEndpoints"] = [selector_to_dict(s)
                                    for s in eg.to_endpoints]
            if eg.to_requires:
                d["toRequires"] = [selector_to_dict(s)
                                   for s in eg.to_requires]
            if eg.to_ports:
                d["toPorts"] = [_port_rule_to_dict(p) for p in eg.to_ports]
            if eg.to_cidr:
                d["toCIDR"] = list(eg.to_cidr)
            if eg.to_cidr_set:
                d["toCIDRSet"] = [_cidr_rule_to_dict(c)
                                  for c in eg.to_cidr_set]
            if eg.to_entities:
                d["toEntities"] = list(eg.to_entities)
            if eg.to_fqdns:
                d["toFQDNs"] = [
                    ({"matchName": f.match_name} if f.match_name else
                     {"matchPattern": f.match_pattern})
                    for f in eg.to_fqdns]
            if eg.to_services:
                d["toServices"] = [
                    {"k8sService": {
                        "serviceName": s.k8s_service.service_name,
                        "namespace": s.k8s_service.namespace}}
                    for s in eg.to_services if s.k8s_service]
            out["egress"].append(d)
    if rule.labels:
        out["labels"] = [str(l) for l in rule.labels]
    if rule.description:
        out["description"] = rule.description
    return out


def rule_from_dict(d: Dict) -> Rule:
    if "endpointSelector" not in d:
        raise PolicyError("rule missing endpointSelector")
    ingress = []
    for ing in d.get("ingress") or []:
        ingress.append(IngressRule(
            from_endpoints=[selector_from_dict(s)
                            for s in ing.get("fromEndpoints", [])],
            from_requires=[selector_from_dict(s)
                           for s in ing.get("fromRequires", [])],
            to_ports=[_port_rule_from_dict(p)
                      for p in ing.get("toPorts", [])],
            from_cidr=list(ing.get("fromCIDR", [])),
            from_cidr_set=[_cidr_rule_from_dict(c)
                           for c in ing.get("fromCIDRSet", [])],
            from_entities=list(ing.get("fromEntities", []))))
    egress = []
    for eg in d.get("egress") or []:
        egress.append(EgressRule(
            to_endpoints=[selector_from_dict(s)
                          for s in eg.get("toEndpoints", [])],
            to_requires=[selector_from_dict(s)
                         for s in eg.get("toRequires", [])],
            to_ports=[_port_rule_from_dict(p)
                      for p in eg.get("toPorts", [])],
            to_cidr=list(eg.get("toCIDR", [])),
            to_cidr_set=[_cidr_rule_from_dict(c)
                         for c in eg.get("toCIDRSet", [])],
            to_entities=list(eg.get("toEntities", [])),
            to_services=[Service(k8s_service=K8sServiceNamespace(
                service_name=s.get("k8sService", {}).get("serviceName", ""),
                namespace=s.get("k8sService", {}).get("namespace", "")))
                for s in eg.get("toServices", [])],
            to_fqdns=[FQDNSelector(match_name=f.get("matchName", ""),
                                   match_pattern=f.get("matchPattern", ""))
                      for f in eg.get("toFQDNs", [])]))
    labels = LabelArray(parse_label(s) for s in d.get("labels", []))
    return Rule(endpoint_selector=selector_from_dict(d["endpointSelector"]),
                ingress=ingress, egress=egress, labels=labels,
                description=d.get("description", ""))


def rules_to_json(rules: Sequence[Rule], indent: Optional[int] = 2) -> str:
    return json.dumps([rule_to_dict(r) for r in rules], indent=indent,
                      sort_keys=True)


def rules_from_json(text: Union[str, bytes]) -> List[Rule]:
    """Accepts a single rule object or a list (cilium policy import)."""
    data = json.loads(text)
    if isinstance(data, dict):
        data = [data]
    if not isinstance(data, list):
        raise PolicyError("policy JSON must be a rule or list of rules")
    return [rule_from_dict(d) for d in data]
