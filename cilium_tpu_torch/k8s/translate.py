"""ToServices -> ToCIDRSet translation from Endpoints objects.

Reference: pkg/k8s/rule_translate.go — an egress rule naming a k8s
service resolves to the service's backend IPs as generated CIDR rules;
Endpoints add/delete events re-translate affected rules
(Repository.TranslateRules, repository.go:674).

A whole copy of ``cilium_tpu/k8s/translate.py``.
"""

from __future__ import annotations

import ipaddress
from typing import Dict, Iterable, List, Optional, Sequence

from ..policy.api import CIDRRule, Rule


def _parse_ips(ips) -> List:
    out = []
    for ip in ips:
        try:
            out.append(ipaddress.ip_address(ip))
        except ValueError:
            continue
    return out


def _covers_any(cidr: str, parsed_ips) -> bool:
    try:
        net = ipaddress.ip_network(cidr, strict=False)
    except ValueError:
        return False
    return any(ip in net for ip in parsed_ips)


def endpoints_to_ips(endpoints_obj: Dict) -> List[str]:
    """k8s Endpoints object -> backend IPs (subsets[].addresses[].ip)."""
    ips = []
    for subset in endpoints_obj.get("subsets") or []:
        for addr in subset.get("addresses") or []:
            ip = addr.get("ip")
            if ip:
                ips.append(ip)
    return ips


def translate_to_services(rules: Sequence[Rule], service_name: str,
                          namespace: str,
                          backend_ips: Iterable[str],
                          old_backend_ips: Optional[Iterable[str]] = None
                          ) -> int:
    """Rewrite every egress ToServices reference to (service, ns) into
    generated ToCIDRSet entries. Returns rules touched.

    Reference: rule_translate.go RuleTranslator.Translate — only
    generated entries *belonging to this service* are replaced
    (deleteToCidrFromEndpoint removes generated CIDRs containing the
    service's endpoint IPs).  A rule can carry ToServices for several
    services; wiping every generated entry on one service's Endpoints
    event would transiently deny the other services' traffic.
    """
    backend_ips = list(backend_ips)
    # entries to drop: this service's previous backends plus its new
    # ones (replace-in-place when an IP is unchanged); parsed once so
    # the per-entry containment check is O(entries x ips) comparisons,
    # not string parses
    remove_ips = _parse_ips(set(old_backend_ips or []) | set(backend_ips))
    touched = 0
    for rule in rules:
        changed = False
        for eg in rule.egress:
            hit = any(
                s.k8s_service is not None and
                s.k8s_service.service_name == service_name and
                (s.k8s_service.namespace or "default") == namespace
                for s in eg.to_services)
            if not hit:
                continue
            keep = [c for c in eg.to_cidr_set
                    if not (c.generated and _covers_any(c.cidr,
                                                        remove_ips))]
            gen = [CIDRRule(cidr=f"{ip}/32" if ":" not in ip
                            else f"{ip}/128", generated=True)
                   for ip in backend_ips]
            eg.to_cidr_set = keep + gen
            changed = True
        if changed:
            touched += 1
    return touched
