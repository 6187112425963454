"""Resolved CIDR (L3) policy with per-prefix-length accounting.

A whole copy of ``cilium_tpu/policy/l3.py``.

Reference: pkg/policy/l3.go — CIDRPolicyMap keyed ``"addr/prefixlen"`` with
reference counts per prefix length (needed for LPM structures bounded to
``MaxCIDRPrefixLengths`` distinct lengths), and ``ToBPFData`` emitting the
sorted prefix-length list that drives the masked-lookup LPM iteration.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from ..labels import LabelArray
from .api import MAX_CIDR_PREFIX_LENGTHS, PolicyError
from .trace import SearchContext


@dataclass
class CIDRPolicyMapRule:
    """One CIDR entry + the rule labels it derives from (l3.go:28)."""

    prefix: str  # canonical "addr/plen"
    derived_from_rules: List[LabelArray] = field(default_factory=list)


class CIDRPolicyMap:
    """Map of allowed prefixes with per-prefix-length refcounts (l3.go:40)."""

    def __init__(self):
        self.map: Dict[str, CIDRPolicyMapRule] = {}
        self.ipv4_prefixes: Dict[int, int] = {}  # plen -> count
        self.ipv6_prefixes: Dict[int, int] = {}

    def insert(self, cidr: str, rule_labels: LabelArray) -> int:
        """Insert a CIDR; returns 1 if newly inserted, 0 if present.

        Reference: l3.go:60 (Insert).
        """
        net = ipaddress.ip_network(cidr, strict=False)
        key = str(net)
        if key in self.map:
            self.map[key].derived_from_rules.append(rule_labels)
            return 0
        self.map[key] = CIDRPolicyMapRule(prefix=key,
                                          derived_from_rules=[rule_labels])
        prefixes = self.ipv4_prefixes if net.version == 4 else self.ipv6_prefixes
        prefixes[net.prefixlen] = prefixes.get(net.prefixlen, 0) + 1
        return 1

    def delete(self, cidr: str) -> bool:
        net = ipaddress.ip_network(cidr, strict=False)
        key = str(net)
        if key not in self.map:
            return False
        del self.map[key]
        prefixes = self.ipv4_prefixes if net.version == 4 else self.ipv6_prefixes
        prefixes[net.prefixlen] -= 1
        if prefixes[net.prefixlen] == 0:
            del prefixes[net.prefixlen]
        return True

    def covers(self, ip_str: str) -> bool:
        """Longest-prefix semantics: is the IP inside any allowed prefix?"""
        addr = ipaddress.ip_address(ip_str)
        for key in self.map:
            if addr in ipaddress.ip_network(key):
                return True
        return False

    def __len__(self):
        return len(self.map)


def default_prefix_lengths() -> Tuple[List[int], List[int]]:
    """Prefix lengths always present: host routes and the default route.

    Reference: l3.go:50 GetDefaultPrefixLengths — {0, 32} v4 / {0, 128} v6.
    """
    return [0, 32], [0, 128]


@dataclass
class CIDRPolicy:
    """Resolved ingress/egress CIDR policy (reference: l3.go NewCIDRPolicy)."""

    ingress: CIDRPolicyMap = field(default_factory=CIDRPolicyMap)
    egress: CIDRPolicyMap = field(default_factory=CIDRPolicyMap)

    def to_bpf_data(self) -> Tuple[List[int], List[int]]:
        """(sorted v4 prefix lengths desc, sorted v6 desc) across directions.

        Reference: l3.go:146 ToBPFData — the sorted-prefix-length list is
        exactly the iteration order of the TPU LPM masked-lookup kernel.
        """
        d4, d6 = default_prefix_lengths()
        s4, s6 = set(d4), set(d6)
        for m in (self.ingress, self.egress):
            s4.update(m.ipv4_prefixes.keys())
            s6.update(m.ipv6_prefixes.keys())
        return sorted(s4, reverse=True), sorted(s6, reverse=True)

    def validate(self) -> None:
        """Bound distinct prefix lengths (reference: l3.go:200 Validate)."""
        s4, s6 = self.to_bpf_data()
        for s, proto in ((s4, "IPv4"), (s6, "IPv6")):
            if len(s) > MAX_CIDR_PREFIX_LENGTHS:
                raise PolicyError(
                    f"too many {proto} prefix lengths "
                    f"{len(s)}/{MAX_CIDR_PREFIX_LENGTHS}")


def merge_cidr(ctx: SearchContext, direction: str, cidrs: Sequence[str],
               rule_labels: LabelArray, cidr_map: CIDRPolicyMap) -> int:
    """Insert each CIDR into the map (reference: rule.go mergeCIDR)."""
    found = 0
    for c in cidrs:
        ctx.policy_trace("  Allows %s IP %s\n", direction, c)
        found += cidr_map.insert(c, rule_labels)
    return found
