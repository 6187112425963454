"""Desired policy-map state: the per-endpoint key/value verdict set.

Copy of the ABI part of ``cilium_tpu/policy/mapstate.py`` (reference:
pkg/maps/policymap/policymap.go:64-80, bpf/lib/common.h:180-193).  Rule
resolution into these states is not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# Traffic direction (reference: pkg/maps/policymap — Ingress/Egress).
INGRESS = 0
EGRESS = 1


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
