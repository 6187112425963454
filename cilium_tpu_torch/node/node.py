"""The Node model.

Reference: pkg/node/node.go — Node{Name, Cluster, IPAddresses,
IPv4AllocCIDR, IPv6AllocCIDR, ClusterID} plus helpers; serialized into
the kvstore store (pkg/node/store.go).

A whole copy of ``cilium_tpu/node/node.py``.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ADDR_INTERNAL_IP = "InternalIP"
ADDR_EXTERNAL_IP = "ExternalIP"
ADDR_CILIUM_INTERNAL_IP = "CiliumInternalIP"


@dataclass(frozen=True)
class NodeAddress:
    type: str
    ip: str


@dataclass
class Node:
    """One cluster node and its pod-CIDR allocation."""

    name: str
    cluster: str = "default"
    cluster_id: int = 0
    addresses: List[NodeAddress] = field(default_factory=list)
    ipv4_alloc_cidr: Optional[str] = None  # pod CIDR served by this node
    ipv6_alloc_cidr: Optional[str] = None
    # observer endpoint this node's Hubble serves /flows on (base URL);
    # peers' relays federate through it (hubble-relay peer service)
    hubble_address: Optional[str] = None

    @property
    def full_name(self) -> str:
        return f"{self.cluster}/{self.name}"

    def get_node_ip(self, ipv6: bool = False) -> Optional[str]:
        """Preferred reachable address (reference: node.GetNodeIP —
        internal beats external)."""
        want_version = 6 if ipv6 else 4
        best = None
        for pref in (ADDR_CILIUM_INTERNAL_IP, ADDR_INTERNAL_IP,
                     ADDR_EXTERNAL_IP):
            for a in self.addresses:
                try:
                    if ipaddress.ip_address(a.ip).version != want_version:
                        continue
                except ValueError:
                    continue
                if a.type == pref:
                    return a.ip
                best = best or a.ip
        return best

    def to_model(self) -> Dict:
        out = {
            "Name": self.name,
            "Cluster": self.cluster,
            "ClusterID": self.cluster_id,
            "IPAddresses": [{"Type": a.type, "IP": a.ip}
                            for a in self.addresses],
            "IPv4AllocCIDR": self.ipv4_alloc_cidr,
            "IPv6AllocCIDR": self.ipv6_alloc_cidr,
        }
        if self.hubble_address:
            out["HubbleAddress"] = self.hubble_address
        return out

    @classmethod
    def from_model(cls, d: Dict) -> "Node":
        return cls(name=d["Name"], cluster=d.get("Cluster", "default"),
                   cluster_id=int(d.get("ClusterID", 0)),
                   addresses=[NodeAddress(type=a["Type"], ip=a["IP"])
                              for a in d.get("IPAddresses", [])],
                   ipv4_alloc_cidr=d.get("IPv4AllocCIDR"),
                   ipv6_alloc_cidr=d.get("IPv6AllocCIDR"),
                   hubble_address=d.get("HubbleAddress"))
