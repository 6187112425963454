"""Per-remote-node datapath programming.

Reference: pkg/node/manager.go:94-195 — for every peer node the agent
programs (a) the tunnel map entry pod-CIDR -> node IP (tunnel mode;
pkg/maps/tunnel) or a direct route, and (b) an ipcache entry marking the
node's pod CIDR as remote. Here the "tunnel map" is a host dict the
encap stage consumes, and the pod-CIDR ipcache upserts flow through the
normal listener into the device LPM.

A whole copy of ``cilium_tpu/node/manager.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..identity import RESERVED_WORLD
from ..ipcache.ipcache import SOURCE_KVSTORE, IPCache
from .node import Node

ROUTE_TUNNEL = "tunnel"
ROUTE_DIRECT = "direct"


class NodeManager:
    """Realize node add/update/delete into forwarding state."""

    def __init__(self, local_node: str, ipcache: Optional[IPCache] = None,
                 mode: str = ROUTE_TUNNEL, datapath=None):
        self.local_node = local_node
        self.mode = mode
        self.ipcache = ipcache
        # datapath.load_tunnel realizes tunnel_map changes as the
        # device-resident tunnel LPM the encap stage consumes
        # (pkg/maps/tunnel SetTunnelEndpoint -> cilium_tunnel_map)
        self.datapath = datapath
        self._mu = threading.Lock()
        self._nodes: Dict[str, Node] = {}
        # pod CIDR prefix -> tunnel endpoint IP (pkg/maps/tunnel analog)
        self.tunnel_map: Dict[str, str] = {}
        # direct routes: pod CIDR -> nexthop node IP
        self.routes: Dict[str, str] = {}

    def _program_tunnel(self) -> None:
        """Push the current tunnel map into the datapath (device LPM:
        pod CIDR -> tunnel endpoint node IP as u32).  Snapshot and
        apply under one lock hold: concurrent node events (registry
        watch thread + clustermesh) applying snapshots out of order
        would leave stale tunnel state programmed."""
        if self.datapath is None:
            return
        from ..compiler.lpm import ipv4_to_u32
        with self._mu:
            prefixes = {cidr: int(ipv4_to_u32(ip))
                        for cidr, ip in self.tunnel_map.items()}
            self.datapath.load_tunnel(prefixes)

    def node_updated(self, node: Node) -> None:
        """Reference: manager.go NodeUpdated — program or refresh the
        per-node state (idempotent)."""
        if node.full_name == self.local_node:
            return
        node_ip = node.get_node_ip()
        with self._mu:
            old = self._nodes.get(node.full_name)
            if old is not None and old.ipv4_alloc_cidr and \
                    old.ipv4_alloc_cidr != node.ipv4_alloc_cidr:
                self._remove_cidr_locked(old.ipv4_alloc_cidr)
            self._nodes[node.full_name] = node
            if node.ipv4_alloc_cidr and node_ip:
                if self.mode == ROUTE_TUNNEL:
                    self.tunnel_map[node.ipv4_alloc_cidr] = node_ip
                else:
                    self.routes[node.ipv4_alloc_cidr] = node_ip
        if self.ipcache is not None and node.ipv4_alloc_cidr and node_ip:
            # remote pod CIDR resolves to world until a more specific
            # endpoint entry arrives via the ip-identity watch
            self.ipcache.upsert(node.ipv4_alloc_cidr, RESERVED_WORLD,
                                SOURCE_KVSTORE, host_ip=node_ip,
                                metadata=f"node:{node.full_name}")
        self._program_tunnel()

    def node_deleted(self, full_name: str) -> None:
        """Reference: manager.go NodeDeleted — tear down routes/tunnel."""
        with self._mu:
            node = self._nodes.pop(full_name, None)
            if node is None:
                return
            if node.ipv4_alloc_cidr:
                self._remove_cidr_locked(node.ipv4_alloc_cidr)
        if self.ipcache is not None and node.ipv4_alloc_cidr:
            self.ipcache.delete(node.ipv4_alloc_cidr, SOURCE_KVSTORE)
        self._program_tunnel()

    def _remove_cidr_locked(self, cidr: str) -> None:
        self.tunnel_map.pop(cidr, None)
        self.routes.pop(cidr, None)

    def nodes(self) -> list:
        """Known peer nodes (manager view, for `cilium node list` when
        no kvstore registry is attached)."""
        with self._mu:
            return sorted(self._nodes.values(),
                          key=lambda n: n.full_name)

    def tunnel_endpoint_for(self, pod_cidr: str) -> Optional[str]:
        with self._mu:
            return self.tunnel_map.get(pod_cidr)

    def __len__(self):
        with self._mu:
            return len(self._nodes)
