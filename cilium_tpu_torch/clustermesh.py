"""Multi-cluster mesh: watch N remote kvstores, merge their state.

Reference: pkg/clustermesh — a config directory of per-cluster kvstore
configs (clustermesh.go:61); each remote cluster gets a RemoteCluster
(remote_cluster.go:102) that watches the remote's nodes, ip-identities
and identities, re-ingesting them locally with the remote's cluster ID
shifted into identity bits (pkg/identity/allocator.go:93) so verdicts
distinguish clusters. Reconnect-with-backoff is the resilience path.

A whole copy of ``cilium_tpu/clustermesh.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .identity import CLUSTER_ID_SHIFT, MINIMAL_NUMERIC_IDENTITY
from .ipcache.ipcache import SOURCE_KVSTORE, IPCache
from .ipcache.kvstore_sync import IPIdentityWatcher
from .kvstore.backend import BackendOperations
from .node.node import Node
from .node.registry import NodeRegistry
from .utils.backoff import Exponential


def scope_identity(cluster_id: int, numeric_id: int) -> int:
    """Embed the source cluster in a remote identity's high bits
    (reference: identity/allocator.go:93). Reserved IDs (<256) are
    cluster-agnostic and pass through unscoped."""
    if numeric_id < MINIMAL_NUMERIC_IDENTITY:
        return numeric_id
    return (cluster_id << CLUSTER_ID_SHIFT) | (numeric_id &
                                               ((1 << CLUSTER_ID_SHIFT) - 1))


class RemoteCluster:
    """One remote cluster's watchers (remote_cluster.go RemoteCluster)."""

    def __init__(self, name: str, cluster_id: int,
                 backend_factory: Callable[[], BackendOperations],
                 ipcache: Optional[IPCache] = None,
                 on_node_update: Optional[Callable[[Node], None]] = None,
                 on_node_delete: Optional[Callable[[str], None]] = None):
        self.name = name
        self.cluster_id = cluster_id
        self.backend_factory = backend_factory
        self.ipcache = ipcache
        self.on_node_update = on_node_update
        self.on_node_delete = on_node_delete
        self.backend: Optional[BackendOperations] = None
        self.registry: Optional[NodeRegistry] = None
        self.ip_watcher: Optional[IPIdentityWatcher] = None
        self.connected = threading.Event()
        self.failures = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"clustermesh-{name}")
        self._thread.start()

    # scoped ingestion: remote ip->identity pairs land in the local
    # ipcache with the remote cluster's ID folded into the identity
    class _ScopedCache:
        def __init__(self, outer: "RemoteCluster"):
            self.outer = outer

        def upsert(self, prefix, identity, source, host_ip=None,
                   metadata=""):
            if self.outer.ipcache is None:
                return True
            return self.outer.ipcache.upsert(
                prefix, scope_identity(self.outer.cluster_id, identity),
                SOURCE_KVSTORE, host_ip=host_ip,
                metadata=f"cluster:{self.outer.name}")

        def delete(self, prefix, source):
            if self.outer.ipcache is None:
                return False
            return self.outer.ipcache.delete(prefix, SOURCE_KVSTORE)

    def _run(self) -> None:
        """Connect loop with backoff (remote_cluster.go:102 restartRemote
        Connection)."""
        backoff = Exponential(min_s=0.05, max_s=5.0, jitter=True)
        while not self._stop.is_set():
            try:
                self.backend = self.backend_factory()
                self.registry = NodeRegistry(
                    self.backend,
                    on_node_update=self._scoped_node_update,
                    on_node_delete=self.on_node_delete)
                self.ip_watcher = IPIdentityWatcher(
                    self.backend, self._ScopedCache(self))
                self.ip_watcher.start()
                self.connected.set()
                return  # watchers run on their own threads
            except Exception:
                self.failures += 1
                self.connected.clear()
                if not backoff.wait(self._stop):
                    return

    def _scoped_node_update(self, node: Node) -> None:
        node.cluster_id = self.cluster_id
        if self.on_node_update:
            self.on_node_update(node)

    def nodes(self) -> List[Node]:
        return self.registry.nodes() if self.registry else []

    def status(self) -> Dict:
        return {"name": self.name, "cluster-id": self.cluster_id,
                "ready": self.connected.is_set(),
                "num-nodes": len(self.nodes()),
                "num-failures": self.failures}

    def close(self) -> None:
        self._stop.set()
        self.connected.clear()
        if self.ip_watcher is not None:
            self.ip_watcher.stop()
        if self.registry is not None:
            self.registry.close()
        if self.backend is not None:
            self.backend.close()
        self._thread.join(timeout=5)


class ClusterMesh:
    """The mesh: named remote clusters, added/removed at runtime
    (clustermesh.go watches a config dir; here add/remove calls)."""

    def __init__(self, ipcache: Optional[IPCache] = None,
                 on_node_update: Optional[Callable[[Node], None]] = None,
                 on_node_delete: Optional[Callable[[str], None]] = None):
        self.ipcache = ipcache
        self.on_node_update = on_node_update
        self.on_node_delete = on_node_delete
        self._mu = threading.Lock()
        self._clusters: Dict[str, RemoteCluster] = {}

    def add_cluster(self, name: str, cluster_id: int,
                    backend_factory: Callable[[], BackendOperations]
                    ) -> RemoteCluster:
        with self._mu:
            if name in self._clusters:
                return self._clusters[name]
            rc = RemoteCluster(name, cluster_id, backend_factory,
                               ipcache=self.ipcache,
                               on_node_update=self.on_node_update,
                               on_node_delete=self.on_node_delete)
            self._clusters[name] = rc
            return rc

    def remove_cluster(self, name: str) -> bool:
        with self._mu:
            rc = self._clusters.pop(name, None)
        if rc is None:
            return False
        rc.close()
        return True

    def get(self, name: str) -> Optional[RemoteCluster]:
        with self._mu:
            return self._clusters.get(name)

    def peer_nodes(self) -> List[Node]:
        """Every node known through the mesh (the relay's federation
        source alongside the local cluster's registry): remote-cluster
        nodes that advertise a Hubble address become relay peers."""
        with self._mu:
            clusters = list(self._clusters.values())
        out: List[Node] = []
        for c in clusters:
            out.extend(c.nodes())
        return out

    def status(self) -> List[Dict]:
        with self._mu:
            return [c.status() for c in self._clusters.values()]

    def num_ready(self) -> int:
        with self._mu:
            return sum(1 for c in self._clusters.values()
                       if c.connected.is_set())

    def close(self) -> None:
        with self._mu:
            clusters = list(self._clusters.values())
            self._clusters.clear()
        for c in clusters:
            c.close()
