"""Node registry over the kvstore shared store.

Reference: pkg/node/store.go — nodes register at
``cilium/state/nodes/v1/<cluster>/<name>`` (lease-backed) and watch the
prefix for peers joining/leaving.

A whole copy of ``cilium_tpu/node/registry.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..kvstore.backend import BackendOperations
from ..kvstore.store import SharedStore
from .node import Node

NODES_PATH = "cilium/state/nodes/v1"


class NodeRegistry:
    """Publish the local node + track the cluster's node set."""

    def __init__(self, backend: BackendOperations,
                 on_node_update: Optional[Callable[[Node], None]] = None,
                 on_node_delete: Optional[Callable[[str], None]] = None):
        self._on_update = on_node_update
        self._on_delete = on_node_delete
        self._mu = threading.Lock()
        self._nodes: Dict[str, Node] = {}
        self._store = SharedStore(backend, NODES_PATH,
                                  on_update=self._store_update,
                                  on_delete=self._store_delete)

    def _store_update(self, name: str, value: dict) -> None:
        try:
            node = Node.from_model(value)
        except (KeyError, ValueError):
            return
        with self._mu:
            self._nodes[node.full_name] = node
        if self._on_update:
            self._on_update(node)

    def _store_delete(self, name: str) -> None:
        with self._mu:
            self._nodes.pop(name, None)
        if self._on_delete:
            self._on_delete(name)

    def register_local(self, node: Node) -> None:
        """Publish (lease-backed: the entry dies with this agent's
        session — the failure-detection path)."""
        self._store.update_local(node.full_name, node.to_model())

    def unregister_local(self, node: Node) -> None:
        self._store.delete_local(node.full_name)

    def wait_synced(self, timeout: float = 5.0) -> bool:
        return self._store.wait_synced(timeout)

    def nodes(self) -> List[Node]:
        with self._mu:
            return sorted(self._nodes.values(), key=lambda n: n.full_name)

    def get(self, full_name: str) -> Optional[Node]:
        with self._mu:
            return self._nodes.get(full_name)

    def __len__(self):
        with self._mu:
            return len(self._nodes)

    def close(self) -> None:
        self._store.close()
