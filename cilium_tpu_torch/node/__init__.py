"""Node discovery and inter-node datapath programming.

Analog of the reference's ``pkg/node``: each agent registers its Node in
the kvstore shared store (``cilium/state/nodes/v1``), watches peers, and
programs per-remote-node forwarding state (the tunnel-endpoint table the
datapath's encap step consumes — pkg/maps/tunnel analog).

A whole copy of ``cilium_tpu/node/__init__.py``.
"""

from .node import Node, NodeAddress
from .manager import NodeManager
from .registry import NODES_PATH, NodeRegistry

__all__ = ["Node", "NodeAddress", "NodeManager", "NodeRegistry",
           "NODES_PATH"]
