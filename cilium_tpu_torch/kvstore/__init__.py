"""Distributed control-plane key-value store.

Copy of ``cilium_tpu/kvstore/``: a backend interface (reference:
pkg/kvstore/backend.go:86-146) carrying the three replicated stores
(identities, ip->identity, nodes), with:

- an in-process backend for tests/single-node operation (reference:
  pkg/kvstore/dummy.go);
- a TCP server + client pair (server.py / remote.py) with etcd-shaped
  semantics — leases, CreateOnly/CreateIfExists, prefix watches,
  distributed locks — so separate agent processes share one store over
  a real socket (reference: pkg/kvstore/etcd.go);
- the etcd v3 JSON-gateway client and an in-repo server for it
  (etcd.py / mini_etcd.py);
- the outage guard with its write journal (outage.py / journal.py);
- the distributed ID-allocation protocol (reference:
  pkg/kvstore/allocator/).

The wire formats are the reference's, so a port agent and a JAX agent
share one store.  Run a standalone store:
``python -m cilium_tpu_torch.kvstore.serve [port]``.
"""

from .backend import (EVENT_CREATE, EVENT_DELETE, EVENT_LIST_DONE,
                      EVENT_MODIFY, BackendOperations, Event, KVLockError,
                      close_client, get_client, register_backend,
                      setup_client, setup_dummy)
from .etcd import EtcdBackend
from .journal import WriteJournal
from .memory import InMemoryBackend
from .mini_etcd import MiniEtcd
from .outage import KVStoreDegradedError, OutageGuard
from .remote import RemoteBackend
from .server import KVStoreServer

__all__ = [
    "BackendOperations", "EtcdBackend", "Event", "InMemoryBackend",
    "KVLockError", "KVStoreDegradedError", "KVStoreServer", "MiniEtcd",
    "OutageGuard", "RemoteBackend", "WriteJournal",
    "EVENT_CREATE", "EVENT_MODIFY", "EVENT_DELETE", "EVENT_LIST_DONE",
    "setup_client", "setup_dummy", "get_client", "close_client",
    "register_backend",
]
