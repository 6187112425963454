"""The control-plane key-value store: the backend interface and the
shared store over it (copies of ``cilium_tpu/kvstore/backend.py`` and
``store.py``).  The backends themselves (in-memory, etcd, the TCP
server and client, the outage guard, the distributed identity
allocator) come in a later slice; until then the agent runs with no
backend, as ``--kvstore none`` does in the reference.
"""

from .backend import (EVENT_CREATE, EVENT_DELETE, EVENT_LIST_DONE,
                      EVENT_MODIFY, BackendOperations, Event, KVLockError)
from .store import SharedStore

__all__ = [
    "BackendOperations", "Event", "KVLockError", "SharedStore",
    "EVENT_CREATE", "EVENT_MODIFY", "EVENT_DELETE", "EVENT_LIST_DONE",
]
