"""Generic shared-store synchronisation over the kvstore.

Reference: pkg/kvstore/store — a JSON-marshalled set of keys under a
common prefix, where every node publishes its own keys (lease-backed) and
watches everyone else's.  Used by the node registry and reusable for any
replicated table.

A whole copy of ``cilium_tpu/kvstore/store.py``.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, Optional

from .backend import (EVENT_CREATE, EVENT_DELETE, EVENT_LIST_DONE,
                      EVENT_MODIFY, BackendOperations)


class SharedStore:
    """A replicated key->dict store under ``prefix``.

    ``update_local`` publishes (lease-backed, so a dead node's keys are
    reaped); remote changes arrive via the watch thread and are surfaced
    through ``on_update``/``on_delete`` callbacks plus a merged snapshot.
    """

    def __init__(self, backend: BackendOperations, prefix: str,
                 on_update: Optional[Callable[[str, dict], None]] = None,
                 on_delete: Optional[Callable[[str], None]] = None):
        self.backend = backend
        self.prefix = prefix.rstrip("/") + "/"
        self._mu = threading.Lock()
        self._local: Dict[str, dict] = {}
        self._remote: Dict[str, dict] = {}
        self._on_update = on_update
        self._on_delete = on_delete
        self._synced = threading.Event()
        self._watcher = backend.list_and_watch(self.prefix)
        self._thread = threading.Thread(target=self._watch_loop,
                                        daemon=True)
        self._thread.start()

    def _name(self, key: str) -> str:
        return key[len(self.prefix):]

    def _watch_loop(self) -> None:
        for event in self._watcher:
            if event.typ == EVENT_LIST_DONE:
                self._synced.set()
                continue
            name = self._name(event.key)
            if event.typ in (EVENT_CREATE, EVENT_MODIFY):
                try:
                    value = json.loads(event.value.decode())
                except ValueError:
                    continue
                with self._mu:
                    self._remote[name] = value
                if self._on_update:
                    self._on_update(name, value)
            elif event.typ == EVENT_DELETE:
                with self._mu:
                    self._remote.pop(name, None)
                if self._on_delete:
                    self._on_delete(name)

    def wait_synced(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    def update_local(self, name: str, value: dict) -> None:
        with self._mu:
            self._local[name] = value
        self.backend.set(self.prefix + name,
                         json.dumps(value, sort_keys=True).encode(),
                         lease=True)

    def delete_local(self, name: str) -> None:
        with self._mu:
            self._local.pop(name, None)
        self.backend.delete(self.prefix + name)

    def snapshot(self) -> Dict[str, dict]:
        """Merged view (remote watch state; includes our own published
        keys once they echo back through the watch)."""
        with self._mu:
            return dict(self._remote)

    def close(self) -> None:
        self._watcher.stop()
        self._thread.join(timeout=1.0)
