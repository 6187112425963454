"""kvstore distribution of the ipcache.

Reference: pkg/ipcache/kvstore.go — the agent writes its local
endpoints' IPs to ``cilium/state/ip/v1/default/<ip>`` (lease-backed so
dead nodes' entries expire) and every agent runs an
``IPIdentityWatcher`` ingesting the whole prefix into its local cache
with source=kvstore (daemon/daemon.go:1323 InitIPIdentityWatcher).

A whole copy of ``cilium_tpu/ipcache/kvstore_sync.py``.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from ..kvstore.backend import BackendOperations
from .ipcache import (DELETE, SOURCE_KVSTORE, UPSERT, IPCache,
                      IPIdentityPair, normalize_prefix)

IP_IDENTITIES_PATH = "cilium/state/ip/v1/default"


def _key_for(prefix: str) -> str:
    return f"{IP_IDENTITIES_PATH}/{prefix}"


def _marshal(pair: IPIdentityPair) -> bytes:
    return json.dumps({"IP": pair.prefix, "ID": pair.identity,
                       "HostIP": pair.host_ip,
                       "Metadata": pair.metadata}).encode()


def _unmarshal(prefix_key: str, value: bytes) -> Optional[IPIdentityPair]:
    try:
        d = json.loads(value.decode())
        return IPIdentityPair(prefix=normalize_prefix(d["IP"]),
                              identity=int(d["ID"]),
                              source=SOURCE_KVSTORE,
                              host_ip=d.get("HostIP"),
                              metadata=d.get("Metadata", ""))
    except (ValueError, KeyError):
        return None


class KVStoreIPCacheSyncer:
    """Outbound: publish local mappings to the kvstore (lease-backed).

    Reference: ipcache.go UpsertIPToKVStore / DeleteIPFromKVStore.
    """

    def __init__(self, backend: BackendOperations):
        self.backend = backend

    def upsert(self, pair: IPIdentityPair) -> None:
        self.backend.set(_key_for(pair.prefix), _marshal(pair), lease=True)

    def delete(self, prefix: str) -> None:
        self.backend.delete(_key_for(normalize_prefix(prefix)))

    def listener(self):
        """An IPCache listener that replicates agent-local entries out.

        Only agent-local/local sources originate here: kvstore-sourced
        entries came *from* the store and must not echo back, and
        generated (policy-CIDR) entries are node-local state — if they
        were published, this agent's own watcher would re-ingest them
        as SOURCE_KVSTORE (higher precedence than generated) and the
        delete on policy removal would be precedence-blocked forever.
        """
        from .ipcache import SOURCE_AGENT_LOCAL, SOURCE_LOCAL

        def on_change(mod: str, pair: IPIdentityPair,
                      old_id: Optional[int]) -> None:
            if pair.source not in (SOURCE_AGENT_LOCAL, SOURCE_LOCAL):
                return
            if mod == UPSERT:
                self.upsert(pair)
            else:
                self.delete(pair.prefix)
        return on_change


class IPIdentityWatcher:
    """Inbound: watch the kvstore prefix and ingest remote mappings.

    Reference: ipcache/kvstore.go IPIdentityWatcher.Watch.

    With ``restart=True`` (the control-plane survivability mode) a
    watch stream that ends without ``stop()`` — a kvstore outage on a
    transport whose watchers don't self-heal — is re-established with
    a fresh ``list_and_watch``, and the relist is diffed against the
    consumer-visible prefix set so an entry deleted in the blind
    window is removed instead of silently retained (the same Replace
    semantics as the etcd compaction relist).
    """

    def __init__(self, backend: BackendOperations, cache: IPCache,
                 restart: bool = False, restart_backoff_s: float = 0.5):
        self.backend = backend
        self.cache = cache
        self.restart = restart
        self.restart_backoff_s = restart_backoff_s
        self.restarts = 0
        self._watcher = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._synced = threading.Event()

    def start(self) -> None:
        self._watcher = self.backend.list_and_watch(IP_IDENTITIES_PATH)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ipcache-watcher")
        self._thread.start()

    def _loop(self) -> None:
        known: set = set()  # consumer-visible kvstore-sourced prefixes
        while True:
            in_initial = True
            listed: set = set()
            for event in self._watcher:
                if self._stop.is_set():
                    return
                if event.typ == "list-done":
                    if known - listed:
                        # blind-window deletes: present before the
                        # stream died, absent from the fresh listing
                        for prefix in sorted(known - listed):
                            self.cache.delete(prefix, SOURCE_KVSTORE)
                            known.discard(prefix)
                    in_initial = False
                    self._synced.set()
                    continue
                prefix = normalize_prefix(
                    event.key[len(IP_IDENTITIES_PATH) + 1:])
                if event.typ in ("create", "modify"):
                    pair = _unmarshal(event.key, event.value)
                    if pair is not None:
                        known.add(pair.prefix)
                        if in_initial:
                            listed.add(pair.prefix)
                        self.cache.upsert(pair.prefix, pair.identity,
                                          SOURCE_KVSTORE,
                                          host_ip=pair.host_ip,
                                          metadata=pair.metadata)
                elif event.typ == "delete":
                    known.discard(prefix)
                    self.cache.delete(prefix, SOURCE_KVSTORE)
            # stream ended without stop(): dead transport
            if not self.restart or self._stop.is_set():
                return
            if self._stop.wait(self.restart_backoff_s):
                return
            try:
                self._watcher = self.backend.list_and_watch(
                    IP_IDENTITIES_PATH)
                self.restarts += 1
            except Exception:  # noqa: BLE001 — still down; retry
                # re-enter the backoff with a drained dead watcher
                self._watcher = iter(())

    def wait_synced(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._watcher is not None and \
                hasattr(self._watcher, "stop"):
            self._watcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
