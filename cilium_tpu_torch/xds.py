"""Versioned resource distribution with ACK barriers (xDS analog).

Reference: pkg/envoy/xds — the agent runs a tiny xDS server with three
streams: LDS (listeners), NPDS (per-endpoint NetworkPolicy) and NPHDS
(ip -> identity host mapping); each resource set is versioned, watchers
receive updates, and policy pushes block on client ACKs through
completion barriers (server.go:114 StartXDSServer, the
completion.WaitGroup usage in UpdateNetworkPolicy).

Here the transport is in-process subscriptions (a gRPC shim would sit
on top); the versioning/ACK/completion semantics are the same.

A whole copy of ``cilium_tpu/xds.py``; ``l7/xds_wire.py`` serves it over
TCP.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from .utils.completion import Completion, WaitGroup

# The reference's three type URLs (pkg/envoy/xds + cilium protos).
TYPE_LISTENER = "type.googleapis.com/envoy.api.v2.Listener"
TYPE_NETWORK_POLICY = "type.googleapis.com/cilium.NetworkPolicy"
TYPE_NETWORK_POLICY_HOSTS = "type.googleapis.com/cilium.NetworkPolicyHosts"


@dataclass
class VersionedResources:
    version: int
    resources: Dict[str, object]  # name -> resource


class Watch:
    """One client's subscription to a type URL."""

    def __init__(self, cache: "Cache", type_url: str, client: str):
        self.cache = cache
        self.type_url = type_url
        self.client = client
        self._cond = threading.Condition()
        self._acked = 0
        self._delivered = 0

    def next(self, timeout: Optional[float] = None
             ) -> Optional[VersionedResources]:
        """Block until a version newer than the last delivered exists."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self.cache._version_of(self.type_url) >
                self._delivered, timeout=timeout)
            if not ok:
                return None
        vr = self.cache.get(self.type_url)
        self._delivered = vr.version
        return vr

    def ack(self, version: int) -> None:
        """Client accepted ``version`` (xds ACK path) — completes any
        barriers waiting on it."""
        with self._cond:
            self._acked = max(self._acked, version)
        self.cache._on_ack(self.type_url, self.client, version)

    def nack(self, version: int, detail: str = "") -> None:
        self.cache._on_nack(self.type_url, self.client, version, detail)

    def _notify(self) -> None:
        with self._cond:
            self._cond.notify_all()


class Cache:
    """Versioned typed resource sets + ACK-tracking (xds/cache.go +
    ack.go AckingResourceMutator)."""

    def __init__(self):
        self._lock = threading.RLock()
        # serializes read-modify-write mutations WITHOUT being held
        # while notifying watchers (Watch.next holds its condition and
        # then takes self._lock — holding self._lock across _notify
        # would be an ABBA deadlock)
        self._mutate = threading.Lock()
        self._sets: Dict[str, VersionedResources] = {}
        self._watches: Dict[str, List[Watch]] = {}
        # (type_url, version) -> completions waiting on full ACK
        self._pending: Dict[tuple, List[tuple]] = {}
        self.nacks: List[tuple] = []

    # ------------------------------------------------------------- write

    def set_resources(self, type_url: str,
                      resources: Dict[str, object]) -> int:
        """Replace the full set; returns the new version."""
        with self._mutate:
            return self._set_resources_mutating(type_url, resources)

    def _set_resources_mutating(self, type_url: str,
                                resources: Dict[str, object]) -> int:
        with self._lock:
            cur = self._sets.get(type_url)
            version = (cur.version if cur else 0) + 1
            self._sets[type_url] = VersionedResources(
                version=version, resources=dict(resources))
            watches = list(self._watches.get(type_url, []))
        # notify outside self._lock (see __init__ lock-order note)
        for w in watches:
            w._notify()
        return version

    def upsert(self, type_url: str, name: str, resource: object) -> int:
        with self._mutate:
            cur = self.get(type_url)
            resources = dict(cur.resources)
            resources[name] = resource
            return self._set_resources_mutating(type_url, resources)

    def delete(self, type_url: str, name: str) -> int:
        with self._mutate:
            cur = self.get(type_url)
            resources = dict(cur.resources)
            resources.pop(name, None)
            return self._set_resources_mutating(type_url, resources)

    # -------------------------------------------------------------- read

    def get(self, type_url: str) -> VersionedResources:
        with self._lock:
            vr = self._sets.get(type_url)
            return vr if vr is not None else VersionedResources(0, {})

    def _version_of(self, type_url: str) -> int:
        with self._lock:
            vr = self._sets.get(type_url)
            return vr.version if vr else 0

    # ------------------------------------------------------------ watches

    def watch(self, type_url: str, client: str) -> Watch:
        w = Watch(self, type_url, client)
        with self._lock:
            self._watches.setdefault(type_url, []).append(w)
        return w

    def unwatch(self, watch: Watch) -> None:
        """Drop a subscription.  A client that vanishes mid-barrier
        (proxy crash during a policy push) must not strand the push:
        its name is removed from every pending ACK set, and barriers
        that only waited on it complete — the remaining watcher set is
        what the push can still mean (the reference's e2e server
        cancels the stream's pending completions the same way)."""
        completed = []
        with self._lock:
            ws = self._watches.get(watch.type_url, [])
            if watch in ws:
                ws.remove(watch)
            # another live watch under the same client name (a restarted
            # proxy resubscribing before the old conn reaps) still
            # holds the barrier
            live = {w.client for w in ws}
            if watch.client not in live:
                for (t, v), entries in list(self._pending.items()):
                    if t != watch.type_url:
                        continue
                    for missing, comp in entries:
                        missing.discard(watch.client)
                        if not missing:
                            completed.append(comp)
                    self._pending[(t, v)] = [(m, c) for m, c in entries
                                             if m]
                    if not self._pending[(t, v)]:
                        del self._pending[(t, v)]
        for comp in completed:
            comp.complete()

    # ---------------------------------------------------------------- ack

    def wait_for_acks(self, type_url: str, version: int,
                      wg: Optional[WaitGroup] = None) -> Completion:
        """A Completion that fires when EVERY current watcher of
        ``type_url`` has ACKed >= version (the barrier the agent blocks
        on before marking a policy revision realized —
        envoy/server.go UpdateNetworkPolicy + completion.WaitGroup)."""
        comp = wg.add_completion() if wg is not None else Completion()
        with self._lock:
            watches = list(self._watches.get(type_url, []))
            missing = {w.client for w in watches
                       if w._acked < version}
            if not missing:
                comp.complete()
                return comp
            self._pending.setdefault((type_url, version), []).append(
                (missing, comp))
        return comp

    def _on_ack(self, type_url: str, client: str, version: int) -> None:
        completed = []
        with self._lock:
            for (t, v), entries in list(self._pending.items()):
                if t != type_url or v > version:
                    continue
                for missing, comp in entries:
                    missing.discard(client)
                    if not missing:
                        completed.append(comp)
                self._pending[(t, v)] = [
                    (m, c) for m, c in entries if m]
                if not self._pending[(t, v)]:
                    del self._pending[(t, v)]
        for comp in completed:
            comp.complete()

    def _on_nack(self, type_url: str, client: str, version: int,
                 detail: str) -> None:
        with self._lock:
            self.nacks.append((type_url, client, version, detail))


# ---------------------------------------------------------------------------
# Typed helpers: the NPDS / NPHDS payload shapes
# ---------------------------------------------------------------------------

def network_policy_resource(endpoint_id: int, policy_revision: int,
                            ingress_rules: List[Dict],
                            egress_rules: List[Dict]) -> Dict:
    """cilium.NetworkPolicy-shaped resource (envoy/server.go:606
    getNetworkPolicy): per-port rules with allowed remote identities +
    HTTP header match specs."""
    return {"name": str(endpoint_id), "policy": policy_revision,
            "ingress_per_port_policies": ingress_rules,
            "egress_per_port_policies": egress_rules}


def host_mapping_resources(ip_to_identity: Dict[str, int]) -> Dict[str, object]:
    """cilium.NetworkPolicyHosts resources: identity -> host ips
    (cilium_host_map.cc consumption shape)."""
    by_identity: Dict[int, List[str]] = {}
    for ip, ident in ip_to_identity.items():
        by_identity.setdefault(ident, []).append(ip)
    return {str(ident): {"policy": ident,
                         "host_addresses": sorted(ips)}
            for ident, ips in by_identity.items()}
