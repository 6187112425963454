"""Hubble Relay: federated get_flows across cluster nodes.

Reference: hubble-relay — one query fans out to every node's observer
and merges the answers; a dead node degrades the answer to a flagged
partial result, never a hang.  Here each peer is a fetch callable
(in-process observer, or a REST /flows client built by ``rest_peer``),
wrapped in the transport resilience layer (utils/resilience): every
fan-out leg runs under a Deadline on its own thread, and a per-peer
CircuitBreaker turns a flapping peer into one bounded probe per
interval instead of a per-query timeout tax.

A whole copy of ``cilium_tpu/hubble/relay.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.metrics import (HUBBLE_RELAY_FAILURES, HUBBLE_RELAY_PEERS,
                             HUBBLE_RELAY_SECONDS)
from ..utils.resilience import CircuitBreaker, Deadline
from .filter import FlowFilter

# fetch(filter_query: Dict[str, str], since: int, limit: int)
#   -> {"flows": [flow dict, ...]}
PeerFetch = Callable[[Dict[str, str], int, int], Dict]


class _Peer:
    def __init__(self, name: str, fetch: PeerFetch):
        self.name = name
        self.fetch = fetch
        self.breaker = CircuitBreaker(f"hubble-relay:{name}",
                                      failure_threshold=2,
                                      reset_timeout=0.2, max_reset=5.0)
        self.last_error = ""
        self.last_ok = 0.0


def rest_peer(base_url: str, timeout: float = 3.0) -> PeerFetch:
    """Fetch callable against a peer agent's REST /flows."""
    import json
    import urllib.request
    from urllib.parse import urlencode
    base = base_url.rstrip("/")

    def fetch(query: Dict[str, str], since: int, limit: int) -> Dict:
        params = dict(query)
        if since:
            params["since"] = str(since)
        params["n"] = str(limit)
        url = f"{base}/flows?{urlencode(params)}"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    return fetch


class HubbleRelay:
    """Fan-out aggregator over registered peers (hubble-relay analog).

    Peers register explicitly (``add_peer``) or via a node source — a
    callable returning {name: base_url} (the node-registry /
    clustermesh wiring in daemon/daemon.py) re-polled per query so
    joins/leaves need no extra plumbing."""

    def __init__(self, local_name: str = "",
                 local_fetch: Optional[PeerFetch] = None,
                 node_source: Optional[Callable[[], Dict[str, str]]]
                 = None, deadline_s: float = 2.0):
        self._mu = threading.Lock()
        self._peers: Dict[str, _Peer] = {}
        self.node_source = node_source
        self.deadline_s = deadline_s
        self.local_name = local_name
        # names the node source may announce for THIS node (e.g. its
        # registry full name) — never added as remote peers, or the
        # local store would be double-counted
        self.local_names = {local_name} if local_name else set()
        if local_name and local_fetch is not None:
            self.add_peer(local_name, local_fetch)

    def add_peer(self, name: str, fetch: PeerFetch) -> None:
        with self._mu:
            if name not in self._peers:
                self._peers[name] = _Peer(name, fetch)
            else:
                self._peers[name].fetch = fetch
        self._export_gauge()

    def remove_peer(self, name: str) -> bool:
        with self._mu:
            gone = self._peers.pop(name, None) is not None
        self._export_gauge()
        return gone

    def peers(self) -> List[str]:
        self._sync_node_source()
        with self._mu:
            return sorted(self._peers)

    def _sync_node_source(self) -> None:
        if self.node_source is None:
            return
        try:
            nodes = self.node_source() or {}
        except Exception:  # noqa: BLE001 — a broken source adds no peers
            return
        for name, base_url in nodes.items():
            with self._mu:
                known = name in self._peers
            if not known and name not in self.local_names:
                self.add_peer(name, rest_peer(base_url))

    def _export_gauge(self) -> None:
        with self._mu:
            n = len(self._peers)
            open_ = sum(1 for p in self._peers.values()
                        if p.breaker.state != "closed")
        HUBBLE_RELAY_PEERS.set(n - open_, labels={"state": "available"})
        HUBBLE_RELAY_PEERS.set(open_, labels={"state": "degraded"})

    # ------------------------------------------------------------ query

    def get_flows(self, flt: Optional[FlowFilter] = None,
                  limit: int = 100,
                  deadline_s: Optional[float] = None) -> Dict:
        """Federated query: every peer under one deadline.

        Returns {"flows": [...], "nodes": [per-peer status], "partial":
        bool} — flows merged oldest-first by (timestamp, node, seq);
        a peer that fails, times out, or is breaker-open contributes a
        flagged status instead of blocking the answer (fail-open)."""
        self._sync_node_source()
        query = (flt or FlowFilter()).to_query()
        budget = deadline_s if deadline_s is not None else self.deadline_s
        deadline = Deadline(budget)
        with self._mu:
            peers = list(self._peers.values())
        # observability: the fan-out joins the caller's trace (or
        # roots a new one) so `cilium-tpu trace` shows the relay leg
        from ..observability.tracer import tracer
        span = tracer.span("relay.get_flows",
                           attrs={"peers": len(peers),
                                  "deadline-s": budget})

        results: Dict[str, Dict] = {}
        threads = []

        def fan(peer: _Peer):
            t0 = time.monotonic()
            try:
                out = peer.fetch(query, 0, limit)
                HUBBLE_RELAY_SECONDS.observe(time.monotonic() - t0)
                flows = out.get("flows", out) if isinstance(out, dict) \
                    else out
                # sharded peers (hubble/federation.py) attach
                # per-shard fail-open statuses to their answer; they
                # ride the node status so a mesh-wide observe can
                # flag exactly the degraded fault domain
                shards = out.get("shards") \
                    if isinstance(out, dict) else None
                results[peer.name] = {"status": "ok",
                                      "flows": list(flows or []),
                                      "shards": shards}
                peer.breaker.record_success()
                peer.last_ok = time.time()
            except Exception as e:  # noqa: BLE001 — per-peer fail-open
                HUBBLE_RELAY_SECONDS.observe(time.monotonic() - t0)
                HUBBLE_RELAY_FAILURES.inc(labels={"peer": peer.name,
                                                  "kind": "error"})
                peer.breaker.record_failure()
                peer.last_error = repr(e)
                results[peer.name] = {"status": "error",
                                      "error": repr(e), "flows": []}

        node_status: List[Dict] = []
        for peer in peers:
            if not peer.breaker.allow():
                # bounded degradation: no connection attempt while open
                HUBBLE_RELAY_FAILURES.inc(labels={"peer": peer.name,
                                                  "kind": "breaker-open"})
                results[peer.name] = {"status": "breaker-open",
                                      "error": peer.last_error,
                                      "flows": []}
                continue
            th = threading.Thread(target=fan, args=(peer,), daemon=True,
                                  name=f"hubble-relay-{peer.name}")
            th.start()
            threads.append((peer, th))
        for peer, th in threads:
            th.join(timeout=max(0.0, deadline.remaining()))
            if th.is_alive():
                # the leg may land later (results writes are atomic);
                # for THIS answer the peer is a flagged timeout
                HUBBLE_RELAY_FAILURES.inc(labels={"peer": peer.name,
                                                  "kind": "timeout"})
                peer.breaker.record_failure()
                peer.last_error = f"timeout after {budget}s"
                results.setdefault(peer.name,
                                   {"status": "timeout",
                                    "error": peer.last_error,
                                    "flows": []})

        flows: List[Dict] = []
        partial = False
        for peer in peers:
            r = results.get(peer.name, {"status": "timeout", "flows": []})
            got = r.get("flows", [])
            for f in got:
                f.setdefault("node", peer.name)
            flows.extend(got)
            node_status.append({"name": peer.name,
                                "status": r["status"],
                                "flows": len(got),
                                "breaker": peer.breaker.state,
                                **({"shards": r["shards"]}
                                   if r.get("shards") else {}),
                                **({"error": r["error"]}
                                   if r.get("error") else {})})
            if r["status"] != "ok":
                partial = True
            elif any(s.get("status") != "ok"
                     for s in r.get("shards") or []):
                # a degraded dataplane shard is a fail-open partial:
                # its FAIL-STATIC flows are in the answer, flagged
                partial = True
        flows.sort(key=lambda f: (f.get("timestamp", 0.0),
                                  f.get("node", ""), f.get("seq", 0)))
        if limit:
            flows = flows[-limit:]
        self._export_gauge()
        span.set_attr("flows", len(flows))
        span.set_attr("partial", partial)
        span.finish()
        return {"flows": flows, "nodes": node_status, "partial": partial}

    def node_health(self) -> List[Dict]:
        """Peer health without a query (bugtool / /flows/stats view)."""
        with self._mu:
            peers = list(self._peers.values())
        return [{"name": p.name, "breaker": p.breaker.state,
                 "last-ok": p.last_ok, "last-error": p.last_error}
                for p in peers]
