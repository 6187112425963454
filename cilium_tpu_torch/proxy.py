"""L7 proxy plane: redirect lifecycle, port allocation, engine dispatch.

Reference: pkg/proxy/proxy.go — proxy ports allocated from 10000-20000
(daemon/daemon.go:1326), redirects keyed by ProxyID
``epID:ingress|egress:proto:port`` (pkg/policy/proxyid.go:24), and the
implementation chosen per L7 parser type (proxy.go:154
CreateOrUpdateRedirect: Kafka -> Go proxy, HTTP/other -> Envoy). Here
every redirect owns a compiled batched engine (HTTP DFAs, Kafka ACLs, or
a registered custom parser) plus an access-log stream
(pkg/proxy/logger analog).

A copy of ``cilium_tpu/proxy.py``.  The socket data plane
(``l7/socket_proxy.SocketProxy``) starts on ``enable_dataplane``;
``activate_redirect`` binds a redirect's proxy port there and
``remove_redirect`` closes it.  The redirects' HTTP engines run on the
manager's device.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from .device import DeviceLike, resolve_device
from .l7.http import HTTPPolicyEngine, HTTPRequest
from .l7.kafka import KafkaPolicyEngine, KafkaRequest
from .l7.parser import Instance as ParserInstance
from .labels import LabelArray
from .policy.l4 import (L4Filter, PARSER_TYPE_HTTP, PARSER_TYPE_KAFKA,
                        PARSER_TYPE_NONE)
from .utils.lock import RMutex

PROXY_PORT_MIN = 10000  # reference: daemon.go:1326
PROXY_PORT_MAX = 20000


def proxy_id(endpoint_id: int, ingress: bool, proto: str, port: int) -> str:
    """Reference: pkg/policy/proxyid.go:24 ProxyID."""
    direction = "ingress" if ingress else "egress"
    return f"{endpoint_id}:{direction}:{proto}:{port}"


@dataclass
class AccessLogEntry:
    """One proxied request record (pkg/proxy/logger AccessLogRecord)."""

    timestamp: float
    proxy_id: str
    l7_protocol: str
    verdict: str           # "forwarded" | "denied"
    src_identity: int
    dst_identity: int
    info: Dict = field(default_factory=dict)


class AccessLog:
    """In-process access-log ring (envoy/accesslog.cc + logger analog)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._entries: List[AccessLogEntry] = []
        self.capacity = capacity
        self.subscribers: List[Callable[[AccessLogEntry], None]] = []

    def log(self, entry: AccessLogEntry) -> None:
        with self._lock:
            self._entries.append(entry)
            if len(self._entries) > self.capacity:
                self._entries = self._entries[-self.capacity:]
            subs = list(self.subscribers)
        for s in subs:
            s(entry)

    def tail(self, n: int = 100) -> List[AccessLogEntry]:
        with self._lock:
            return self._entries[-n:]


@dataclass
class Redirect:
    """One active redirect (pkg/proxy/proxy.go Redirect)."""

    id: str
    proxy_port: int
    parser_type: str
    endpoint_id: int
    ingress: bool
    to_port: int
    created: float = field(default_factory=time.time)
    # engines per remote-identity rule resolution
    http_engine: Optional[HTTPPolicyEngine] = None
    kafka_engine: Optional[KafkaPolicyEngine] = None
    l7_filter: Optional[L4Filter] = None

    def engines_for(self, remote_labels: Optional[LabelArray],
                    device: DeviceLike = None):
        """(Re)build engines from the filter's per-selector rules for a
        given remote identity (l4.go GetRelevantRules); an HTTP engine
        runs on ``device``."""
        rules = self.l7_filter.l7_rules_per_ep.get_relevant_rules(
            remote_labels) if self.l7_filter is not None else None
        if self.parser_type == PARSER_TYPE_HTTP:
            return HTTPPolicyEngine(rules.http if rules else [],
                                    device=device)
        if self.parser_type == PARSER_TYPE_KAFKA:
            return KafkaPolicyEngine(rules.kafka if rules else [])
        return None


class ProxyManager:
    """Redirect registry + port allocator (pkg/proxy/proxy.go:88,154)."""

    def __init__(self, port_min: int = PROXY_PORT_MIN,
                 port_max: int = PROXY_PORT_MAX,
                 device: DeviceLike = None):
        # where the redirects' HTTP engines run their DFAs
        self.device = resolve_device(device)
        self._lock = RMutex("proxy-manager")
        self._redirects: Dict[str, Redirect] = {}
        self._ports_in_use: set = set()
        self._next_port = port_min
        self.port_min = port_min
        self.port_max = port_max
        self.access_log = AccessLog()
        # socket data plane (l7/socket_proxy.py), created on demand
        self.dataplane = None
        self.parser_instance = ParserInstance(
            access_logger=lambda d: self.access_log.log(AccessLogEntry(
                timestamp=time.time(), proxy_id=str(d.get("conn_id")),
                l7_protocol=d.get("proto", ""),
                verdict="forwarded" if d.get("verdict") == "pass"
                else "denied",
                src_identity=d.get("src_identity", 0),
                dst_identity=d.get("dst_identity", 0), info=d)))

    def _allocate_port(self) -> int:
        """Reference: proxy.go allocatePort — scan the range."""
        start = self._next_port
        while True:
            p = self._next_port
            self._next_port += 1
            if self._next_port > self.port_max:
                self._next_port = self.port_min
            if p not in self._ports_in_use:
                self._ports_in_use.add(p)
                return p
            if self._next_port == start:
                raise RuntimeError("proxy port range exhausted")

    def create_or_update_redirect(self, flt: L4Filter, endpoint_id: int
                                  ) -> Redirect:
        """Reference: proxy.go:154 CreateOrUpdateRedirect."""
        if flt.l7_parser == PARSER_TYPE_NONE:
            raise ValueError("filter is not a redirect")
        rid = proxy_id(endpoint_id, flt.ingress, flt.protocol, flt.port)
        with self._lock:
            redir = self._redirects.get(rid)
            if redir is None:
                redir = Redirect(id=rid, proxy_port=self._allocate_port(),
                                 parser_type=flt.l7_parser,
                                 endpoint_id=endpoint_id,
                                 ingress=flt.ingress, to_port=flt.port)
                self._redirects[rid] = redir
            redir.parser_type = flt.l7_parser
            redir.l7_filter = flt
        cb = getattr(self, "on_change", None)
        if cb is not None:
            cb()
        return redir

    def remove_redirect(self, rid: str) -> bool:
        with self._lock:
            redir = self._redirects.pop(rid, None)
            if redir is None:
                return False
            self._ports_in_use.discard(redir.proxy_port)
        if self.dataplane is not None:
            try:
                self.dataplane.stop_listener(rid)
            except Exception:  # noqa: BLE001
                pass
        cb = getattr(self, "on_change", None)
        if cb is not None:
            cb()
        return True

    # -- socket data plane ---------------------------------------------------

    def enable_dataplane(self, host: str = "127.0.0.1"):
        """Start the socket-level proxy data plane (lazy import keeps
        asyncio out of pure-policy deployments)."""
        if self.dataplane is None:
            from .l7.socket_proxy import SocketProxy
            self.dataplane = SocketProxy(access_log=self.access_log,
                                         host=host)
        return self.dataplane

    def activate_redirect(self, redir: Redirect,
                          orig_dst: Callable,
                          remote_labels: Optional[Callable] = None,
                          identities: Optional[Callable] = None) -> int:
        """Bind the redirect's proxy port on the data plane.

        orig_dst(peer_addr) -> (host, port): the proxymap analog
        resolving the flow's original destination.
        remote_labels(peer_addr) -> LabelArray: peer identity labels for
        per-selector rule resolution (l4.go GetRelevantRules).
        Returns the bound port (== redir.proxy_port).
        """
        from .l7.socket_proxy import ListenerContext
        dataplane = self.enable_dataplane()
        labels_of = remote_labels or (lambda addr: None)

        def l7_rules(addr):
            if redir.l7_filter is None:
                return []
            rules = redir.l7_filter.l7_rules_per_ep.get_relevant_rules(
                labels_of(addr))
            return list(rules.l7) if rules and rules.l7 else []

        ctx = ListenerContext(
            redirect_id=redir.id,
            parser_type=redir.parser_type,
            orig_dst=orig_dst,
            l7_rules=l7_rules,
            identities=identities or (lambda addr: (0, 0)),
            http_engine_for=lambda addr: redir.engines_for(
                labels_of(addr), device=self.device)
            if redir.parser_type == PARSER_TYPE_HTTP else None,
            kafka_engine_for=lambda addr: redir.engines_for(
                labels_of(addr)) if redir.parser_type ==
            PARSER_TYPE_KAFKA else None)
        return dataplane.start_listener(redir.proxy_port, ctx)

    def shutdown_dataplane(self) -> None:
        if self.dataplane is not None:
            self.dataplane.shutdown()
            self.dataplane = None

    def get(self, rid: str) -> Optional[Redirect]:
        with self._lock:
            return self._redirects.get(rid)

    def redirects(self) -> List[Redirect]:
        with self._lock:
            return list(self._redirects.values())

    def __len__(self):
        with self._lock:
            return len(self._redirects)

    # -- request-time checks (the proxy data path) --------------------------

    def check_http(self, redir: Redirect, remote_labels: LabelArray,
                   requests: Sequence[HTTPRequest]):
        engine = redir.engines_for(remote_labels, device=self.device)
        verdicts = engine.check(requests)
        for req, ok in zip(requests, verdicts):
            self.access_log.log(AccessLogEntry(
                timestamp=time.time(), proxy_id=redir.id, l7_protocol="http",
                verdict="forwarded" if ok else "denied",
                src_identity=0, dst_identity=0,
                info={"method": req.method, "path": req.path,
                      "host": req.host}))
        return verdicts

    def check_kafka(self, redir: Redirect, remote_labels: LabelArray,
                    requests: Sequence[KafkaRequest]):
        engine = redir.engines_for(remote_labels)
        verdicts = engine.check(requests)
        for req, ok in zip(requests, verdicts):
            self.access_log.log(AccessLogEntry(
                timestamp=time.time(), proxy_id=redir.id,
                l7_protocol="kafka",
                verdict="forwarded" if ok else "denied",
                src_identity=0, dst_identity=0,
                info={"api_key": req.api_key, "topics": req.topics,
                      "client_id": req.client_id}))
        return verdicts
