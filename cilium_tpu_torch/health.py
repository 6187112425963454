"""Active path probing across nodes.

Reference: cilium-health + pkg/health — a prober walks the known node
set, issues ICMP + HTTP probes per node (pkg/health/server/prober.go:
139,229), and keeps per-path status with last-seen timestamps; results
surface in ``cilium-health status`` and the agent status. Here the
probe transport is pluggable (an in-process reachability function by
default; a real deployment plugs sockets), the scheduling/state model
is the same.

Port of ``cilium_tpu/health.py``.  ``make_icmp6_probe`` drives the
target engine's v6 step on its device (one ``process6`` row a probe);
the rest is host code, copied whole.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .utils.controller import ControllerManager, ControllerParams

PROBE_ICMP = "icmp"
PROBE_HTTP = "http"


@dataclass
class PathStatus:
    """One node's probe results (healthModels.PathStatus analog)."""

    node: str
    ip: str
    icmp_ok: Optional[bool] = None
    http_ok: Optional[bool] = None
    last_probed: float = 0.0
    latency_s: Dict[str, float] = field(default_factory=dict)
    failures: int = 0

    @property
    def healthy(self) -> bool:
        return bool(self.icmp_ok) and self.http_ok is not False


def make_icmp6_probe(resolve_datapath, src_ip6: str):
    """ICMPv6 probe riding the NDP/echo responder stage (pipeline
    stage 1.5; bpf/lib/icmp6.h): the echo request classifies through
    the datapath of the node that OWNS the probed address — a
    responder only answers for its own router_ip6, so the resolver
    models the wire hop cilium-health's real echo takes.

    ``resolve_datapath``: ``ip -> Datapath`` callable, or a plain dict
    (unknown address = unreachable).  The reachability signal is
    end-to-end: the target's step must answer ICMP6_ECHO_REPLY, and
    the TARGET's own reply synthesis
    (Datapath.icmp6_echo_reply_bytes, built from the router address
    the target has programmed — not from this prober's arguments)
    must parse back addressed from the probed ip to the prober.
    Non-ICMP kinds and v4 addresses answer (True, 0.0) so a caller
    can layer this over another probe_fn."""
    from .compiler.lpm import ipv6_to_words
    from .datapath.engine import make_full_batch6
    from .datapath.events import ICMP6_ECHO_REPLY
    from .datapath.icmp6 import parse_icmp6

    if hasattr(resolve_datapath, "get"):
        mapping = resolve_datapath
        resolve_datapath = mapping.get

    def probe(kind: str, ip: str):
        if kind != PROBE_ICMP or ":" not in ip:
            return True, 0.0
        dp = resolve_datapath(ip)
        if dp is None:
            return False, 0.0
        t0 = time.time()
        batch = make_full_batch6(
            endpoint=[0], saddr=[src_ip6], daddr=[ip],
            sport=[0], dport=[0], direction=[1], proto=[58],
            icmp_type=[128], device=dp.device)
        _v, event, _i, _n = dp.process6(batch)
        if int(event[0]) != ICMP6_ECHO_REPLY:
            return False, time.time() - t0
        # consume the TARGET's synthesized reply like the wire
        # delivered it: its source must be the address we probed
        # (derived from the target's router state, not our inputs)
        try:
            reply = parse_icmp6(dp.icmp6_echo_reply_bytes(src_ip6))
        except (RuntimeError, AssertionError):
            return False, time.time() - t0
        ok = reply["type"] == 129 and reply["checksum_ok"] and \
            reply["src_words"] == list(ipv6_to_words(ip)) and \
            reply["dst_words"] == list(ipv6_to_words(src_ip6))
        return ok, time.time() - t0

    return probe


class HealthProber:
    """Periodic prober over the node set.

    ``nodes_fn`` returns [(node_name, ip)]; ``probe_fn(kind, ip)``
    returns (ok, latency_seconds).
    """

    def __init__(self, nodes_fn: Callable[[], List],
                 probe_fn: Optional[Callable[[str, str], tuple]] = None,
                 interval: float = 10.0,
                 controllers: Optional[ControllerManager] = None):
        self.nodes_fn = nodes_fn
        self.probe_fn = probe_fn or (lambda kind, ip: (True, 0.0))
        self._lock = threading.Lock()
        self._status: Dict[str, PathStatus] = {}
        self._controllers = controllers or ControllerManager()
        self._owns_controllers = controllers is None
        self._controllers.update_controller(
            "health-prober", ControllerParams(do_func=self.probe_once,
                                              run_interval=interval))

    def probe_once(self) -> None:
        """One sweep over all known nodes (prober.go runProbe)."""
        now = time.time()
        seen = set()
        for entry in self.nodes_fn():
            name, ip = entry if isinstance(entry, tuple) else \
                (entry.full_name, entry.get_node_ip())
            if not ip:
                continue
            seen.add(name)
            st = self._get(name, ip)
            for kind in (PROBE_ICMP, PROBE_HTTP):
                try:
                    ok, lat = self.probe_fn(kind, ip)
                except Exception:
                    ok, lat = False, 0.0
                if kind == PROBE_ICMP:
                    st.icmp_ok = ok
                else:
                    st.http_ok = ok
                st.latency_s[kind] = lat
                if not ok:
                    st.failures += 1
            st.last_probed = now
        with self._lock:
            for name in list(self._status):
                if name not in seen:
                    del self._status[name]  # node left the cluster

    def _get(self, name: str, ip: str) -> PathStatus:
        with self._lock:
            st = self._status.get(name)
            if st is None or st.ip != ip:
                st = PathStatus(node=name, ip=ip)
                self._status[name] = st
            return st

    def status(self) -> Dict[str, Dict]:
        """healthModels-shaped dump for REST/CLI."""
        with self._lock:
            return {
                name: {
                    "ip": st.ip,
                    "icmp": st.icmp_ok,
                    "http": st.http_ok,
                    "healthy": st.healthy,
                    "failures": st.failures,
                    "latency-seconds": dict(st.latency_s),
                    "last-probed": st.last_probed,
                } for name, st in sorted(self._status.items())}

    def unhealthy_nodes(self) -> List[str]:
        with self._lock:
            return [n for n, st in self._status.items() if not st.healthy]

    def shutdown(self) -> None:
        if self._owns_controllers:
            self._controllers.remove_all()
        else:
            self._controllers.remove_controller("health-prober")


# ---------------------------------------------------------------------------
# Real-socket transport (cilium-health's probe endpoints)
# ---------------------------------------------------------------------------
#
# The reference runs cilium-health as a per-node responder; the prober
# issues ICMP echo + an HTTP GET against it (prober.go:139,229).  The
# TCP analogs: the "icmp" probe is a bare connect (reachability), the
# "http" probe is a ping/pong round trip through the responder.

class HealthResponder:
    """Per-node probe endpoint (cilium-health listener analog)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import socketserver

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # read to the newline delimiter: TCP has no message
                # boundaries, a segmented "ping\n" must still pong
                try:
                    buf = b""
                    while b"\n" not in buf and len(buf) < 64:
                        chunk = self.request.recv(64)
                        if not chunk:
                            return
                        buf += chunk
                    if buf.startswith(b"ping"):
                        self.request.sendall(b"pong\n")
                except OSError:
                    pass

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = _TCP((host, port), _Handler)
        self.host, self.port = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True,
                                        name="health-responder")

    def start(self) -> "HealthResponder":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()


def make_tcp_probe(port_of: Callable[[str], int],
                   timeout: float = 2.0):
    """A probe_fn over real sockets.  ``port_of(ip)`` maps a node IP
    to its health responder port (the reference derives it from the
    health endpoint's address)."""
    import socket as _socket

    def probe(kind: str, ip: str):
        port = port_of(ip)
        t0 = time.time()
        try:
            with _socket.create_connection((ip, port),
                                           timeout=timeout) as s:
                if kind == PROBE_HTTP:
                    s.settimeout(timeout)
                    s.sendall(b"ping\n")
                    buf = b""
                    while b"\n" not in buf and len(buf) < 16:
                        chunk = s.recv(16)
                        if not chunk:
                            break
                        buf += chunk
                    if not buf.startswith(b"pong"):
                        return False, time.time() - t0
                return True, time.time() - t0
        except OSError:
            return False, time.time() - t0

    return probe
