"""The out-of-process proxy: a supervised child enforcing pushed policy.

Reference: the agent runs Envoy as a separate supervised process
(pkg/envoy/envoy.go:145); Envoy subscribes to NPDS/NPHDS over xDS,
applies each versioned policy snapshot, and ACKs — the agent's policy
push completes only when every proxy has applied it.

This child connects to the agent's XDSWireServer, subscribes to the
NetworkPolicy stream, and (re)configures its SocketProxy listeners from
each push: one listener per resource, enforcing the resource's HTTP
rules on live TCP, forwarding allowed requests to the resource's
upstream.  The ACK is sent only after listeners are live (apply-then-
ack), so the agent's completion barrier really means "enforced".

Resource shape consumed (producer: xds.network_policy_resource +
listener fields):
  {"name": "<endpoint id>", "policy": <revision>,
   "proxy_port": N, "upstream": [host, port],
   "http_rules": [{"method": ..., "path": ..., "host": ...}, ...]}

Run: python -m cilium_tpu_torch.l7.proxy_child <xds_port> [--device D]
Prints one line "READY <pid>" on stdout once subscribed.

Port of ``cilium_tpu/l7/proxy_child.py``.  The HTTP engines hold their
tables on ``--device`` (default ``cuda``; without a card the child
raises before it subscribes).  The reference pins its child to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from typing import Dict

from ..device import DeviceLike, resolve_device
from ..policy.api import PortRuleHTTP
from ..xds import TYPE_NETWORK_POLICY
from .http import HTTPPolicyEngine
from .socket_proxy import ListenerContext, SocketProxy
from .xds_wire import XDSWireClient


class ProxyChild:
    def __init__(self, xds_port: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.proxy = SocketProxy()
        self.client = XDSWireClient(xds_port,
                                    client=f"proxy-{os.getpid()}")
        self._active: Dict[str, int] = {}  # resource name -> bound port
        self._specs: Dict[str, str] = {}   # resource name -> spec json
        self._lock = threading.Lock()

    def start(self) -> None:
        self.client.subscribe(TYPE_NETWORK_POLICY, self._apply)

    def _apply(self, version: int, resources: Dict) -> bool:
        """Realize one NPDS snapshot: listeners for every resource,
        tear down listeners whose resource vanished.  Returns True
        (ACK) only when everything is live."""
        with self._lock:
            try:
                return self._apply_locked(version, resources)
            except Exception:
                # crash-only recovery: a half-applied snapshot must not
                # orphan listeners (a retry would EADDRINUSE forever) —
                # tear everything down, NACK, and let the next push
                # rebuild from nothing
                for name in self._active:
                    try:
                        self.proxy.stop_listener(f"res-{name}")
                    except Exception:  # noqa: BLE001
                        pass
                for rid in list(self.proxy._servers):
                    try:
                        self.proxy.stop_listener(rid)
                    except Exception:  # noqa: BLE001
                        pass
                self._active, self._specs = {}, {}
                raise

    def _apply_locked(self, version: int, resources: Dict) -> bool:
        wanted, specs = {}, {}
        for name, res in resources.items():
            rid = f"res-{name}"
            spec = json.dumps(res, sort_keys=True)
            if self._specs.get(name) == spec:
                # unchanged resource: keep the live listener (no
                # rebind window for in-flight traffic)
                wanted[name] = self._active[name]
                specs[name] = spec
                continue
            port = int(res.get("proxy_port", 0))
            upstream = tuple(res.get("upstream", ("127.0.0.1", 0)))
            rules = [PortRuleHTTP(**r)
                     for r in res.get("http_rules", [])]
            engine = HTTPPolicyEngine(rules, device=self.device)
            ctx = ListenerContext(
                redirect_id=rid, parser_type="http",
                orig_dst=lambda peer, u=upstream: u,
                http_engine_for=lambda peer, e=engine: e)
            # replace any existing listener for this resource
            if name in self._active:
                self.proxy.stop_listener(rid)
            wanted[name] = self.proxy.start_listener(port, ctx)
            specs[name] = spec
        for gone in set(self._active) - set(wanted):
            self.proxy.stop_listener(f"res-{gone}")
        self._active, self._specs = wanted, specs
        return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="proxy_child")
    ap.add_argument("xds_port", type=int)
    ap.add_argument("--device", default="cuda",
                    help="where the HTTP engines hold their tables "
                         "(cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    child = ProxyChild(args.xds_port, device=args.device)
    child.start()
    print(f"READY {os.getpid()}", flush=True)
    # crash-only: when the agent's stream dies (agent crash/restart),
    # this child would otherwise serve stale policy forever AND hold
    # the proxy ports against the successor agent's child (EADDRINUSE).
    # Exit instead; the supervisor respawns against the live agent.
    # (Deliberate divergence from Envoy's serve-last-known-good: a
    # short L7 outage over indefinitely stale enforcement.)
    child.client.wait_disconnected()
    os._exit(1)


if __name__ == "__main__":
    main()
