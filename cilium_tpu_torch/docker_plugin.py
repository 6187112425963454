"""Docker libnetwork remote driver: docker -> agent endpoint lifecycle.

The second container-runtime front end next to the CNI plugin
(reference: plugins/cilium-docker/driver/driver.go + ipam.go).  Docker's
libnetwork calls a remote plugin over HTTP POST with JSON bodies; the
driver answers the NetworkDriver + IpamDriver method set and drives the
agent's REST API:

  Plugin.Activate                 -> {Implements: [NetworkDriver, IpamDriver]}
  NetworkDriver.GetCapabilities   -> local scope (driver.go:240)
  NetworkDriver.Create/DeleteNetwork -> accepted, no state (driver.go:249)
  NetworkDriver.CreateEndpoint    -> PUT /endpoint/{id} (driver.go:283)
  NetworkDriver.Join              -> interface name + static routes +
                                     gateway from daemon addressing
                                     (driver.go:389)
  NetworkDriver.Leave             -> DELETE /endpoint/{id} (driver.go:436)
  IpamDriver.RequestPool          -> CiliumPoolv4/v6 (ipam.go:56)
  IpamDriver.Request/ReleaseAddress -> POST /ipam, DELETE /ipam/{ip}
                                     (ipam.go:102,152)

One inversion vs the reference: it is IPv6-primary (CreateEndpoint
rejects a missing v6 address, driver.go:291); this build is IPv4-first
(the datapath's 32-bit key word), so v4 is required and v6 optional.

The HTTP transport is stdlib http.server on localhost TCP (same choice
as daemon/rest.py; the reference listens on a unix socket that docker
discovers via /run/docker/plugins).  All method logic lives in
LibnetworkDriver.handle() so tests can drive it with plain dicts.

A whole copy of ``cilium_tpu/docker_plugin.py`` over the port's
``cli.Client``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from .cli import Client
from .endpoint.ids import DOCKER_ID_BASE, stable_endpoint_id

POOL_V4 = "CiliumPoolv4"
POOL_V6 = "CiliumPoolv6"
CONTAINER_IF_PREFIX = "cilium"


class PluginError(RuntimeError):
    """Maps to the libnetwork error response {"Err": msg}."""


def endpoint_id_for(docker_endpoint_id: str) -> int:
    """Stable numeric endpoint id from docker's endpoint UUID (the
    reference derives it from the v6 address's low bits,
    addressing.CiliumIPv6.EndpointID; any stable mapping works)."""
    return stable_endpoint_id(docker_endpoint_id, DOCKER_ID_BASE)


class LibnetworkDriver:
    """The method-set handler, independent of transport."""

    def __init__(self, client: Client, wait_tries: int = 24,
                 wait_base_s: float = 1.0):
        self.client = client
        # the reference waits up to ~24 escalating sleeps for the
        # daemon (driver.go:100); tests pass small values
        conf = None
        for attempt in range(wait_tries):
            try:
                conf = client.get("/config")
                break
            except SystemExit:
                if attempt == wait_tries - 1:
                    raise PluginError("cilium daemon unreachable")
                time.sleep(wait_base_s * attempt)
        self._lock = threading.Lock()
        self.addressing = (conf or {}).get("addressing", {})
        if not self.addressing.get("ipv4", {}).get("ip"):
            raise PluginError("daemon returned no IPv4 addressing")

    # ------------------------------------------------------------ util

    def _update_addressing(self, addressing: Optional[Dict]) -> None:
        """Host addressing can change across a daemon restart; refresh
        from every IPAM response like the reference (ipam.go:126)."""
        if addressing:
            with self._lock:
                self.addressing = addressing

    def _routes(self):
        """Static routes the container needs: the pod CIDR is CONNECTED
        via the cilium interface, everything else goes to the gateway
        (connector.IPv4Routes analog)."""
        with self._lock:
            v4 = self.addressing.get("ipv4", {})
            v6 = self.addressing.get("ipv6", {})
        routes = []
        if v4.get("ip"):
            routes.append({"Destination": f"{v4['ip']}/32",
                           "RouteType": 1, "NextHop": ""})
            routes.append({"Destination": "0.0.0.0/0",
                           "RouteType": 0, "NextHop": v4["ip"]})
        if v6.get("ip"):
            routes.append({"Destination": f"{v6['ip']}/128",
                           "RouteType": 1, "NextHop": ""})
        return routes

    # --------------------------------------------------------- methods

    def handle(self, method: str, body: Dict) -> Dict:
        """Dispatch one libnetwork method; raises PluginError on
        failure (transport encodes it as {"Err": ...})."""
        fn = self._METHODS.get(method)
        if fn is None:
            raise PluginError(f"unknown plugin method {method!r}")
        return fn(self, body or {})

    def _activate(self, body: Dict) -> Dict:
        return {"Implements": ["NetworkDriver", "IpamDriver"]}

    def _capabilities(self, body: Dict) -> Dict:
        return {"Scope": "local"}

    def _create_network(self, body: Dict) -> Dict:
        return {}

    def _delete_network(self, body: Dict) -> Dict:
        return {}

    def _create_endpoint(self, body: Dict) -> Dict:
        eid = body.get("EndpointID", "")
        iface = body.get("Interface") or {}
        ipv4 = (iface.get("Address") or "").split("/")[0]
        if not ipv4:
            raise PluginError("no IPv4 address provided (required)")
        ep_id = endpoint_id_for(eid)
        try:
            self.client.get(f"/endpoint/{ep_id}")
        except SystemExit as e:
            # only a 404 means "free to create"; a 5xx or an
            # unreachable agent must surface, not masquerade as the
            # normal create path
            if getattr(e, "status", None) != 404:
                raise PluginError(f"agent lookup failed: {e}")
        else:
            raise PluginError("endpoint already exists")
        labels = [f"container:docker-endpoint={eid[:12]}"]
        net = body.get("NetworkID", "")
        if net:
            labels.append(f"container:docker-network={net[:12]}")
        try:
            self.client.put(f"/endpoint/{ep_id}", {
                "ipv4": ipv4, "container-name": eid[:12],
                "labels": labels})
        except SystemExit as e:
            raise PluginError(f"endpoint create failed: {e}")
        # MAC resolves at Join time, like the reference (driver.go:350)
        return {"Interface": {"MacAddress": ""}}

    def _delete_endpoint(self, body: Dict) -> Dict:
        # link teardown only in the reference (driver.go:363); the
        # agent endpoint is removed at Leave
        return {}

    def _endpoint_info(self, body: Dict) -> Dict:
        return {"Value": {}}

    def _join(self, body: Dict) -> Dict:
        eid = body.get("EndpointID", "")
        ep_id = endpoint_id_for(eid)
        try:
            self.client.get(f"/endpoint/{ep_id}")
        except SystemExit as e:
            # a transient agent failure must not read as "endpoint
            # gone" — docker would tear down a live container
            if getattr(e, "status", None) == 404:
                raise PluginError(f"endpoint {eid!r} not found")
            raise PluginError(f"agent lookup failed: {e}")
        with self._lock:
            gw6 = self.addressing.get("ipv6", {}).get("ip", "")
        return {
            "InterfaceName": {"SrcName": f"tmp{ep_id}",
                              "DstPrefix": CONTAINER_IF_PREFIX},
            "StaticRoutes": self._routes(),
            "DisableGatewayService": True,
            "GatewayIPv6": gw6,
        }

    def _leave(self, body: Dict) -> Dict:
        ep_id = endpoint_id_for(body.get("EndpointID", ""))
        try:
            self.client.delete(f"/endpoint/{ep_id}")
        except SystemExit as e:
            # 404 = already gone; Leave stays idempotent
            # (driver.go:443).  Anything else would leak the endpoint
            if getattr(e, "status", None) != 404:
                raise PluginError(f"endpoint delete failed: {e}")
        return {}

    def _ipam_capabilities(self, body: Dict) -> Dict:
        return {}

    def _address_spaces(self, body: Dict) -> Dict:
        return {"LocalDefaultAddressSpace": "CiliumLocal",
                "GlobalDefaultAddressSpace": "CiliumGlobal"}

    def _request_pool(self, body: Dict) -> Dict:
        with self._lock:
            v4 = self.addressing.get("ipv4", {})
            v6 = self.addressing.get("ipv6", {})
        if body.get("V6"):
            if not v6.get("ip"):
                raise PluginError("IPv6 not enabled on this daemon")
            return {"PoolID": POOL_V6, "Pool": v6.get("alloc-range", ""),
                    "Data": {"com.docker.network.gateway":
                             f"{v6['ip']}/128"}}
        return {"PoolID": POOL_V4, "Pool": "0.0.0.0/0",
                "Data": {"com.docker.network.gateway": f"{v4['ip']}/32"}}

    def _request_address(self, body: Dict) -> Dict:
        family = "ipv6" if body.get("PoolID") == POOL_V6 else "ipv4"
        try:
            out = self.client.post("/ipam", {"family": family,
                                             "owner": "docker"})
        except SystemExit as e:
            raise PluginError(f"could not allocate IP address: {e}")
        self._update_addressing(out.get("host-addressing"))
        addr = (out.get("address") or {}).get(family)
        if not addr:
            raise PluginError("no IP addressing provided")
        suffix = "/128" if family == "ipv6" else "/32"
        return {"Address": addr + suffix}

    def _release_pool(self, body: Dict) -> Dict:
        return {}

    def _release_address(self, body: Dict) -> Dict:
        try:
            self.client.delete(f"/ipam/{body.get('Address', '')}")
        except SystemExit as e:
            raise PluginError(f"could not release IP address: {e}")
        return {}

    _METHODS = {
        "Plugin.Activate": _activate,
        "NetworkDriver.GetCapabilities": _capabilities,
        "NetworkDriver.CreateNetwork": _create_network,
        "NetworkDriver.DeleteNetwork": _delete_network,
        "NetworkDriver.CreateEndpoint": _create_endpoint,
        "NetworkDriver.DeleteEndpoint": _delete_endpoint,
        "NetworkDriver.EndpointOperInfo": _endpoint_info,
        "NetworkDriver.Join": _join,
        "NetworkDriver.Leave": _leave,
        "IpamDriver.GetCapabilities": _ipam_capabilities,
        "IpamDriver.GetDefaultAddressSpaces": _address_spaces,
        "IpamDriver.RequestPool": _request_pool,
        "IpamDriver.ReleasePool": _release_pool,
        "IpamDriver.RequestAddress": _request_address,
        "IpamDriver.ReleaseAddress": _release_address,
    }


class _PluginHandler(BaseHTTPRequestHandler):
    driver: LibnetworkDriver = None  # set by PluginServer
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            body = {}
        method = self.path.lstrip("/")
        try:
            out = self.driver.handle(method, body)
            code = 200
        except PluginError as e:
            # libnetwork's error convention: 200 + {"Err": msg} is
            # treated as failure by docker; use it like the reference's
            # sendError-by-body cases
            out, code = {"Err": str(e)}, 400
        payload = json.dumps(out).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class PluginServer:
    """Localhost TCP transport for the driver (Listen analog)."""

    def __init__(self, driver: LibnetworkDriver, host: str = "127.0.0.1",
                 port: int = 0):
        handler = type("_Bound", (_PluginHandler,), {"driver": driver})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._srv.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def base_url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "PluginServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="docker-plugin")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def main(argv=None) -> int:
    """``cilium-tpu docker-plugin`` entry: serve the libnetwork method
    set against a running agent."""
    import argparse
    ap = argparse.ArgumentParser(prog="cilium-tpu docker-plugin")
    ap.add_argument("--api", default="http://127.0.0.1:9234")
    ap.add_argument("--listen-port", type=int, default=9235)
    args = ap.parse_args(argv)
    driver = LibnetworkDriver(Client(args.api))
    srv = PluginServer(driver, port=args.listen_port).start()
    print(f"docker libnetwork plugin ready on {srv.base_url}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
