"""The port's xDS cache, its wire, the supervised proxy child and the
agent's xDS server, against the JAX package.

- The cache: the same sequence of writes, watches, ACKs, NACKs and
  unwatches on a JAX ``Cache`` and a port ``Cache`` gives the same
  versions, resources, deliveries and barrier completions.
- The wire (``tests/test_xds_process.py`` on the port): push -> apply ->
  ACK completes the barrier; a NACK is recorded; a slow client holds the
  barrier until it ACKs; a NACKing client blocks no other; a client that
  drops mid-barrier unblocks it.  Interoperation: a JAX client on the
  port's server and a port client on the JAX server receive the same
  resources, and their ACKs complete the barrier.
- The child: ``ProxySupervisor(device="cpu")`` runs the port's child,
  which ACKs v1 and enforces it on live TCP, restarts after ``kill -9``,
  re-syncs, enforces v2, and leaves no process after ``shutdown``.
- The agent: ``Daemon.serve_xds`` of both packages, given the same
  calls, publish equal NPDS and NPHDS resources.

Every server, client, supervisor and daemon is torn down in a
``finally``; every wait has a deadline.
"""

import os
import signal
import socket
import socketserver
import threading
import time

import pytest
import torch

from cilium_tpu import xds as ref_xds
from cilium_tpu.l7 import xds_wire as ref_wire

from cilium_tpu_torch import xds
from cilium_tpu_torch.l7 import xds_wire as wire
from cilium_tpu_torch.l7.supervisor import ProxySupervisor

NP = xds.TYPE_NETWORK_POLICY
NPH = xds.TYPE_NETWORK_POLICY_HOSTS


def wait(pred, timeout=10.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return bool(pred())


def test_type_urls_and_payload_shapes_match_reference():
    assert (xds.TYPE_LISTENER, NP, NPH) == (
        ref_xds.TYPE_LISTENER, ref_xds.TYPE_NETWORK_POLICY,
        ref_xds.TYPE_NETWORK_POLICY_HOSTS)
    rules = [{"port": 80, "rules": [{"http": [{"path": "/a"}]}]}]
    assert xds.network_policy_resource(3, 9, rules, []) == \
        ref_xds.network_policy_resource(3, 9, rules, [])
    ips = {"10.0.0.1/32": 256, "10.0.0.2/32": 256, "10.1.0.0/16": 300,
           "f00d::1/128": 256}
    assert xds.host_mapping_resources(ips) == \
        ref_xds.host_mapping_resources(ips)


def _cache_script(mod):
    """One sequence of cache operations; returns what each step saw."""
    cache = mod.Cache()
    seen = []
    a, b = cache.watch(NP, "a"), cache.watch(NP, "b")
    seen.append(a.next(timeout=0.01))              # nothing yet
    v1 = cache.set_resources(NP, {"1": {"policy": 1}})
    seen.append((v1, a.next(timeout=1).version, b.next(timeout=1).version))
    comp = cache.wait_for_acks(NP, v1)
    a.ack(v1)
    seen.append(comp.completed)                    # b has not ACKed
    seen.append(comp.wait(0.01))
    b.ack(v1)
    seen.append(comp.wait(1))
    v2 = cache.upsert(NP, "2", {"policy": 2})
    v3 = cache.delete(NP, "1")
    vr = a.next(timeout=1)
    seen.append((v2, v3, vr.version, sorted(vr.resources)))
    comp3 = cache.wait_for_acks(NP, v3)
    a.ack(v3)
    b.nack(v3, "bad")
    seen.append((comp3.wait(0.01), cache.nacks))
    cache.unwatch(b)                               # b vanished mid-barrier
    seen.append(comp3.wait(1))
    c = cache.watch(NP, "c")
    seen.append(cache.wait_for_acks(NP, v3).wait(0.01))  # c has not ACKed
    c.ack(v3)
    seen.append(cache.wait_for_acks(NP, v3).wait(0.01))
    seen.append((cache.get(NP).version, cache.get(NP).resources,
                 cache.get(NPH).version, cache._version_of(NPH)))
    return [s if not isinstance(s, (ref_xds.VersionedResources,
                                    xds.VersionedResources))
            else (s.version, s.resources) for s in seen]


def test_cache_versioning_and_barriers_match_reference():
    assert _cache_script(xds) == _cache_script(ref_xds)


# --------------------------------------------------------------- wire

@pytest.fixture()
def server():
    cache = xds.Cache()
    srv = wire.XDSWireServer(cache).start()
    clients = []
    srv.clients = clients
    try:
        yield srv
    finally:
        for c in clients:
            c.close()
        srv.shutdown()


def client_of(srv, name, handler, mod=wire, type_url=NP):
    c = mod.XDSWireClient(srv.port, client=name)
    srv.clients.append(c)
    c.subscribe(type_url, handler)
    return c


def test_push_ack_completes_the_barrier(server):
    applied = []
    client_of(server, "c1", lambda v, res: (applied.append((v, res)), True)[1])
    v = server.cache.set_resources(NP, {"1": {"policy": 7}})
    assert server.cache.wait_for_acks(NP, v).wait(5)
    assert applied[-1] == (v, {"1": {"policy": 7}})


def test_a_nack_is_recorded(server):
    def refuse(v, res):
        raise ValueError("cannot apply")

    client_of(server, "bad", refuse)
    v = server.cache.set_resources(NP, {"1": {}})
    assert wait(lambda: any(n[1] == "bad" and n[2] == v and
                            "cannot apply" in n[3]
                            for n in server.cache.nacks))


def test_a_slow_client_holds_the_barrier_until_it_acks(server):
    gate = threading.Event()
    client_of(server, "fast", lambda v, res: True)
    client_of(server, "slow", lambda v, res: gate.wait(30) or True)
    v = server.cache.set_resources(NP, {"1": {}})
    comp = server.cache.wait_for_acks(NP, v)
    try:
        assert not comp.wait(0.5), "barrier completed without the slow ACK"
    finally:
        gate.set()
    assert comp.wait(10)


def test_a_nacking_client_blocks_no_other(server):
    good = []
    client_of(server, "good", lambda v, res: (good.append(v), True)[1])
    client_of(server, "bad", lambda v, res: False)
    v = server.cache.set_resources(NP, {"1": {}})
    assert wait(lambda: v in good)
    assert wait(lambda: any(n[1] == "bad" and n[2] == v
                            for n in server.cache.nacks))
    v2 = server.cache.set_resources(NP, {"1": {}, "2": {}})
    assert wait(lambda: v2 in good)


def test_a_disconnect_mid_barrier_unblocks_the_push(server):
    release = threading.Event()
    client_of(server, "fast", lambda v, res: True)
    doomed = client_of(server, "doomed",
                       lambda v, res: release.wait(30) or True)
    v = server.cache.set_resources(NP, {"1": {}})
    comp = server.cache.wait_for_acks(NP, v)
    try:
        assert not comp.wait(0.3)
        doomed.close()            # the connection drops mid-barrier
        assert comp.wait(10), "barrier stranded on a dead client"
    finally:
        release.set()


@pytest.mark.parametrize("direction", ["jax-client-on-port-server",
                                       "port-client-on-jax-server"])
def test_wire_interoperates_with_the_reference(direction):
    """Frames are the reference's: a client of one package on a server
    of the other receives the same resources, and its ACKs complete
    the server's barrier."""
    if direction.startswith("jax-client"):
        cache, srv_mod, cl_mod = xds.Cache(), wire, ref_wire
    else:
        cache, srv_mod, cl_mod = ref_xds.Cache(), ref_wire, wire
    srv = srv_mod.XDSWireServer(cache).start()
    got = {NP: [], NPH: []}
    cl = None
    try:
        cl = cl_mod.XDSWireClient(srv.port, client="x")
        for t in (NP, NPH):
            cl.subscribe(t, lambda v, res, t=t: (got[t].append((v, res)),
                                                  True)[1])
        res = {"3:ingress:TCP:80": {"name": "3:ingress:TCP:80",
                                    "policy": 4, "proxy_port": 10001,
                                    "upstream": ["10.0.0.3", 80],
                                    "http_rules": [{"method": "GET",
                                                    "path": "/a.*",
                                                    "host": ""}]}}
        v = cache.set_resources(NP, res)
        hosts = xds.host_mapping_resources({"10.0.0.3/32": 256})
        vh = cache.set_resources(NPH, hosts)
        assert cache.wait_for_acks(NP, v).wait(5)
        assert cache.wait_for_acks(NPH, vh).wait(5)
        assert got[NP][-1] == (v, res) and got[NPH][-1] == (vh, hosts)
        v2 = cache.delete(NP, "3:ingress:TCP:80")
        assert cache.wait_for_acks(NP, v2).wait(5)
        assert got[NP][-1] == (v2, {})
    finally:
        if cl is not None:
            cl.close()
        srv.shutdown()


# ------------------------------------------------------ supervised child

class _Upstream(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _UpHandler)
        threading.Thread(target=self.serve_forever, args=(0.05,),
                         daemon=True).start()

    @property
    def port(self):
        return self.server_address[1]


class _UpHandler(socketserver.BaseRequestHandler):
    def handle(self):
        buf = b""
        while True:
            try:
                data = self.request.recv(65536)
            except OSError:
                return
            if not data:
                return
            buf += data
            while b"\r\n\r\n" in buf:
                _req, buf = buf.split(b"\r\n\r\n", 1)
                self.request.sendall(
                    b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n\r\nok")


def http_get(port, path, timeout=5.0):
    """The response to one GET, read to ``ok``, a deny or EOF."""
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    except OSError:
        return b""
    s.settimeout(timeout)
    buf = b""
    try:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: h\r\n"
                  f"Content-Length: 0\r\n\r\n".encode())
        while b"ok" not in buf and b"denied" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    except OSError:
        pass
    finally:
        s.close()
    return buf


def free_port():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def npds(upstream_port, proxy_port, path_re):
    return {"1": {"name": "1", "policy": 1, "proxy_port": proxy_port,
                  "upstream": ["127.0.0.1", upstream_port],
                  "http_rules": [{"method": "GET", "path": path_re}]}}


def gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_supervised_child_kill9_restart_resync_push():
    cache = xds.Cache()
    server = wire.XDSWireServer(cache).start()
    upstream = _Upstream()
    proxy_port = free_port()
    v1 = cache.set_resources(NP, npds(upstream.port, proxy_port,
                                      "/public/.*"))
    sup = ProxySupervisor(server.port, backoff_base=0.05, device="cpu")
    pids = []
    try:
        sup.start()
        pids.append(sup.pid)
        # the child applied v1 before it ACKed: enforced on live TCP
        assert cache.wait_for_acks(NP, v1).wait(15)
        assert b"200 OK" in http_get(proxy_port, "/public/a")
        assert b"403" in http_get(proxy_port, "/admin")
        os.kill(pids[0], signal.SIGKILL)
        assert wait(lambda: sup.pid not in (None, pids[0]) and sup.alive(),
                    15), "supervisor never restarted the child"
        pids.append(sup.pid)
        assert sup.restarts >= 1
        # the new child re-synced the current version
        assert wait(lambda: b"200 OK" in http_get(proxy_port, "/public/b"),
                    15)
        v2 = cache.set_resources(NP, npds(upstream.port, proxy_port,
                                          "/api/.*"))
        assert cache.wait_for_acks(NP, v2).wait(15)
        assert b"200 OK" in http_get(proxy_port, "/api/x")
        assert b"403" in http_get(proxy_port, "/public/a")
    finally:
        sup.shutdown()
        server.shutdown()
        upstream.shutdown()
        upstream.server_close()
    assert not sup.alive() and sup.pid is None
    assert wait(lambda: all(gone(p) for p in pids), 5), pids


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_the_child_refuses_cuda_without_a_card():
    """``--device`` defaults to the card; without one the child raises
    before it subscribes, and the supervisor's start raises."""
    cache = xds.Cache()
    server = wire.XDSWireServer(cache).start()
    sup = ProxySupervisor(server.port)
    try:
        assert sup.device == "cuda"
        with pytest.raises(RuntimeError, match="failed to start"):
            sup.start()
        assert sup.pid is None
    finally:
        sup.shutdown()
        server.shutdown()


# ------------------------------------------------------------- agent

def _agent_xds(pkg, state_dir):
    """One endpoint, one peer, one HTTP redirect; returns the NPDS and
    NPHDS resources a wire client receives, then removes the redirect
    and returns whether its push completed on the client's ACK."""
    if pkg == "port":
        from cilium_tpu_torch.daemon import Daemon
        from cilium_tpu_torch.ipcache.ipcache import SOURCE_KVSTORE
        from cilium_tpu_torch.labels import Labels
        from cilium_tpu_torch.policy.api import L7Rules, PortRuleHTTP
        from cilium_tpu_torch.policy.l4 import (L4Filter, L7DataMap,
                                                PARSER_TYPE_HTTP,
                                                WILDCARD_SELECTOR)
        from cilium_tpu_torch.utils.option import DaemonConfig
        d = Daemon(config=DaemonConfig(state_dir=state_dir), device="cpu")
        cl_mod = wire
    else:
        from cilium_tpu.daemon import Daemon
        from cilium_tpu.ipcache.ipcache import SOURCE_KVSTORE
        from cilium_tpu.labels import Labels
        from cilium_tpu.policy.api import L7Rules, PortRuleHTTP
        from cilium_tpu.policy.l4 import (L4Filter, L7DataMap,
                                          PARSER_TYPE_HTTP,
                                          WILDCARD_SELECTOR)
        from cilium_tpu.utils.option import DaemonConfig
        d = Daemon(config=DaemonConfig(state_dir=state_dir))
        cl_mod = ref_wire
    client = None
    try:
        server = d.serve_xds()
        assert d.serve_xds() is server
        d.endpoint_create(1, ipv4="10.77.0.2", labels=["k8s:app=xdsweb"])
        ident, _ = d.identity_allocator.allocate(
            Labels.from_model(["k8s:app=peer"]))
        d.ipcache.upsert("10.78.0.9", ident.id, SOURCE_KVSTORE)
        l7map = L7DataMap()
        l7map[WILDCARD_SELECTOR] = L7Rules(http=[
            PortRuleHTTP(method="GET", path="/v1/.*"),
            PortRuleHTTP(method="PUT", path="/v2/x", host="a\\.io")])
        flt = L4Filter(port=8080, protocol="TCP", u8proto=6,
                       l7_parser=PARSER_TYPE_HTTP, l7_rules_per_ep=l7map,
                       ingress=True)
        redir = d.proxy.create_or_update_redirect(flt, endpoint_id=1)
        got, hosts = {}, {}

        def apply(store, res):
            store.clear()
            store.update(res)
            return True

        client = cl_mod.XDSWireClient(server.port, client="test-proxy")
        client.subscribe(NP, lambda v, res: apply(got, res))
        client.subscribe(NPH, lambda v, res: apply(hosts, res))
        assert wait(lambda: redir.id in got)
        assert wait(lambda: any("10.78.0.9/32" in h["host_addresses"]
                                for h in hosts.values()))
        assert wait(lambda: any("10.77.0.2/32" in h["host_addresses"]
                                for h in hosts.values()))
        npds_res = dict(got)
        nphds_res = {tuple(h["host_addresses"]): h["policy"]
                     for h in hosts.values()}
        # the removal's push completes on this client's ACK
        d.proxy.remove_redirect(redir.id)
        v = d.xds_cache._version_of(NP)
        acked = d.xds_cache.wait_for_acks(NP, v).wait(10)
        removed = wait(lambda: redir.id not in got)
        return npds_res, nphds_res, redir.proxy_port, acked and removed
    finally:
        if client is not None:
            client.close()
        d.shutdown()


def test_agent_serves_the_reference_resources(tmp_path):
    ref = _agent_xds("jax", str(tmp_path / "jax"))
    mine = _agent_xds("port", str(tmp_path / "port"))
    assert mine == ref
    npds_res, nphds_res, proxy_port, done = mine
    (rid, res), = npds_res.items()
    assert res["proxy_port"] == proxy_port
    assert res["upstream"] == ["10.77.0.2", 8080]
    assert res["http_rules"] == [
        {"method": "GET", "path": "/v1/.*", "host": ""},
        {"method": "PUT", "path": "/v2/x", "host": "a\\.io"}]
    assert done
