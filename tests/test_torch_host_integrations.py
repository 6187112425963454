"""The host integrations: the JAX package's vs the port's.

``FunctionQueue``; the CNI plugin and the docker libnetwork driver over
HTTP against a CPU agent of each package; the docker runtime watcher
(``runtime_watch`` in the port, the container watchers of
``cilium_tpu/workloads.py`` in the reference) against a fake dockerd on
a unix socket (a copy of ``tests/test_docker_events.py``'s); bugtool's
archive members; the health prober's sweeps, its TCP probes and the
ICMPv6 probe through each package's ``process6``.  Each script runs on
both packages and the answers, endpoint ids, addresses, identities,
labels and IPAM claims must be equal.
"""

import json
import os
import shutil
import socketserver
import sys
import tarfile
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler

import pytest

from cilium_tpu import bugtool as ref_bugtool
from cilium_tpu import cni as ref_cni
from cilium_tpu import docker_plugin as ref_docker_plugin
from cilium_tpu import health as ref_health
from cilium_tpu import workloads as ref_runtime_watch
from cilium_tpu.cli import Client as RefClient
from cilium_tpu.daemon.rest import APIServer as RefAPIServer
from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.policy import mapstate as ref_mapstate
from cilium_tpu.utils import serializer as ref_serializer

from cilium_tpu_torch import (bugtool, cni, docker_plugin, health,
                              runtime_watch)
from cilium_tpu_torch.cli import Client
from cilium_tpu_torch.daemon.rest import APIServer
from cilium_tpu_torch.datapath import engine
from cilium_tpu_torch.policy import mapstate
from cilium_tpu_torch.utils import serializer

from test_torch_daemon import PORT as PORT_AGENT
from test_torch_daemon import REF as REF_AGENT
from test_torch_daemon import start_agent

WAIT_S = 30.0

REF = dict(serializer=ref_serializer, cni=ref_cni, bugtool=ref_bugtool,
           docker_plugin=ref_docker_plugin, health=ref_health,
           runtime_watch=ref_runtime_watch, Client=RefClient,
           APIServer=RefAPIServer, agent=REF_AGENT,
           datapath=lambda: ref_engine.Datapath(ct_slots=1 << 10),
           mapstate=ref_mapstate)
PORT = dict(serializer=serializer, cni=cni, bugtool=bugtool,
            docker_plugin=docker_plugin, health=health,
            runtime_watch=runtime_watch, Client=Client,
            APIServer=APIServer, agent=PORT_AGENT,
            datapath=lambda: engine.Datapath(ct_slots=1 << 10,
                                             device="cpu"),
            mapstate=mapstate)
PKGS = {"jax": REF, "port": PORT}


def _wait(fn, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


def both(fn):
    """fn(pkg) on each package; returns (reference's, port's)."""
    return fn(REF), fn(PORT)


# ------------------------------------------------------------ serializer

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_function_queue_order_retry_and_stop(pkg):
    fq = PKGS[pkg]["serializer"].FunctionQueue(name="t")
    out, calls, gave_up = [], [], []
    try:
        for i in range(100):
            fq.enqueue(lambda i=i: out.append(i))

        def fails():
            calls.append(1)
            raise RuntimeError("boom")

        # retried twice, then dropped; the queue runs on afterwards
        fq.enqueue(fails, lambda n: n <= 2)
        fq.enqueue(lambda: out.append("after"))
        assert fq.wait_idle(10)
        assert out == list(range(100)) + ["after"]
        assert len(calls) == 3
        # a stop without drain gives every queued item its give-up call
        gate = threading.Event()
        fq.enqueue(gate.wait)
        fq.enqueue(lambda: out.append("never"),
                   lambda n: gave_up.append(n) or False)
    finally:
        gate.set()
        fq.stop(drain=False)
    assert "never" not in out
    assert gave_up == [sys.maxsize]
    assert not fq._thread.is_alive()
    with pytest.raises(RuntimeError):
        fq.enqueue(lambda: None)


def test_function_queues_run_the_same_script_alike():
    """Concurrent producers, one consumer: never two functions at once,
    and the same retry counts and give-up calls in both packages."""
    def run(pkg):
        fq = pkg["serializer"].FunctionQueue()
        seen, active, overlap, waits = [], [], [], []

        def work(i):
            active.append(i)
            if len(active) > 1:
                overlap.append(i)
            if i % 17 == 0 and seen.count(i) < 2:
                seen.append(i)
                active.remove(i)
                raise RuntimeError(i)
            seen.append(i)
            active.remove(i)

        def wait_for(i):
            def wait(n):
                waits.append((i, n))
                return n <= 1
            return wait

        threads = [threading.Thread(target=lambda s=s: [
            fq.enqueue(lambda i=i: work(i), wait_for(i))
            for i in range(s * 40, s * 40 + 40)]) for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert fq.wait_idle(20)
        fq.stop()
        return overlap, sorted(seen), sorted(waits)
    ref, port = both(run)
    assert port == ref
    assert port[0] == []


# ------------------------------------------------------------------ agents

@pytest.fixture()
def served(tmp_path):
    """{package: (agent, its REST server's url)}, stopped at the end."""
    out, servers, agents = {}, [], []
    try:
        for name, pkg in PKGS.items():
            d = start_agent(pkg["agent"], str(tmp_path / name))
            agents.append(d)
            srv = pkg["APIServer"](d).start()
            servers.append(srv)
            out[name] = (d, srv.base_url)
        yield out
    finally:
        for srv in servers:
            srv.shutdown()
        for d in agents:
            d.shutdown()


def endpoint_models(d):
    return sorted((e.id, e.ipv4, e.container_name, e.security_identity,
                   tuple(str(l) for l in e.labels.to_array()))
                  for e in d.endpoints.endpoints())


def test_cni_add_del_and_idempotence(served):
    """CNI ADD (with an address, again, and one with labels only), DEL
    twice: the same results, endpoint ids, identities and IPAM claims
    from both agents."""
    out = {}
    for name, pkg in PKGS.items():
        d, url = served[name]
        c, m = pkg["Client"](url), pkg["cni"]
        steps = [
            m.cni_add(c, "container-xyz", netns="/proc/1/ns/net",
                      config={"ip": "10.200.0.42",
                              "labels": {"app": "db"}}),
            m.cni_add(c, "container-xyz", netns="/proc/1/ns/net",
                      config={"ip": "10.200.0.42",
                              "labels": {"app": "db"}}),
            m.cni_add(c, "container-abc", ifname="eth1",
                      config={"ip": "10.200.0.43",
                              "labels": {"app": "web", "tier": "f"}}),
        ]
        assert d.wait_for_policy_revision(timeout=WAIT_S)
        mid = (endpoint_models(d), sorted(d.ipam.allocated()))
        steps += [m.cni_del(c, "container-xyz"),
                  m.cni_del(c, "container-xyz"),
                  m._endpoint_id_for("container-abc")]
        out[name] = (steps, mid, endpoint_models(d),
                     sorted(d.ipam.allocated()))
    assert out["port"] == out["jax"]
    steps, mid, after, _ipam = out["port"]
    assert steps[0] == steps[1]
    assert steps[0]["ips"] == [{"version": "4",
                                "address": "10.200.0.42/32"}]
    assert steps[3] is True and steps[4] is False
    assert len(mid[0]) == 2 and len(after) == 1
    assert "10.200.0.42" in mid[1] and "10.200.0.42" not in _ipam


@pytest.mark.parametrize("command", ["VERSION", "ADD", "DEL", "BOGUS"])
def test_cni_main_speaks_the_spec(served, command, monkeypatch, capsys):
    """``cni.main`` reads CNI_* from the environment and prints the
    same result objects and exit codes in both packages."""
    import io
    out = {}
    for name, pkg in PKGS.items():
        _d, url = served[name]
        monkeypatch.setenv("CNI_COMMAND", command)
        monkeypatch.setenv("CNI_CONTAINERID", "ctr-main")
        monkeypatch.setenv("CILIUM_TPU_API", url)
        monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(
            {"ip": "10.200.0.77", "labels": {"app": "cni"}})))
        rc = pkg["cni"].main()
        out[name] = (rc, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["port"][0] == (1 if command == "BOGUS" else 0)


def _post(base, method, body=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"{base}/{method}", method="POST",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_docker_plugin_lifecycle_over_http(served):
    """Activate, capabilities, pools, RequestAddress, CreateEndpoint
    (twice), Join, Leave (twice), ReleaseAddress, the error paths: the
    same answers, endpoints and IPAM claims from both agents."""
    out = {}
    for name, pkg in PKGS.items():
        d, url = served[name]
        dp = pkg["docker_plugin"]
        driver = dp.LibnetworkDriver(pkg["Client"](url), wait_tries=2)
        ps = dp.PluginServer(driver).start()
        try:
            base = ps.base_url
            res = [_post(base, "Plugin.Activate"),
                   _post(base, "NetworkDriver.GetCapabilities"),
                   _post(base, "IpamDriver.GetDefaultAddressSpaces"),
                   _post(base, "IpamDriver.RequestPool", {"V6": False}),
                   _post(base, "IpamDriver.RequestPool", {"V6": True})]
            code, addr = _post(base, "IpamDriver.RequestAddress",
                               {"PoolID": "CiliumPoolv4"})
            res.append((code, addr))
            eid = "dockerep-0011223344556677"
            create = {"NetworkID": "net-1", "EndpointID": eid,
                      "Interface": {"Address": addr["Address"]}}
            res += [_post(base, "NetworkDriver.CreateEndpoint", create),
                    _post(base, "NetworkDriver.CreateEndpoint", create),
                    _post(base, "NetworkDriver.CreateEndpoint",
                          {"EndpointID": "x", "Interface": {}}),
                    _post(base, "NetworkDriver.Join",
                          {"EndpointID": eid})]
            assert d.wait_for_policy_revision(timeout=WAIT_S)
            joined = endpoint_models(d)
            res += [_post(base, "NetworkDriver.Join",
                          {"EndpointID": "nope"}),
                    _post(base, "NetworkDriver.Frobnicate"),
                    _post(base, "NetworkDriver.Leave", {"EndpointID": eid}),
                    _post(base, "NetworkDriver.Leave", {"EndpointID": eid}),
                    _post(base, "IpamDriver.ReleaseAddress",
                          {"Address": addr["Address"].split("/")[0]}),
                    _post(base, "IpamDriver.ReleaseAddress",
                          {"Address": addr["Address"].split("/")[0]})]
            out[name] = (res, joined, endpoint_models(d),
                         sorted(d.ipam.allocated()),
                         dp.endpoint_id_for(eid))
        finally:
            ps.shutdown()
    assert out["port"] == out["jax"]
    res, joined, after, ipam, ep_id = out["port"]
    assert [r[0] for r in res] == [200] * 7 + [400, 400, 200, 400, 400,
                                               200, 200, 200, 400]
    assert [e[0] for e in joined] == [ep_id] and after == []
    assert res[5][1]["Address"].split("/")[0] not in ipam


def test_docker_plugin_refuses_without_an_agent():
    for pkg in (REF, PORT):
        with pytest.raises(pkg["docker_plugin"].PluginError):
            pkg["docker_plugin"].LibnetworkDriver(
                pkg["Client"]("http://127.0.0.1:1"), wait_tries=2,
                wait_base_s=0.0)


# ---------------------------------------------------------- fake dockerd

class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _DockerdHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def address_string(self):
        return "unix"

    def do_GET(self):  # noqa: N802 — http.server contract
        dockerd = self.server.dockerd
        if self.path.startswith("/events"):
            self._stream_events(dockerd)
            return
        if self.path.startswith("/containers/json"):
            with dockerd._cond:
                out = [
                    {"Id": cid, "Names": [f"/{c['name']}"],
                     "Labels": dict(c["labels"]), "State": "running"}
                    for cid, c in dockerd.containers.items()]
            self._json(200, out)
            return
        if self.path.startswith("/containers/"):
            if dockerd.fail_inspect:
                self._json(500, {"message": "dockerd overloaded"})
                return
            cid = self.path.split("/")[2]
            with dockerd._cond:
                c = dockerd.containers.get(cid)
            if c is None:
                self._json(404, {"message": "no such container"})
                return
            self._json(200, {"Id": cid, "Name": f"/{c['name']}",
                             "Config": {"Labels": dict(c["labels"])},
                             "State": {"Running": True}})
            return
        self._json(404, {"message": f"unknown path {self.path}"})

    def _stream_events(self, dockerd) -> None:
        with dockerd._cond:
            cursor = len(dockerd.events)
            epoch = dockerd.epoch
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            while True:
                with dockerd._cond:
                    while cursor >= len(dockerd.events) and \
                            dockerd.epoch == epoch:
                        dockerd._cond.wait(timeout=0.5)
                    if dockerd.epoch != epoch:
                        break
                    batch = dockerd.events[cursor:]
                    cursor = len(dockerd.events)
                for ev in batch:
                    data = (json.dumps(ev) + "\n").encode()
                    self.wfile.write(b"%x\r\n" % len(data) + data +
                                     b"\r\n")
                    self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        self.close_connection = True

    def _json(self, code: int, obj) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class FakeDockerd:
    """Container store + /events stream over a unix socket;
    start_container / stop_container are the test's hands."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._cond = threading.Condition()
        self.containers = {}
        self.events = []
        self.epoch = 0  # bump = drop live event streams
        self.fail_inspect = False  # 500 every /containers/{id}/json
        srv = _UnixHTTPServer(socket_path, _DockerdHandler)
        srv.dockerd = self
        self._srv = srv
        self._thread = threading.Thread(target=srv.serve_forever,
                                        daemon=True, name="fake-dockerd")

    def start(self) -> "FakeDockerd":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        with self._cond:
            self.epoch += 1
            self._cond.notify_all()
        self._srv.shutdown()
        self._srv.server_close()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def start_container(self, cid: str, name: str, labels=None) -> None:
        with self._cond:
            self.containers[cid] = {"name": name,
                                    "labels": labels or {}}
            self.events.append({
                "Type": "container", "Action": "start",
                "Actor": {"ID": cid,
                          "Attributes": dict(labels or {})}})
            self._cond.notify_all()

    def stop_container(self, cid: str) -> None:
        with self._cond:
            self.containers.pop(cid, None)
            self.events.append({
                "Type": "container", "Action": "die",
                "Actor": {"ID": cid, "Attributes": {}}})
            self._cond.notify_all()

    def drop_streams(self) -> None:
        with self._cond:
            self.epoch += 1
            self._cond.notify_all()


@pytest.fixture()
def sock_dir():
    """A short directory for unix sockets (their paths are capped at
    about 100 bytes)."""
    path = tempfile.mkdtemp(prefix="dk")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def run_docker_script(pkg, d, socket_path):
    """Pre-existing container, start, start with inspect failing, a
    relabelled restart, die, and a death during a stream drop; the
    agent's endpoints after each stage."""
    rw = pkg["runtime_watch"]
    dockerd = FakeDockerd(socket_path).start()
    dockerd.start_container("cc" * 32, "old-1", {"app": "old"})
    sink = rw.WorkloadWatcher(d, ipam=d.ipam)
    w = rw.DockerEventWatcher(rw.DockerClient(socket_path), sink,
                              backoff_base=0.02, backoff_max=0.1)
    stages = []

    def stage(cond):
        # a stop releases the address just after the endpoint goes
        assert _wait(lambda: cond() and len(d.ipam.allocated()) ==
                     len(sink.containers()))
        assert d.wait_for_policy_revision(timeout=WAIT_S)
        stages.append((endpoint_models(d), sorted(d.ipam.allocated()),
                       sorted(sink.containers())))

    try:
        c = rw.DockerClient(socket_path)
        assert c.ping()
        listed = c.list_containers()
        w.start()
        assert w.synced.wait(WAIT_S)
        stage(lambda: sink.endpoint_of("cc" * 32) is not None)
        dockerd.start_container("bb" * 32, "web-1", {"app": "web"})
        stage(lambda: sink.endpoint_of("bb" * 32) is not None)
        dockerd.fail_inspect = True
        with dockerd._cond:
            dockerd.containers["ee" * 32] = {"name": "fb-1",
                                             "labels": {"app": "fb"}}
            dockerd.events.append({
                "Type": "container", "Action": "start",
                "Actor": {"ID": "ee" * 32,
                          "Attributes": {"name": "fb-1",
                                         "image": "nginx:1",
                                         "app": "fb"}}})
            dockerd._cond.notify_all()
        stage(lambda: sink.endpoint_of("ee" * 32) is not None)
        dockerd.fail_inspect = False
        dockerd.start_container("bb" * 32, "web-1",
                                {"app": "web", "tier": "gold"})
        stage(lambda: sink.events >= 4)
        dockerd.stop_container("bb" * 32)
        stage(lambda: sink.endpoint_of("bb" * 32) is None)
        resyncs = w.resyncs
        with dockerd._cond:
            dockerd.containers.pop("cc" * 32, None)  # no event
        dockerd.drop_streams()
        stage(lambda: w.resyncs > resyncs and
              sink.endpoint_of("cc" * 32) is None)
    finally:
        w.stop()
        dockerd.shutdown()
    assert not w._thread.is_alive()
    return listed, stages


def test_docker_event_watcher_drives_both_agents_alike(sock_dir,
                                                       tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        d = start_agent(pkg["agent"], str(tmp_path / name))
        try:
            out[name] = run_docker_script(
                pkg, d, os.path.join(sock_dir, f"{name}.sock"))
        finally:
            d.shutdown()
    assert out["port"] == out["jax"]
    listed, stages = out["port"]
    assert [c["Names"] for c in listed] == [["/old-1"]]
    assert [len(s[0]) for s in stages] == [1, 2, 3, 3, 2, 1]
    fallback = [e for e in stages[2][0] if e[2] == "fb-1"][0]
    assert "container:app=fb" in fallback[4]
    assert not any("image" in l for l in fallback[4])


def test_workload_watcher_lifecycle_alike(tmp_path):
    """The pluggable sink alone: create, relabel, stop, stop again."""
    def run(pkg):
        d = start_agent(pkg["agent"], str(tmp_path / str(id(pkg))))
        try:
            w = pkg["runtime_watch"].WorkloadWatcher(d, ipam=d.ipam)
            ep_id = w.on_start({"id": "abc123", "name": "web-1",
                                "labels": {"app": "web"}})
            assert d.wait_for_policy_revision(timeout=WAIT_S)
            first = endpoint_models(d)
            assert w.on_start({"id": "abc123", "name": "web-1",
                               "labels": {"app": "web",
                                          "tier": "frontend"}}) == ep_id
            assert d.wait_for_policy_revision(timeout=WAIT_S)
            second = endpoint_models(d)
            stopped = (w.on_stop("abc123"), w.on_stop("abc123"))
            return (ep_id, first, second, stopped, endpoint_models(d),
                    sorted(d.ipam.allocated()), len(w), w.events)
        finally:
            d.shutdown()
    ref, port = both(run)
    assert port == ref
    assert port[1][0][3] != port[2][0][3]  # relabel: new identity
    assert port[3] == (True, False) and port[4] == []


# ---------------------------------------------------------------- bugtool

def _members(path):
    with tarfile.open(path) as tar:
        return sorted(os.path.basename(m.name) for m in tar.getmembers())


def test_bugtool_archives_the_same_members(served, tmp_path):
    """``collect`` from the daemon and ``collect_remote`` over REST: the
    same member names (no collector failing), and the endpoint the
    agent serves inside."""
    out = {}
    for name, pkg in PKGS.items():
        d, url = served[name]
        d.endpoint_create(1, ipv4="10.200.0.5", labels=["k8s:a=b"])
        assert d.wait_for_policy_revision(timeout=WAIT_S)
        local = pkg["bugtool"].collect(d, str(tmp_path / f"{name}.tgz"))
        remote = pkg["bugtool"].collect_remote(
            pkg["Client"](url), str(tmp_path / f"{name}-r.tgz"))
        with tarfile.open(local) as tar:
            member = [m for m in tar.getmembers()
                      if m.name.endswith("endpoints.json")][0]
            eps = json.load(tar.extractfile(member))
        out[name] = (_members(local), _members(remote),
                     [e["id"] for e in eps])
    assert out["port"] == out["jax"]
    assert not [m for m in out["port"][0] + out["port"][1]
                if m.endswith(".failed")]
    assert "status.json" in out["port"][0] and \
        "metrics.txt" in out["port"][1]


def test_bugtool_default_path_follows_tmpdir(served, tmp_path,
                                             monkeypatch):
    """Without an output path the archive lands in the temporary
    directory, which follows TMPDIR."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    _d, url = served["port"]
    path = bugtool.collect_remote(Client(url))
    assert os.path.dirname(path) == str(tmp_path)
    assert "status.json" in _members(path)


# ----------------------------------------------------------------- health

def test_health_prober_sweeps_alike():
    """Sweeps over a changing node set with a probe that fails one
    node, then raises: the same status (clocks aside) each time."""
    def run(pkg):
        nodes = [("default/n1", "192.168.0.1"),
                 ("default/n2", "192.168.0.2"), ("default/n3", "")]
        down = {"192.168.0.2"}
        p = pkg["health"].HealthProber(
            lambda: list(nodes),
            probe_fn=lambda kind, ip: (ip not in down, 0.001),
            interval=3600)
        seen = []
        try:
            def sweep():
                p.probe_once()
                seen.append(({n: {k: v for k, v in st.items()
                                  if k != "last-probed"}
                              for n, st in p.status().items()},
                             sorted(p.unhealthy_nodes())))
            sweep()
            nodes.pop(1)
            sweep()

            def bad(kind, ip):
                raise OSError("no route")
            p.probe_fn = bad
            sweep()
        finally:
            p.shutdown()
        return seen
    ref, port = both(run)
    assert port == ref
    assert port[0][1] == ["default/n2"] and port[2][1] == ["default/n1"]


def test_tcp_probes_against_each_packages_responder():
    """Each package's TCP probe against each package's responder: up
    while it serves, down after it shuts down."""
    out = []
    for responder_pkg in (REF, PORT):
        responder = responder_pkg["health"].HealthResponder().start()
        try:
            probes = [pkg["health"].make_tcp_probe(
                lambda ip: responder.port, timeout=2.0)
                for pkg in (REF, PORT)]
            up = [(p("icmp", "127.0.0.1")[0], p("http", "127.0.0.1")[0])
                  for p in probes]
        finally:
            responder.shutdown()
        down = [(p("icmp", "127.0.0.1")[0], p("http", "127.0.0.1")[0])
                for p in probes]
        out.append((up, down))
    assert out == [([(True, True)] * 2, [(False, False)] * 2)] * 2


def test_icmp6_probe_through_each_packages_v6_step():
    """The ICMPv6 probe drives the target engine's ``process6``: the
    programmed router answers, another address of the engine does not,
    an address with no engine does not, v4 and HTTP pass through."""
    def run(pkg):
        dp = pkg["datapath"]()
        dp.load_policy([pkg["mapstate"].PolicyMapState()], revision=1)
        dp.set_router_ip6("fd00::1")
        other = pkg["datapath"]()
        other.load_policy([pkg["mapstate"].PolicyMapState()], revision=1)
        other.set_router_ip6("fd00::2:1")
        probe = pkg["health"].make_icmp6_probe(
            {"fd00::1": dp, "fd00::5": dp, "fd00::2:1": other},
            "fd00::99")
        res = [(ip, kind, probe(kind, ip)[0]) for ip, kind in (
            ("fd00::1", "icmp"), ("fd00::5", "icmp"),
            ("fd00::2:1", "icmp"), ("fd00::77", "icmp"),
            ("10.0.0.1", "icmp"), ("fd00::77", "http"))]
        prober = pkg["health"].HealthProber(
            lambda: [("c/a", "fd00::1"), ("c/b", "fd00::77"),
                     ("c/c", "fd00::2:1")], probe_fn=probe, interval=3600)
        try:
            prober.probe_once()
            return res, sorted(prober.unhealthy_nodes())
        finally:
            prober.shutdown()
    ref, port = both(run)
    assert port == ref
    assert [r[2] for r in port[0]] == [True, False, True, False, True,
                                       True]
    assert port[1] == ["c/b"]
