"""The agent's REST API and CLI: the JAX package's vs the port's.

Both agents serve their REST API on localhost, built from one seeded
rule set through the API itself (``PUT /endpoint/{id}``, ``PUT
/policy``), with the remote workloads entered as the kvstore watchers
enter them.  The same requests go to both, and the answers must be
equal, apart from the fields named in ``VOLATILE`` (times, durations)
and proxy ports (renamed by redirect id).  The same CLI commands run
against both, and their output must be equal.  ``/metrics`` is compared
by series name: the two packages keep separate registries.  The agent
command's host integrations (a fake apiserver, a fake dockerd), the
``cni``, ``docker-plugin`` and ``bugtool`` commands and the agent's
``--device`` default are checked last.
"""

import io
import json
import re
import socket
import sys
import urllib.request

import pytest
import torch

from cilium_tpu.cli import main as ref_cli_main
from cilium_tpu.daemon.rest import APIServer as RefAPIServer

from cilium_tpu_torch.cli import main as cli_main
from cilium_tpu_torch.daemon.rest import APIServer

from test_torch_daemon import (PORT, REF, add_peer, redirect_renames,
                               settle, shutdown_all, small_state,
                               start_agent)

# fields whose values are clocks or durations
VOLATILE = {"timestamp", "uptime-seconds", "last-run", "duration-s",
            "last-success", "last-failure"}


def scrub(obj):
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def call(base: str, method: str, path: str, body=None):
    """(HTTP status, decoded JSON or text) of one request."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            code, payload = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, payload = e.code, e.read()
    try:
        return code, json.loads(payload)
    except ValueError:
        return code, payload.decode()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(state, (ref daemon, ref url), (port daemon, port url)), built
    through the REST API."""
    st = small_state()
    base = tmp_path_factory.mktemp("served")
    agents, servers = [], []
    try:
        for name, pkg, server_cls in (("ref", REF, RefAPIServer),
                                      ("port", PORT, APIServer)):
            d = start_agent(pkg, str(base / name))
            agents.append(d)
            srv = server_cls(d).start()
            servers.append(srv)
            url = srv.base_url
            for ep_id, ip, labels in st.endpoints:
                code, _ = call(url, "PUT", f"/endpoint/{ep_id}",
                               {"ipv4": ip, "labels": list(labels)})
                assert code == 201
            for ip, labels in st.peers:
                add_peer(pkg, d, ip, labels)
            code, out = call(url, "PUT", "/policy",
                             st.rules_json.encode())
            assert code == 200
            assert settle(d, out["revision"])
        yield (st, (agents[0], servers[0].base_url),
               (agents[1], servers[1].base_url))
    finally:
        for srv in servers:
            srv.shutdown()
        shutdown_all(*agents)


def both(served, method, path, body=None):
    _st, (_r, ref_url), (_p, port_url) = served
    return (call(ref_url, method, path, body),
            call(port_url, method, path, body))


READS = ["/config", "/policy", "/endpoint", "/endpoint/1000",
         "/endpoint/1001/healthz", "/endpoint/1002/labels", "/identity",
         "/node", "/map", "/map/ipcache",
         "/map/lb", "/map/prefilter", "/map/ct", "/threat", "/analytics",
         "/flows", "/flows/stats", "/prefilter", "/service",
         "/monitor?kind=datapath"]


@pytest.mark.parametrize("path", READS)
def test_reads_match(served, path):
    ref, port = both(served, "GET", path)
    assert port[0] == ref[0] == 200
    assert scrub(port[1]) == scrub(ref[1])


def test_identity_by_labels_matches(served):
    st = served[0]
    query = "&".join(f"labels={l}" for l in st.endpoints[0][2])
    ref, port = both(served, "GET", f"/identity?{query}")
    assert port[0] == ref[0] == 200
    assert port[1] == ref[1]


ERRORS = [
    ("GET", "/endpoint/999", None, 404),
    ("DELETE", "/endpoint/999", None, 404),
    ("GET", "/endpoint/999/log", None, 404),
    ("PATCH", "/endpoint/999", {"labels": ["k8s:a=b"]}, 404),
    ("PATCH", "/endpoint/999/config", {"Policy": "false"}, 404),
    ("POST", "/endpoint/999/regenerate", None, 404),
    ("PATCH", "/endpoint/1000", {}, 400),
    ("PUT", "/endpoint/1000", {"ipv4": "10.128.0.2"}, 409),
    ("GET", "/identity/999999", None, 404),
    ("GET", "/identity?labels=k8s:nobody=here", None, 404),
    ("GET", "/service/77", None, 404),
    ("DELETE", "/service/77", None, 404),
    ("GET", "/map/nonsense", None, 404),
    ("GET", "/no/such/route", None, 404),
    ("PUT", "/policy", b"{not json", 400),
    ("POST", "/policy/trace", {}, 400),
    ("POST", "/policy/trace", {"endpoint": 999, "identity": 1}, 404),
    ("POST", "/ipam", {"family": "ipv7"}, 400),
    ("DELETE", "/ipam/1.2.3.4", None, 404),
    ("GET", "/kvstore/cilium/state", None, 503),
    ("PUT", "/kvstore/k", {"value": "v"}, 503),
    ("GET", "/flows?shard=1", None, 400),
    ("GET", "/analytics/top", None, 404),
    ("POST", "/threat/config", {"mode": "enforce"}, 404),
]


@pytest.mark.parametrize("method,path,body,code", ERRORS,
                         ids=[f"{m} {p} {c}" for m, p, _b, c in ERRORS])
def test_error_codes_match(served, method, path, body, code):
    ref, port = both(served, method, path, body)
    assert port[0] == ref[0] == code
    assert port[1] == ref[1]


def test_healthz_and_metrics_match(served):
    ref, port = both(served, "GET", "/healthz")
    assert port[0] == ref[0] == 200
    assert sorted(port[1]) == sorted(ref[1])
    for key in ("kvstore", "policy", "endpoints", "identities", "ipcache",
                "nodes", "proxy", "clustermesh", "datapath", "threat",
                "analytics", "version"):
        assert port[1][key] == ref[1][key], key
    ref, port = both(served, "GET", "/metrics")
    assert port[0] == ref[0] == 200

    def series(text):
        return set(re.findall(r"^# TYPE (\S+) ", text, re.M))

    want = {"cilium_tpu_endpoint_count", "cilium_tpu_endpoint_state",
            "cilium_tpu_identity_count", "cilium_tpu_policy_count",
            "cilium_tpu_policy_max_revision",
            "cilium_tpu_policy_regeneration_total",
            "cilium_tpu_proxy_redirects", "cilium_tpu_map_pressure",
            "cilium_tpu_controller_runs_total"}
    assert want <= series(port[1]) and want <= series(ref[1])


def test_policy_resolve_trace_and_audit_match(served):
    _st, (ref_d, _u), (port_d, _v) = served
    body = {"from": ["k8s:app=a0"], "to": ["k8s:app=a1"], "dports": [80],
            "verbose": True}
    ref, port = both(served, "POST", "/policy/resolve", body)
    assert port == ref
    rename = redirect_renames(ref_d, port_d)
    ident = port_d.endpoints.lookup(1001).security_identity
    for dport in (0, 80, 443):
        body = {"endpoint": 1000, "identity": ident, "dport": dport,
                "direction": "ingress"}
        ref, port = both(served, "POST", "/policy/trace", body)
        assert port[0] == ref[0] == 200
        assert port[1]["drift"] is ref[1]["drift"] is False
        assert port[1]["device"]["tier"] == ref[1]["device"]["tier"]
        v = ref[1]["device"]["verdict"]
        assert port[1]["device"]["verdict"] == rename.get(v, v)
    ref, port = both(served, "POST", "/debug/drift-audit")
    assert port[1]["status"] == ref[1]["status"] == "ok"
    assert port[1]["divergences"] == ref[1]["divergences"] == []


def test_writes_match(served):
    """Services, prefilter, IPAM, labels, regeneration and policy
    deletion through the API."""
    _st, (ref_d, _u), (port_d, _v) = served
    steps = [
        ("PUT", "/service", {"vip": "10.96.0.10", "port": 53, "proto": 17,
                             "backends": [{"ip": "10.128.0.2",
                                           "port": 5353}]}),
        ("PUT", "/service", {"vip": "fd00::10", "port": 443,
                             "backends": [{"ip": "fd00::2",
                                           "port": 8443}]}),
        ("GET", "/service", None),
        ("GET", "/service/1", None),
        ("GET", "/service/1000001", None),
        ("DELETE", "/service/1000001", None),
        ("DELETE", "/service", {"vip": "10.96.0.10", "port": 53,
                                "proto": 17}),
        ("DELETE", "/service", {"vip": "10.96.0.10", "port": 53,
                                "proto": 17}),
        ("PATCH", "/prefilter", {"cidrs": ["192.0.2.0/24"]}),
        ("DELETE", "/prefilter", {"cidrs": ["192.0.2.0/24"]}),
        ("GET", "/prefilter", None),
        ("POST", "/ipam", {"owner": "docker"}),
        ("POST", "/ipam", {"family": "ipv6"}),
        ("PUT", "/endpoint/2000", {"ipv4": "10.200.0.9",
                                   "labels": ["k8s:app=a1"]}),
        ("PUT", "/endpoint/2001", {"ipv4": "10.200.0.9",
                                   "labels": ["k8s:app=a2"]}),
        ("PATCH", "/endpoint/2000", {"labels": ["k8s:app=a2"]}),
        ("GET", "/endpoint/2000/labels", None),
        ("DELETE", "/policy?labels=k8s:rule=r5", None),
        ("POST", "/endpoint/1003/regenerate", None),
    ]
    for method, path, body in steps:
        ref, port = both(served, method, path, body)
        assert port[0] == ref[0], (method, path, ref, port)
        assert scrub(port[1]) == scrub(ref[1]), (method, path)
    assert settle(ref_d) and settle(port_d)
    ref, port = both(served, "POST", "/policy/wait", {"timeout": 30})
    assert port == ref and port[1]["realized"] is True
    for path in ("/endpoint", "/identity", "/map/ipcache", "/map/lb6"):
        ref, port = both(served, "GET", path)
        assert scrub(port[1]) == scrub(ref[1]), path
    ref, port = both(served, "DELETE", "/endpoint/2000")
    assert port == ref


def run_cli(main, url, *argv):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        try:
            rc = main(["--api", url, *argv])
        except SystemExit as e:
            rc = ("exit", str(e))
    finally:
        sys.stdout, sys.stderr = old
    return rc, out.getvalue(), err.getvalue()


CLI = [("policy", "get"), ("endpoint", "list"), ("endpoint", "get", "1000"),
       ("endpoint", "healthz", "1001"), ("identity", "list"),
       ("identity", "get", "1"), ("service", "list"),
       ("prefilter", "list"), ("map", "list"), ("map", "get", "ipcache"),
       ("node",), ("config",), ("kvstore", "get", "cilium/state"),
       ("policy", "trace", "--src", "k8s:app=a0", "--dst", "k8s:app=a1",
        "--dport", "80"),
       ("policy", "trace", "--replay", "--endpoint", "1000",
        "--identity", "2", "--dport", "0", "--direction", "ingress"),
       ("policy", "wait"), ("monitor", "--type", "datapath"),
       ("hubble", "observe"), ("endpoint", "regenerate", "999")]


@pytest.mark.parametrize("argv", CLI, ids=[" ".join(a) for a in CLI])
def test_cli_output_matches(served, argv):
    _st, (_r, ref_url), (_p, port_url) = served
    ref = run_cli(ref_cli_main, ref_url, *argv)
    port = run_cli(cli_main, port_url, *argv)
    assert port == ref


def test_cli_status_matches(served):
    """``status`` apart from its transport line (process-wide breaker
    registries); both exit 0."""
    _st, (_r, ref_url), (_p, port_url) = served
    outs = []
    for main, url in ((ref_cli_main, ref_url), (cli_main, port_url)):
        rc, out, _err = run_cli(main, url, "status")
        assert rc == 0
        outs.append([ln for ln in out.splitlines()
                     if not ln.startswith("Transports:")])
    assert outs[0] == outs[1]
    assert any(ln.startswith("Endpoints:") for ln in outs[1])


def test_cli_local_commands_match(tmp_path):
    """migrate-state and cleanup work on a state directory alone."""
    for name, main in (("ref", ref_cli_main), ("port", cli_main)):
        d = tmp_path / name
        d.mkdir()
        (d / "ep_7.json").write_text(json.dumps(
            {"id": 7, "ipv4": "10.9.0.7", "labels": ["k8s:app=old"],
             "state": "ready", "policy_revision": 3, "identity": 1234,
             "realized": {"1234:80:6:0": 0}}))
        (d / "ct_state.npz").write_bytes(b"")
    outs = []
    for name, main in (("ref", ref_cli_main), ("port", cli_main)):
        d = str(tmp_path / name)
        res = [run_cli(main, "http://127.0.0.1:1", "migrate-state", d),
               run_cli(main, "http://127.0.0.1:1", "cleanup",
                       "--state-dir", d),
               run_cli(main, "http://127.0.0.1:1", "cleanup", "-f",
                       "--state-dir", d)]
        outs.append([(rc, out.replace(d, "<dir>"), e.replace(d, "<dir>"))
                     for rc, out, e in res])
    assert outs[0] == outs[1]


# ------------------------------------------------------------ the agent

def _agent_url(capsys) -> str:
    out = capsys.readouterr().out
    return re.search(r"api=(http://\S+)", out).group(1)


def test_agent_refuses_later_slices(capsys, monkeypatch):
    """Its name is kept from when it checked the refusals of the
    slices not yet ported; with the host integrations ported it checks
    the opposite: nothing is refused.  ``agent --k8s-api-server`` against
    a fake apiserver and ``--docker-socket`` against a fake dockerd
    start on the CPU, take a CNP, a pod and a container into the agent
    and stop every thread they started; ``cni``, ``docker-plugin`` and
    ``bugtool`` run against an agent."""
    import shutil
    import tarfile
    import tempfile
    import threading
    import types

    import cilium_tpu_torch.cli as cli_mod
    from cilium_tpu_torch import docker_plugin as dp_mod
    from cilium_tpu_torch.k8s.fake_apiserver import FakeAPIServer
    from test_torch_host_integrations import FakeDockerd

    def wait_for(fn, timeout=30.0):
        import time as _time
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if fn():
                return True
            _time.sleep(0.05)
        return fn()

    def run_agent(extra, serving):
        """The agent with ``extra`` flags; ``serving(url)`` runs where
        the agent would sleep, then the agent is interrupted."""
        checked = []

        def sleep(_s):
            checked.append(serving(_agent_url(capsys)))
            raise KeyboardInterrupt

        monkeypatch.setattr(cli_mod, "time", types.SimpleNamespace(
            sleep=sleep))
        before = {t.ident for t in threading.enumerate()}
        assert cli_main(["agent", "--device", "cpu", "--api-port", "0",
                         "--state-dir", ""] + extra) == 0
        assert checked == [True]
        assert wait_for(lambda: not [
            t.name for t in threading.enumerate()
            if t.ident not in before and t.name.startswith(
                ("reflector-", "serializer-", "cnp-status",
                 "docker-events"))])

    fake = FakeAPIServer().start()
    sock_dir = tempfile.mkdtemp(prefix="dk")
    dockerd = FakeDockerd(sock_dir + "/d.sock").start()
    try:
        fake.upsert("ciliumnetworkpolicies", {
            "metadata": {"name": "web", "namespace": "prod"},
            "spec": {"endpointSelector": {"matchLabels": {"app": "web"}},
                     "ingress": [{"fromEndpoints": [
                         {"matchLabels": {"app": "client"}}]}]}})
        fake.upsert("pods", {
            "metadata": {"name": "p", "namespace": "prod"}, "spec": {},
            "status": {"podIP": "10.30.0.9", "hostIP": "192.168.0.9"}})
        run_agent(["--k8s-api-server", fake.base_url], lambda url: wait_for(
            lambda: len(call(url, "GET", "/policy")[1]["policy"]) == 1 and
            "10.30.0.9/32" in json.dumps(call(url, "GET",
                                              "/map/ipcache")[1])))
        dockerd.start_container("ab" * 32, "web-1", {"app": "web"})
        run_agent(["--docker-socket", dockerd.socket_path],
                  lambda url: wait_for(lambda: [
                      e["container-name"] for e in
                      call(url, "GET", "/endpoint")[1]] == ["web-1"]))
    finally:
        dockerd.shutdown()
        shutil.rmtree(sock_dir, ignore_errors=True)
        fake.shutdown()
    monkeypatch.undo()

    # the front-end commands against a running agent
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.utils.option import DaemonConfig
    d = Daemon(config=DaemonConfig(state_dir=""), device="cpu")
    srv = APIServer(d).start()
    try:
        for var in ("CNI_COMMAND", "CNI_CONTAINERID", "CILIUM_TPU_API"):
            monkeypatch.setenv(var, "")
        monkeypatch.delenv("CILIUM_TPU_API")
        monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(
            {"ip": "10.200.0.50", "labels": {"app": "cni"}})))
        rc, out, _ = run_cli(cli_main, srv.base_url, "cni", "add",
                             "--container-id", "ctr-1")
        assert rc == 0
        assert json.loads(out)["ips"][0]["address"] == "10.200.0.50/32"
        assert [e.ipv4 for e in d.endpoints.endpoints()] == ["10.200.0.50"]
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        assert run_cli(cli_main, srv.base_url, "cni", "del",
                       "--container-id", "ctr-1")[0] == 0
        assert d.endpoints.endpoints() == []
        rc, out, _ = run_cli(cli_main, srv.base_url, "cni", "version")
        assert rc == 0 and json.loads(out)["cniVersion"] == "0.3.1"

        with tempfile.TemporaryDirectory() as tmp:
            rc, out, _ = run_cli(cli_main, srv.base_url, "bugtool", "-o",
                                 f"{tmp}/b.tgz")
            assert rc == 0 and out.strip() == \
                f"Archive written: {tmp}/b.tgz"
            with tarfile.open(f"{tmp}/b.tgz") as tar:
                assert any(m.name.endswith("/status.json")
                           for m in tar.getmembers())

        activated = []

        def plugin_sleep(_s):
            import urllib.request as ur
            url = re.search(r"ready on (http://\S+)",
                            sys.stdout.getvalue()).group(1)
            req = ur.Request(url + "/Plugin.Activate", data=b"{}",
                             method="POST")
            with ur.urlopen(req, timeout=10) as resp:
                activated.append(json.loads(resp.read()))
            raise KeyboardInterrupt

        monkeypatch.setattr(dp_mod, "time", types.SimpleNamespace(
            sleep=plugin_sleep))
        rc, _out, _ = run_cli(cli_main, srv.base_url, "docker-plugin",
                              "--listen-port", "0")
        assert rc == 0
        assert activated == [{"Implements": ["NetworkDriver",
                                             "IpamDriver"]}]
    finally:
        srv.shutdown()
        d.shutdown()


def test_agent_defaults_to_the_card():
    """Without ``--device`` the agent asks for ``cuda``; this box has
    none, so it raises before serving anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["agent", "--api-port", "0"])


def test_agent_stops_when_the_verdict_service_cannot_start():
    """``--verdict-port`` on a port already bound: the agent exits with
    the error instead of serving without the verdict service."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        port = taken.getsockname()[1]
        with pytest.raises(SystemExit, match="verdict service failed"):
            cli_main(["agent", "--device", "cpu", "--api-port", "0",
                      "--verdict-port", str(port)])


@pytest.mark.parametrize("stop", ["interrupt", "verdict-service"])
def test_agent_leaves_no_closed_store_client_behind(stop, monkeypatch):
    """``agent --kvstore in-memory``: the agent's shutdown closes the
    store client ``setup_client`` made, and the command then drops the
    process-global reference, so ``get_client()`` never hands out a
    closed client after the agent stops, whether it was interrupted or
    stopped because its verdict service could not start."""
    import types

    import cilium_tpu_torch.cli as cli_mod
    from cilium_tpu_torch.kvstore.backend import get_client

    def interrupted(_s):
        raise KeyboardInterrupt

    argv = ["agent", "--device", "cpu", "--api-port", "0",
            "--kvstore", "in-memory"]
    with socket.socket() as taken:
        if stop == "interrupt":
            monkeypatch.setattr(cli_mod, "time", types.SimpleNamespace(
                sleep=interrupted))
            assert cli_main(argv) == 0
        else:
            taken.bind(("127.0.0.1", 0))
            taken.listen(1)
            with pytest.raises(SystemExit, match="verdict service"):
                cli_main(argv + ["--verdict-port",
                                 str(taken.getsockname()[1])])
    with pytest.raises(RuntimeError, match="not configured"):
        get_client()
