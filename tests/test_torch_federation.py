"""The port's federated Hubble observer (``hubble/federation.py``)
against the JAX package's, on the CPU, and the federated answers of a
sharded agent.

Each observer scenario runs on both packages' ``ShardedObserver`` over
the same ``FakePlane`` script (a ``ShardedDatapath`` stand-in with
scripted per-shard flow tables, modes and dead shards, as in
``tests/test_federation.py``); what each observes (flows, drain
outcomes, shard statuses, stats, the merged answer) must be equal.  Then the acceptance journey on the
port's agent with ``dataplane_shards=2``: a shard kill plus a kvstore
flap yield one ordered flight-recorder timeline, and ``/flows``,
``/flows?shard=k``, ``/flows?federated=true`` and ``hubble observe
--shard`` answer with shard-attributed flows and the degraded shard
flagged fail-open.
"""

import io
import json
import sys
import time

import numpy as np
import pytest

from cilium_tpu.hubble.federation import ShardedObserver as RefObserver
from cilium_tpu.hubble.flow import FlowRecord as RefRecord
from cilium_tpu.hubble.relay import HubbleRelay as RefRelay
from cilium_tpu.monitor import MonitorHub as RefHub

from cilium_tpu_torch.hubble import ShardedObserver
from cilium_tpu_torch.hubble.flow import FlowRecord
from cilium_tpu_torch.hubble.relay import HubbleRelay
from cilium_tpu_torch.monitor import MonitorHub

REF = dict(Observer=RefObserver, Record=RefRecord, Hub=RefHub,
           Relay=RefRelay)
PORT = dict(Observer=ShardedObserver, Record=FlowRecord, Hub=MonitorHub,
            Relay=HubbleRelay)


class FakePlane:
    """Minimal ShardedDatapath stand-in: scripted per-shard flow-table
    snapshots, supervisor modes and unreadable shards."""

    def __init__(self, n_shards=2):
        self.n_shards = n_shards
        self.snaps = {k: [] for k in range(n_shards)}
        self.modes = {k: "ok" for k in range(n_shards)}
        self.dead = set()

    def shard_flow_snapshot(self, k, max_entries=4096):
        if k in self.dead:
            raise RuntimeError("device gone")
        return list(self.snaps[k])[:max_entries]

    def shard_flow_stats(self, k):
        return {"slots": 16, "occupied": len(self.snaps[k])}

    def flow_stats(self):
        return {"slots": 16 * self.n_shards,
                "occupied": sum(len(s) for s in self.snaps.values())}

    def shard_modes(self):
        return dict(self.modes)


def agg_row(src, dst, dport, event, packets, nbytes, ls=100):
    return {"src-identity": src, "dst-identity": dst, "dport": dport,
            "proto": 6, "event": event, "packets": packets,
            "bytes": nbytes, "last-seen": ls}


def on_both(scenario):
    """Run ``scenario(pkg)`` on the JAX package and the port; assert the
    observations equal and return them."""
    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    return port


# ------------------------------------------------------- observer scenarios

def test_monitor_events_route_by_owning_shard():
    def scenario(pkg):
        hub = pkg["Hub"]()
        obs = pkg["Observer"](node="n1", datapath=FakePlane(2))
        obs.attach_monitor(hub)
        hub.ingest_batch(np.array([-130, 0, 0, -130]),
                         np.array([0, 1, 2, 3]),
                         np.array([101, 102, 103, 104]),
                         np.array([80, 81, 82, 83]),
                         np.full(4, 6), np.full(4, 100))
        deadline = time.monotonic() + 5.0
        while len(obs.get_flows(limit=0)) < 4 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        out = [sorted((f["endpoint"], f["shard"], f["verdict"])
                      for f in obs.get_flows(limit=0)),
               sorted(f["endpoint"] for f in obs.get_flows(shard=1,
                                                           limit=0))]
        with pytest.raises(ValueError):
            obs.get_flows(shard=7)
        obs.close()
        return out
    out = on_both(scenario)
    assert out[0] == [(0, 0, "DROPPED"), (1, 1, "FORWARDED"),
                      (2, 0, "FORWARDED"), (3, 1, "DROPPED")]


def test_shared_cursor_merges_and_pages_forward():
    def scenario(pkg):
        obs = pkg["Observer"](node="n1", datapath=FakePlane(2))
        for i in range(6):
            obs.ingest(pkg["Record"](seq=0, timestamp=float(i), node="n1",
                                     verdict="FORWARDED", endpoint=i))
        return [obs.get_flows(limit=0), obs.last_seq,
                obs.get_flows(since=3, limit=2), obs.get_flows(limit=2)]
    flows, last, page, tail = on_both(scenario)
    assert [f["seq"] for f in flows] == list(range(1, 7)) and last == 6
    assert [f["seq"] for f in page] == [4, 5]
    assert [f["seq"] for f in tail] == [5, 6]


def test_drain_delta_accounting():
    def scenario(pkg):
        plane = FakePlane(2)
        obs = pkg["Observer"](node="n1", datapath=plane)
        plane.snaps[0] = [agg_row(201, 301, 80, 0, 5, 500)]
        plane.snaps[1] = [agg_row(202, 302, 443, -130, 3, 300)]
        out = [obs.drain(), obs.get_flows(limit=0), obs.drain()]
        plane.snaps[0] = [agg_row(201, 301, 80, 0, 9, 900)]
        # a counter that went backwards: a rebuilt table, re-emitted
        plane.snaps[1] = [agg_row(202, 302, 443, -130, 1, 100)]
        out += [obs.drain(), obs.get_flows(limit=0), obs.stats(),
                obs.aggregate_snapshot()]
        return out
    first, flows, again, moved, after, stats, snap = on_both(scenario)
    assert first["drained"] == 2 and again["drained"] == 0
    assert moved["drained"] == 2
    assert "+4 pkts" in after[-2]["summary"] or \
        "+4 pkts" in after[-1]["summary"]
    assert {r["shard"] for r in snap} == {0, 1}
    assert stats["federation"]["drains"] == 3


def test_drain_fail_open_breaker_per_shard():
    def scenario(pkg):
        plane = FakePlane(2)
        plane.snaps[0] = [agg_row(201, 301, 80, 0, 5, 500)]
        plane.dead.add(1)
        obs = pkg["Observer"](node="n1", datapath=plane)
        out = [obs.drain(), obs.drain(), obs.drain(),
               obs.shard_statuses()]
        plane.dead.clear()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if obs.drain()["shards"]["1"]["status"] == "ok":
                break
            time.sleep(0.05)
        out.append([(s["shard"], s["status"]) for s in
                    obs.shard_statuses()])
        return out
    d1, _d2, d3, statuses, healed = on_both(scenario)
    assert d1["shards"]["0"]["status"] == "ok"
    assert d1["shards"]["1"]["status"] == "error"
    assert d3["shards"]["1"]["status"] == "breaker-open"
    assert [s["status"] for s in statuses] == ["ok", "drain-degraded"]
    assert healed == [(0, "ok"), (1, "ok")]


@pytest.mark.parametrize("mode,status", [("degraded", "fail-static"),
                                         ("recovering", "recovering")])
def test_degraded_shard_flagged_fail_open(mode, status):
    def scenario(pkg):
        plane = FakePlane(2)
        plane.modes[1] = mode
        obs = pkg["Observer"](node="n1", datapath=plane)
        obs.ingest(pkg["Record"](seq=0, timestamp=1.0, node="n1",
                                 verdict="FORWARDED", endpoint=1))
        ans = obs.local_answer(limit=10)
        return [ans, obs.local_answer(limit=10, shard=0)]
    ans, only0 = on_both(scenario)
    assert ans["partial"] is True
    assert {s["shard"]: s["status"] for s in ans["shards"]} == \
        {0: "ok", 1: status}
    assert [f["shard"] for f in ans["flows"]] == [1]
    assert only0["flows"] == []


def test_stats_aggregate_across_shards():
    def scenario(pkg):
        plane = FakePlane(2)
        obs = pkg["Observer"](node="n1", datapath=plane)
        for k in (0, 1):
            obs.ingest(pkg["Record"](
                seq=0, timestamp=1.0, node="n1", verdict="DROPPED",
                drop_reason="Policy denied", endpoint=k,
                src_identity=200 + k))
        return obs.stats()
    st = on_both(scenario)
    assert st["store"]["ringed"] == 2
    assert set(st["per-shard"]) == {"0", "1"}


def test_relay_propagates_shard_statuses():
    def scenario(pkg):
        def local_fetch(query, since, limit):
            return {"flows": [{"seq": 1, "timestamp": 1.0,
                               "verdict": "FORWARDED", "shard": 1}],
                    "shards": [{"shard": 0, "status": "ok"},
                               {"shard": 1, "status": "fail-static"}]}
        out = pkg["Relay"](local_name="n1",
                           local_fetch=local_fetch).get_flows(limit=10)
        for node in out["nodes"]:
            node.pop("seconds", None)
        return out
    out = on_both(scenario)
    assert out["partial"] is True
    assert out["nodes"][0]["shards"][1]["status"] == "fail-static"


# ------------------------------------------------ the sharded agent journey

class FlakyKV:
    """A kvstore backend with a blackhole switch: while engaged, every
    operation raises."""

    def __init__(self, inner):
        self._inner = inner
        self.blackholed = False

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in ("get", "get_prefix", "list_prefix", "set", "delete",
                    "delete_prefix", "create_only", "create_if_exists",
                    "lock_path", "renew_lease"):
            def guarded(*a, **kw):
                if self.blackholed:
                    raise ConnectionError("kvstore blackholed")
                return attr(*a, **kw)
            return guarded
        return attr


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


def test_sharded_agent_shard_kill_plus_kvstore_flap():
    """On the port's agent with two shards: traffic on both shards
    drains into the federated stores; a fatal fault on one shard and a
    kvstore flap produce one ordered timeline; while degraded,
    ``/flows``, ``/flows?shard=k``, ``/flows?federated=true`` and
    ``hubble observe --shard`` carry shard-attributed flows with the
    victim flagged fail-static; after recovery the flags clear."""
    from cilium_tpu_torch.cli import Client
    from cilium_tpu_torch.cli import main as cli_main
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.daemon.rest import APIServer
    from cilium_tpu_torch.kvstore.memory import InMemoryBackend
    from cilium_tpu_torch.observability.events import (
        EVENT_DATAPLANE_DEGRADED, EVENT_DATAPLANE_FAIL_STATIC,
        EVENT_DATAPLANE_REBUILD, EVENT_DATAPLANE_RECOVERED,
        EVENT_DATAPLANE_TRIP, EVENT_KVSTORE_DEGRADED,
        EVENT_KVSTORE_RECONCILING, EVENT_KVSTORE_RECOVERED, recorder)
    from cilium_tpu_torch.policy.jsonio import rules_from_json
    from cilium_tpu_torch.utils.faultinject import DeviceFaultInjector
    from cilium_tpu_torch.utils.option import DaemonConfig

    flaky = FlakyKV(InMemoryBackend())
    cfg = DaemonConfig(
        state_dir="", drift_audit_interval_s=0, ct_checkpoint_interval_s=0,
        dataplane_shards=2, hubble_flow_slots=1 << 8,
        hubble_drain_interval_s=0, supervisor_failure_threshold=1,
        supervisor_reset_s=0.05, supervisor_watchdog_s=5.0,
        enable_kvstore_survival=True, kvstore_failure_threshold=1,
        kvstore_probe_interval_s=0.05)
    d = Daemon(config=cfg, kvstore_backend=flaky, device="cpu")
    server = APIServer(d).start()
    try:
        d.endpoint_create(1, ipv4="10.200.0.10", labels=["k8s:id=web"])
        d.endpoint_create(2, ipv4="10.200.0.11", labels=["k8s:id=db"])
        rev = d.policy_add(rules_from_json(json.dumps([{
            "endpointSelector": {"matchLabels": {"id": "db"}},
            "ingress": [{
                "fromEndpoints": [{"matchLabels": {"id": "web"}}],
                "toPorts": [{"ports": [{"port": "5432",
                                        "protocol": "TCP"}]}]}],
            "labels": ["k8s:policy=t"]}])))
        assert d.wait_for_policy_revision(rev, timeout=60)
        slot1 = d.endpoints.lookup(1).table_slot
        slot2 = d.endpoints.lookup(2).table_slot
        assert slot1 % 2 != slot2 % 2
        victim = slot2 % 2
        lane = d.datapath.serving()
        sup = lane.lanes[victim].supervisor
        web_ip = (10 << 24) | (200 << 16) | 10
        db_ip = (10 << 24) | (200 << 16) | 11

        def records(slots, dport, sport0):
            n = len(slots)
            return {"endpoint": np.asarray(slots, np.int32),
                    "saddr": np.full(n, web_ip, np.uint32).view(np.int32),
                    "daddr": np.full(n, db_ip, np.uint32).view(np.int32),
                    "sport": (sport0 + np.arange(n)).astype(np.int32),
                    "dport": np.full(n, dport, np.int32),
                    "proto": np.full(n, 6, np.int32),
                    "direction": np.zeros(n, np.int32),
                    "tcp_flags": np.full(n, 0x02, np.int32),
                    "is_fragment": np.zeros(n, np.int32),
                    "length": np.full(n, 256, np.int32)}

        t = lane.submit_records(records([slot1, slot2] * 8, 5432, 40000),
                                16)
        t.result(timeout=120)
        assert t.error is None
        sup.oracle.refresh()
        assert d.hubble.drain()["drained"] > 0
        assert {f["shard"] for f in d.hubble.get_flows(limit=0)} == {0, 1}
        seq0 = recorder.last_seq

        inj = DeviceFaultInjector()
        sup.install_fault_hook(inj)
        inj.fail_launch(times=1, fatal=True)
        t = lane.submit_records(records([slot2] * 8, 5432, 41000), 8)
        t.result(timeout=120)
        assert t.error is None
        assert sup.mode == "degraded"
        assert d.status()["dataplane"]["degraded-shards"] == [victim]

        c = Client(server.base_url)
        out = c.get("/flows?federated=true&n=500")
        assert out["partial"] is True
        shard_status = {s["shard"]: s["status"]
                        for s in out["nodes"][0]["shards"]}
        assert shard_status == {victim: "fail-static", 1 - victim: "ok"}
        assert {f.get("shard") for f in out["flows"]} >= {0, 1}
        local = c.get("/flows?n=500")
        assert local["partial"] is True
        assert {s["shard"]: s["status"] for s in local["shards"]} == \
            shard_status
        one = c.get(f"/flows?n=500&shard={victim}")
        assert one["flows"] and \
            {f["shard"] for f in one["flows"]} == {victim}
        buf = io.StringIO()
        old, sys.stdout = sys.stdout, buf
        try:
            rc = cli_main(["--api", server.base_url, "hubble", "observe",
                           "--shard", str(victim), "--json", "-n", "500"])
        finally:
            sys.stdout = old
        assert rc == 0
        rows = [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]
        assert rows and all(r["shard"] == victim for r in rows)

        # the CLI's status of the sharded agent renders as the JAX CLI
        # renders the same answer: geometry, the degraded shard, the
        # per-shard map fill
        from cilium_tpu.cli import main as ref_cli_main

        def status_lines(main):
            out = io.StringIO()
            old, sys.stdout = sys.stdout, out
            try:
                assert main(["--api", server.base_url, "status",
                             "--verbose"]) == 0
            finally:
                sys.stdout = old
            return [line for line in out.getvalue().splitlines()
                    if line.startswith(("Dataplane:", "Map[s"))]
        lines = status_lines(cli_main)
        assert lines == status_lines(ref_cli_main)
        assert "Dataplane:     sharded (dp=1, ep=2, 2 devices)" in lines
        assert any(f"shard(s) [{victim}]" in line for line in lines)
        assert any(line.startswith("Map[s1]") for line in lines)

        flaky.blackholed = True
        assert _wait(lambda: d._kv_guard.mode == "degraded")
        flaky.blackholed = False
        assert _wait(lambda: d._kv_guard.mode == "ok")

        inj.heal()

        def recovered():
            lane.submit_records(records([slot2] * 8, 5432, 42000),
                                8).result(timeout=120)
            return sup.mode == "ok"
        assert _wait(recovered)

        evs = recorder.events(since=seq0, limit=0)

        def first(typ, shard=None, **attrs):
            for e in evs:
                if e.type == typ and (shard is None or e.shard == shard) \
                        and all(e.attrs.get(k) == v
                                for k, v in attrs.items()):
                    return e.seq
            raise AssertionError(f"no {typ} in "
                                 f"{[(e.seq, e.type, e.shard) for e in evs]}")

        trip = first(EVENT_DATAPLANE_TRIP, shard=victim)
        degraded = first(EVENT_DATAPLANE_DEGRADED, shard=victim)
        static = first(EVENT_DATAPLANE_FAIL_STATIC, shard=victim)
        rebuild = first(EVENT_DATAPLANE_REBUILD, shard=victim, result="ok")
        back = first(EVENT_DATAPLANE_RECOVERED, shard=victim)
        assert trip < degraded < static < rebuild < back
        assert first(EVENT_KVSTORE_DEGRADED) < \
            first(EVENT_KVSTORE_RECONCILING) < first(EVENT_KVSTORE_RECOVERED)
        out = c.get("/flows?n=500")
        assert {s["status"] for s in out["shards"]} == {"ok"}
        assert d.status()["dataplane"]["status"] == "ok"
    finally:
        server.shutdown()
        d.shutdown()
