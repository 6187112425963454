"""The plain reference against the port at CPU sizes: each stage alone
on random queries, then whole runs of both cells through the harness."""

import time

import numpy as np
import pytest
import torch

from benchmark import generate as G
from benchmark import harness
from benchmark.conftest import TINY_STATE
from benchmark import compare
from benchmark.program import PortSystem
from benchmark.reference.conntrack import ConnTable
from benchmark.reference.flows import FlowTable
from benchmark.reference.lb import ServiceTable
from benchmark.reference.lpm import PrefixTable
from benchmark.reference.l7 import FastVerdicts, encode
from benchmark.reference.node import l7_programs
from benchmark.reference.policy import PolicyTable

from cilium_tpu_torch.compiler.lpm import compile_lpm
from cilium_tpu_torch.compiler.policy_tables import compile_endpoints
from cilium_tpu_torch.datapath import conntrack as port_ct
from cilium_tpu_torch.datapath import lb as port_lb
from cilium_tpu_torch.datapath.verdict import Counters, PacketBatch, \
    verdict_step
from cilium_tpu_torch.hubble import aggregation as port_flows
from cilium_tpu_torch.ops.lpm_ops import lpm_lookup
from cilium_tpu_torch.policy.mapstate import (PolicyKey, PolicyMapState,
                                              PolicyMapStateEntry)

N = 4096


@pytest.fixture(scope="module")
def node():
    return G.node_state(TINY_STATE, G.seeds_of(2 ** 31 + 77))


def _i32(x):
    return torch.as_tensor(np.asarray(x, np.int64).astype(np.uint32)
                           .view(np.int32))


def test_lpm_matches_port(node):
    rng = np.random.default_rng(1)
    inside = G._inside(rng, G.parse_prefixes(node.prefixes),
                       rng.integers(0, len(node.prefixes), N))
    addrs = _i32(np.concatenate([inside, rng.integers(0, 2 ** 32, N)]))
    for prefixes in (node.prefixes, {c: 1 for c in node.prefilter}):
        c = compile_lpm(prefixes)
        put = torch.as_tensor
        found, val = lpm_lookup(put(c.masks), put(c.key_a), put(c.key_b),
                                put(c.value), put(c.prefix_lens), addrs,
                                c.max_probe)
        rf, rv = PrefixTable(prefixes).lookup(addrs)
        assert torch.equal(found, rf) and torch.equal(val, rv)


def test_policy_matches_port(node):
    states = []
    for m in node.maps:
        st = PolicyMapState()
        for (i, p, pr, d), proxy in m.items():
            st[PolicyKey(identity=i, dest_port=p, nexthdr=pr,
                         direction=d)] = PolicyMapStateEntry(proxy)
        st[PolicyKey(identity=0, dest_port=53, nexthdr=17,
                     direction=1)] = PolicyMapStateEntry(15002)
        states.append(st)
    maps = [{(k.identity, k.dest_port, k.nexthdr, k.direction): v.proxy_port
             for k, v in st.items()} for st in states]
    comp = compile_endpoints(states, revision=1)
    rng = np.random.default_rng(2)
    keys = [k for m in maps for k in m]
    pick = rng.integers(0, len(keys), N)
    ident = np.array([keys[i][0] for i in pick])
    ident[::3] = rng.integers(0, 70000, len(ident[::3]))
    dport = np.array([keys[i][1] for i in pick])
    dport[::5] = 53
    batch = PacketBatch(
        endpoint=_i32(rng.integers(0, len(maps), N)), identity=_i32(ident),
        dport=_i32(dport), proto=_i32(np.where(dport == 53, 17, 6)),
        direction=_i32(rng.integers(0, 2, N) | (rng.random(N) < .7)),
        length=_i32(rng.integers(40, 1500, N)),
        is_fragment=_i32(rng.random(N) < 0.05))
    n = comp.num_endpoints * comp.slots
    counters = Counters(torch.zeros(n, dtype=torch.int32),
                        torch.zeros(n, dtype=torch.int32))
    put = torch.as_tensor
    verdict, counters = verdict_step(put(comp.key_id), put(comp.key_meta),
                                     put(comp.value), counters, batch,
                                     comp.max_probe)
    ref = PolicyTable(maps)
    rv, entry = ref.verdict(batch.endpoint, batch.identity, batch.dport,
                            batch.proto, batch.direction,
                            batch.is_fragment)
    assert torch.equal(verdict, rv)
    added = ref.count(entry, batch.length)
    meta = comp.key_meta.view(np.uint32).astype(np.int64)
    e, s = np.nonzero(meta)
    index = {tuple(k): i for i, k in enumerate(ref.keys.tolist())}
    for ep, slot in zip(e.tolist(), s.tolist()):
        m = int(meta[ep, slot])
        key = (ep, int(np.uint32(comp.key_id[ep, slot])), (m >> 16) & 0xFFFF,
               (m >> 8) & 0xFF, (m >> 1) & 1)
        flat = ep * comp.slots + slot
        assert int(counters.packets[flat]) == int(added[index[key], 0])
        assert int(counters.bytes[flat]) == int(added[index[key], 1])


def test_lb_matches_port(node):
    services = [port_lb.Service(vip=v, port=p, proto=pr,
                                backends=[port_lb.Backend(a, bp)
                                          for a, bp in b])
                for v, p, pr, b in node.services]
    balancer = port_lb.LoadBalancer(device="cpu")
    balancer.upsert_services(services)
    rng = np.random.default_rng(3)
    svc = rng.integers(0, len(node.services), N)
    daddr = np.array([node.services[i][0] for i in svc])
    dport = np.array([node.services[i][1] for i in svc])
    daddr[::4] = rng.integers(0, 2 ** 32, len(daddr[::4]))
    args = (_i32(daddr), _i32(dport), _i32(np.full(N, 6)),
            _i32(rng.integers(0, 2 ** 32, N)),
            _i32(rng.integers(1024, 65536, N)))
    d, p, rn, _ = port_lb.lb_step(balancer.compiled.tables, *args,
                                  max_probe=balancer.compiled.max_probe)
    ref = ServiceTable(node.services)
    rd, rp, rrn = ref.step(*args)
    assert torch.equal(d, rd) and torch.equal(p, rp) and \
        torch.equal(rn, rrn)
    back = port_lb.lb_rev_nat(balancer.compiled.tables, args[3], args[4], rn)
    assert all(torch.equal(a, b) for a, b in
               zip(back, ref.rev_nat(args[3], args[4], rrn)))


def test_l7_fast_verdict_matches_port():
    import json
    from benchmark.conftest import REPO
    from benchmark.program import l7_programs as port_programs
    from cilium_tpu_torch.datapath.pipeline import _l7_fast_stage
    cfg = json.loads(
        (REPO / "benchmark/configs/v4-node-10k-l7.json").read_text())
    traffic = json.loads(
        (REPO / "benchmark/traffic/pool-l7.json").read_text())
    w = cfg["l7"]["window"]
    strings = G.payload_strings(traffic["l7"], w) + [
        "GET\x00/public/\x00", "PUT\x00/admin/x\x00evil.com", "x.example.com",
        "db-.prod.local", "api.internal.svc.", "GET\x00/api/v12/users/\x00"]
    table = encode(strings, w)
    progs = port_programs(cfg["l7"], w)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, len(strings), N)
    payload = torch.as_tensor(table[rows])
    ports = np.array([0, 15001, 15002, 17000])
    proxy = ports[rng.integers(0, 4, N)]
    values = np.array([[0, 15001, 15002, 17000]], np.int32)

    class T:
        l7_prog = torch.as_tensor(progs.progs_for_values(values))
        l7_flat = torch.as_tensor(progs.flat)
        l7_map = torch.as_tensor(progs.cmap)
        l7_accept = torch.as_tensor(progs.accept)
        l7_starts = torch.as_tensor(progs.starts)
        l7_pmask = torch.as_tensor(progs.pmask)
    slot = torch.as_tensor(np.searchsorted(values[0], proxy)).to(torch.int32)
    pol = torch.as_tensor(proxy.astype(np.int32))
    v, allow, deny = _l7_fast_stage(T, payload, pol, slot, k=progs.k,
                                    c1=progs.c1)
    ra, rd = FastVerdicts(l7_programs(cfg["l7"])).decide(
        payload, pol, torch.as_tensor(proxy))
    assert torch.equal(allow, ra) and torch.equal(deny, rd)
    assert int(ra.sum()) > 0 and int(rd.sum()) > 0


def _ct_batch(rng, n, conns):
    """Rows over a few connections: forward and reply rows, SYN, ACK,
    FIN and RST, non-TCP rows, masks and repeated keys in one batch."""
    c = rng.integers(0, conns.shape[0], n)
    reply = rng.random(n) < 0.3
    a, b, sp, dp, pr = (conns[c, i] for i in range(5))
    flags = rng.choice([0x02, 0x10, 0x11, 0x04, 0x12], n,
                       p=[.2, .5, .15, .05, .1])
    return {"saddr": np.where(reply, b, a), "daddr": np.where(reply, a, b),
            "sport": np.where(reply, dp, sp), "dport": np.where(reply, sp, dp),
            "proto": pr, "direction": np.where(reply, 0, 1),
            "tcp_flags": np.where(pr == 6, flags, 0),
            "related": (rng.random(n) < 0.05).astype(np.int64),
            "create": rng.random(n) < 0.8, "update": rng.random(n) < 0.95,
            "rev_nat": rng.integers(0, 50, n),
            "proxy": np.where(rng.random(n) < 0.2, 15001, 0)}


@pytest.mark.parametrize("slots,probe", [(64, 4), (1024, 8)])
def test_conntrack_map_matches_port(slots, probe):
    """Steps, renewals, closes, expiry, collections and a table too small
    for its keys, compared key by key after every step."""
    rng = np.random.default_rng(slots)
    conns = np.stack([rng.integers(0, 2 ** 32, 300),
                      rng.integers(0, 2 ** 32, 300),
                      rng.integers(1024, 65536, 300),
                      rng.integers(1, 65536, 300),
                      rng.choice([6, 6, 17], 300)], axis=1)
    prog = port_ct.make_ct_state(slots, "cpu")
    ref = ConnTable(slots, probe)
    now = 1000
    for step in range(40):
        f = _ct_batch(rng, 256, conns)
        batch = port_ct.CTBatch(*(_i32(f[k]) for k in (
            "saddr", "daddr", "sport", "dport", "proto", "direction",
            "tcp_flags", "related")))
        t = torch.tensor(now, dtype=torch.int32)
        v, rn, px, prog = port_ct.ct_step(
            prog, batch, t, torch.as_tensor(f["create"]),
            torch.as_tensor(f["update"]), _i32(f["rev_nat"]),
            _i32(f["proxy"]), slots=slots, max_probe=probe)
        rv, rrn, rpx = ref.step(*batch, now, torch.as_tensor(f["create"]),
                                torch.as_tensor(f["update"]),
                                _i32(f["rev_nat"]), _i32(f["proxy"]))
        assert torch.equal(v.long(), rv) and torch.equal(rn.long(), rrn)
        assert torch.equal(px.long(), rpx)
        settled = now
        if step % 5 == 4:
            settled = now + 1
            prog, _ = port_ct.ct_gc(prog, torch.tensor(settled,
                                                      dtype=torch.int32))
            ref.forget(settled)
        mine = PortSystem.read_state(_snap(ct=prog))["ct"]
        assert compare._ct_mismatched(ref.entries(), mine, settled) == 0
        now += int(rng.integers(1, 30))
    assert ref.entries()["expires"].shape[0] > slots // 4


def _snap(ct=None, flows=None):
    ct = port_ct.make_ct_state(8, "cpu") if ct is None else ct
    flows = port_flows.make_flow_state(8, "cpu") if flows is None else flows
    return {"ct": ct, "flow_keys": flows.keys,
            "flow_counters": flows.counters,
            "counters": torch.zeros((2, 1), dtype=torch.int32)}


@pytest.mark.parametrize("slots,probe", [(32, 4), (256, 8)])
def test_flow_map_matches_port(slots, probe):
    """Births under a budget, races for places, a full table, striped
    last-seen, lost and update counts."""
    rng = np.random.default_rng(slots + 1)
    prog = port_flows.make_flow_state(slots, "cpu")
    ref = FlowTable(slots, probe)
    for step in range(30):
        n = 400
        src = _i32(rng.integers(256, 300, n))
        dst = _i32(rng.integers(60000, 60004, n))
        dport = _i32(rng.choice([53, 80, 443, 8080], n))
        proto = _i32(rng.choice([6, 17], n))
        event = _i32(rng.choice([0, 1, 4, -130, -133], n))
        length = _i32(rng.integers(64, 1500, n))
        budget = [0, 16, 64][step % 3]
        now = 2000 + step
        prog = port_flows.flow_update_step(
            prog, src, dst, dport, proto, event, length,
            torch.tensor(now, dtype=torch.int32), slots=slots,
            max_probe=probe, claim_budget=budget)
        ref.step(src, dst, dport, proto, event, length, now, budget)
        mine = PortSystem.read_state(_snap(flows=prog))["flows"]
        assert compare._flows_mismatched(ref.entries(), mine) == 0
    assert int(ref.entries()["lost"]) > 0


def test_map_comparison_counts_each_difference():
    rng = np.random.default_rng(9)
    ref = ConnTable(256, 8)
    f = _ct_batch(rng, 200, np.stack([rng.integers(0, 2 ** 32, 50)] * 2 +
                                     [rng.integers(1, 65536, 50)] * 2 +
                                     [np.full(50, 6)], axis=1))
    ref.step(*(_i32(f[k]) for k in ("saddr", "daddr", "sport", "dport",
                                    "proto", "direction", "tcp_flags",
                                    "related")), 100,
             torch.ones(200, dtype=torch.bool),
             torch.ones(200, dtype=torch.bool), _i32(f["rev_nat"]),
             _i32(f["proxy"]))
    a = ref.entries()
    assert compare._ct_mismatched(a, a, 100) == 0
    b = {k: v.clone() for k, v in a.items()}
    b["proxy_port"][0] += 1                     # a value differs
    assert compare._ct_mismatched(a, b, 100) == 1
    c = {k: v[1:] for k, v in a.items()}        # a key is missing
    assert compare._ct_mismatched(a, c, 100) == 1
    d = {k: torch.cat([v, v[:1]]) for k, v in a.items()}   # held twice
    assert compare._ct_mismatched(a, d, 100) == 1
    e = {k: v.clone() for k, v in a.items()}
    e["sport"][0] ^= 1                          # a key differs
    assert compare._ct_mismatched(a, e, 100) == 2


@pytest.mark.parametrize("cell", ["v4-node-10k.pool", "v4-node-10k-l7.pool"])
@pytest.mark.parametrize("trace", [False, True])
def test_harness_run_is_correct_on_cpu(tiny_tree, cell, trace):
    result, checks = harness.run_cell(tiny_tree, cell, 2 ** 31 + 5, 1.0,
                                      trace, torch.device("cpu"),
                                      time.perf_counter())
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert [c[1] for c in checks] == [0] * len(checks)
    assert list(result)[-1] == "checks"
    want = "dispatch_host_ms" if trace else "verdicts_per_s"
    assert want in result["metrics"]
