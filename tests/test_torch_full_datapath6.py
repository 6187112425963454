"""The v6 step and the fused flow table: the JAX ``Datapath`` vs the
port's, on the CPU.

Both engines get one small dual-stack state (``workloads.
v6_serving_state`` with its v4 half, proxy ports on some rules, a
256-slot flow table at the daemon's probe 8 and claim stripe 4) and one
sequence of calls that interleaves ``process``, ``process_packed`` and
``process6``, so the claim tick shared by the three entry points lands
its claiming calls on each.  After every call the verdicts, events,
identities, every NAT field, the counters, both CT snapshots (sentinel
included), every lane of the flow table and the provenance must be
equal bit for bit (tolerance 0).  Also: the ICMPv6/NDP responder's
cases, reply synthesis, GC, state carried between the packages, and
the flows-off step, which must be the step without flows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.compiler.lpm import ipv6_to_words as ref_words
from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.datapath import icmp6 as ref_icmp6
from cilium_tpu.datapath import lb as ref_lb

from cilium_tpu_torch import convert
from cilium_tpu_torch.compiler.lpm import ipv6_to_words
from cilium_tpu_torch.datapath import engine, events, icmp6
from cilium_tpu_torch.datapath.pipeline import PACKED_FIELDS
from cilium_tpu_torch.policy.mapstate import PolicyMapStateEntry
from cilium_tpu_torch.workloads import (PACKED6_FIELDS, POOL_CLIENTS,
                                        embed6, unpack6, v4_serving_packets,
                                        v6_serving_packets, v6_serving_state)

from test_torch_full_datapath import _load_ref as _load_ref4
from test_torch_full_datapath import _ref_states

CT_SLOTS = 1 << 10
FLOW_SLOTS = 256
BATCH = 1024
T0 = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def serving6():
    """A small dual-stack serving state whose every seventh rule
    redirects to a proxy port."""
    st = v6_serving_state(n_rules=100, n_endpoints=4, n_services=40,
                          n_prefilter=20, n_nodes=8)
    for state in st.v4.states:
        for k in list(state):
            if k.dest_port and k.identity % 7 == 0:
                state[k] = PolicyMapStateEntry(proxy_port=15000 +
                                               k.identity % 100)
    return st


def _load_ref(dp, st6):
    _load_ref4(dp, st6.v4)
    dp.load_ipcache6(st6.prefixes6)
    for s in st6.services6:
        dp.upsert_service6(ref_lb.Service6(
            vip=s.vip, port=s.port, proto=s.proto,
            backends=[ref_lb.Backend6(addr=b.addr, port=b.port)
                      for b in s.backends]))
    dp.prefilter.insert(st6.prefilter6)
    dp.set_router_ip6(st6.router6)
    dp.load_policy(_ref_states(st6.v4.states), revision=2,
                   ipcache_prefixes=st6.v4.prefixes)


def _pair(st6, provenance=True, flows=True):
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    _load_ref(ref, st6)
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    st6.v4.load(port)
    st6.load(port)
    for dp in (ref, port):
        if flows:
            dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=8,
                                       claim_every=4)
        if provenance:
            dp.enable_provenance()
    return ref, port


def _u32(x):
    return np.asarray(x).view(np.int32)


def assert_same(ref, port, outs_ref, outs_port):
    """Every output, then ``assert_same_state``, bit for bit."""
    for name, r, t in zip(("verdict", "event", "identity"), outs_ref[:3],
                          outs_port[:3]):
        np.testing.assert_array_equal(np.asarray(r), t.numpy(), name)
    for f in outs_ref[3]._fields:
        np.testing.assert_array_equal(np.asarray(getattr(outs_ref[3], f)),
                                      getattr(outs_port[3], f).numpy(),
                                      f"nat.{f}")
    assert_same_state(ref, port)


def assert_same_state(ref, port):
    """The counters, both CT tables, the flow table and the last
    provenance, bit for bit."""
    for f in ("packets", "bytes"):
        np.testing.assert_array_equal(_u32(getattr(ref.counters, f)),
                                      getattr(port.counters, f).numpy(), f)
    for fam, snap_ref, snap_port in zip(("ct", "ct6"), ref.snapshot_ct(),
                                        port.snapshot_ct()):
        for f in snap_ref:
            np.testing.assert_array_equal(snap_ref[f], snap_port[f],
                                          f"{fam}.{f}")
    if ref.flows is None:
        assert port.flows is None
    else:
        np.testing.assert_array_equal(np.asarray(ref.flows.state.keys),
                                      port.flows.state.keys.numpy(),
                                      "flows.keys")
        np.testing.assert_array_equal(
            _u32(ref.flows.state.counters),
            port.flows.state.counters.numpy(), "flows.counters")
        assert port._flow_tick == ref._flow_tick
    if ref.provenance_enabled:
        for f in ("match_slot", "tier"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref.last_provenance, f)),
                getattr(port.last_provenance, f).numpy(), f)


def _cols6(packed6):
    """{field: [B] or [B, 4]} columns of a packed v6 host batch."""
    cols, row = {}, 0
    for f, width in PACKED6_FIELDS:
        cols[f] = packed6[row:row + width].T.copy() if width > 1 \
            else packed6[row]
        row += width
    return cols


def _step(ref, port, kind, packed, now):
    if kind == "process6":
        outs_ref = ref.process6(ref_engine.make_full_batch6(
            **_cols6(packed)), now=now)
        outs_port = port.process6(unpack6(torch.as_tensor(packed)),
                                  now=now)
    elif kind == "process_packed":
        outs_ref = ref.process_packed(jnp.asarray(packed), now=now)
        outs_port = port.process_packed(torch.as_tensor(packed), now=now)
    else:
        cols = {f: packed[i] for i, f in enumerate(PACKED_FIELDS)}
        outs_ref = ref.process(ref_engine.make_full_batch(**cols), now=now)
        outs_port = port.process(engine.make_full_batch(**cols,
                                                        device="cpu"),
                                 now=now)
    assert_same(ref, port, outs_ref, outs_port)
    return outs_port


KINDS = ("process6", "process_packed", "process")


def test_dual_stack_sequence_with_flows_matches_reference(serving6):
    """Thirteen calls cycling the three entry points with flows on,
    provenance on for the first nine and off for the rest, a GC after
    the seventh; then both CT snapshots, the counters and the flow table
    carried from the reference into a fresh port engine, and one more
    call of each family on both."""
    ref, port = _pair(serving6)
    v4 = v4_serving_packets(serving6.v4, BATCH, n_flows=256)
    v6 = v6_serving_packets(serving6, BATCH, n_flows=256)
    seen6, tiers6, claims = set(), set(), {k: 0 for k in KINDS}
    for t in range(13):
        kind = KINDS[t % 3]
        now = T0 + t
        if t == 9:
            ref.disable_provenance()
            port.disable_provenance()
        claims[kind] += (port._flow_tick % 4 == 0)
        outs = _step(ref, port, kind, next(v6 if kind == "process6"
                                           else v4), now)
        if kind == "process6":
            seen6.update(outs[1].tolist())
            if t < 9:
                tiers6.update(port.last_provenance.tier.tolist())
            else:
                assert port.last_provenance is None
            assert int((outs[3].rev_nat != 0).sum()) > 0 or t < 3
        if t == 6:
            n = port.gc(now=now + 61)
            assert n == ref.gc(now=now + 61) and n > 0
            assert_same_state(ref, port)
    assert all(claims.values()), claims
    assert {events.TRACE_TO_LXC, events.TRACE_TO_PROXY,
            events.DROP_POLICY, events.DROP_PREFILTER,
            events.ICMP6_NS_REPLY, events.ICMP6_ECHO_REPLY,
            events.DROP_UNKNOWN_TARGET} <= seen6, seen6
    assert {events.TIER_PREFILTER, events.TIER_CT_ESTABLISHED,
            events.TIER_LB, events.TIER_DENY} <= tiers6
    stats = port.flow_stats()
    assert stats == ref.flow_stats()
    assert stats["occupied"] > FLOW_SLOTS // 2 and stats["lost"] > 0
    assert port.flow_snapshot() == ref.flow_snapshot()
    assert port.ct_entries() == ref.ct_entries() and \
        port.ct_entries()[1] > 0

    # carry the reference's state into a fresh port engine
    fresh = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    serving6.v4.load(fresh)
    serving6.load(fresh)
    fresh.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=8,
                                  claim_every=4)
    fresh.enable_provenance()
    fresh._flow_tick = ref._flow_tick
    fresh.flows.state = convert.flows_from_jax(
        np.asarray(ref.flows.state.keys),
        np.asarray(ref.flows.state.counters), device="cpu")
    fresh._counters = convert.counters_from_pack(np.asarray(ref._counters),
                                                 device="cpu")
    assert fresh.restore_ct_snapshots(*ref.snapshot_ct()) == \
        sum(ref.ct_entries())
    for kind in ("process6", "process_packed"):
        _step(ref, fresh, kind, next(v6 if kind == "process6" else v4),
              T0 + 20)
    back4, back6 = fresh.snapshot_ct()
    assert ref.restore_ct_snapshots(back4, back6) == sum(fresh.ct_entries())


def test_icmp6_responder_cases(serving6):
    """The ICMPv6/NDP cases of the reference's own tests in one batch:
    an NS for the router is answered (NA), an NS for another target
    drops, an echo to the router is answered, an echo to a peer and an
    NA go through policy (no ICMPv6 rule: drop), a prefiltered source's
    NS drops at the prefilter; answered rows create no CT entry and
    count in no policy counter.  Then a batch without the ICMPv6 fields,
    and the reply bytes."""
    ref, port = _pair(serving6, provenance=True, flows=False)
    router = serving6.router6
    client = embed6([POOL_CLIENTS + 1])[0]
    pf_net = serving6.prefilter6[0].split("/")[0]
    rows = [  # saddr, daddr, icmp_type, nd_target
        (client, "ff02::1:ff7f:ff01", 135, router),
        (client, "ff02::1:ff00:99", 135, "fd00::10.127.255.99"),
        (client, router, 128, "::"),
        (client, "fd00::10.0.0.1", 128, "::"),
        (client, "fd00::10.0.0.1", 136, "::"),
        (pf_net, "ff02::1:ff7f:ff01", 135, router),
    ]

    def words(a):
        return np.asarray(a if not isinstance(a, str)
                          else ipv6_to_words(a), np.int64)
    n = len(rows)
    cols = dict(endpoint=np.arange(n) % 4,
                saddr=np.stack([words(r[0]) for r in rows]),
                daddr=np.stack([words(r[1]) for r in rows]),
                sport=np.zeros(n), dport=np.zeros(n), proto=np.full(n, 58),
                direction=np.ones(n), icmp_type=[r[2] for r in rows],
                nd_target=np.stack([words(r[3]) for r in rows]))
    jcols = {k: (np.asarray(v).astype(np.uint32).view(np.int32)
                 if k in ("saddr", "daddr", "nd_target") else v)
             for k, v in cols.items()}
    outs_ref = ref.process6(ref_engine.make_full_batch6(**jcols), now=50)
    outs_port = port.process6(engine.make_full_batch6(**cols,
                                                      device="cpu"), now=50)
    assert_same(ref, port, outs_ref, outs_port)
    verdict, event = outs_port[0].tolist(), outs_port[1].tolist()
    assert event == [events.ICMP6_NS_REPLY, events.DROP_UNKNOWN_TARGET,
                     events.ICMP6_ECHO_REPLY, events.DROP_POLICY,
                     events.DROP_POLICY, events.DROP_PREFILTER]
    assert verdict[0] == verdict[2] == 0 and min(verdict[1], verdict[3],
                                                 verdict[5]) < 0
    assert port.ct_entries()[1] == 0
    assert int(port.counters.packets.sum()) == 0
    assert port.last_provenance.tier.tolist()[:3] == [events.TIER_LB] * 3

    # without icmp_type / nd_target the responder is out of the step
    plain = {k: v for k, v in cols.items()
             if k not in ("icmp_type", "nd_target")}
    jplain = {k: v for k, v in jcols.items()
              if k not in ("icmp_type", "nd_target")}
    outs_port = port.process6(engine.make_full_batch6(**plain,
                                                      device="cpu"), now=51)
    assert_same(ref, port, ref.process6(ref_engine.make_full_batch6(
        **jplain), now=51), outs_port)
    assert events.ICMP6_NS_REPLY not in outs_port[1].tolist()

    requester = "fd00::10.128.0.1"
    reply = port.icmp6_echo_reply_bytes(requester, ident=7, seq=9)
    assert reply == ref.icmp6_echo_reply_bytes(requester, ident=7, seq=9)
    parsed = icmp6.parse_icmp6(reply)
    assert parsed["checksum_ok"] and parsed["type"] == 129
    assert parsed["src_words"] == list(ipv6_to_words(router))
    assert (parsed["ident"], parsed["seq"]) == (7, 9)
    na = icmp6.ndisc_advertisement(ipv6_to_words(router),
                                   ipv6_to_words(requester),
                                   ipv6_to_words(router), b"\x02" * 6)
    assert na == ref_icmp6.ndisc_advertisement(
        ref_words(router), ref_words(requester), ref_words(router),
        b"\x02" * 6)
    assert icmp6.parse_icmp6(na)["tlla"] == b"\x02" * 6
    with pytest.raises(RuntimeError, match="router"):
        engine.Datapath(device="cpu").icmp6_echo_reply_bytes(requester)


def test_flows_off_is_the_step_without_flows(serving6):
    """An engine whose flow table was enabled and then disabled serves
    what one that never had it serves, and the flow tail changes no
    output, counter or CT entry of an engine that has it."""
    engines = []
    for mode in ("never", "on", "on-off"):
        dp = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
        serving6.v4.load(dp)
        serving6.load(dp)
        dp.enable_provenance()
        if mode != "never":
            dp.enable_flow_aggregation(slots=FLOW_SLOTS)
        if mode == "on-off":
            dp.disable_flow_aggregation()
            assert dp.flows is None and dp.flow_stats() is None and \
                dp.flow_snapshot() == []
        engines.append(dp)
    assert engines[0]._statics == engines[2]._statics
    assert engines[0]._statics6 == engines[2]._statics6
    v4 = v4_serving_packets(serving6.v4, BATCH, n_flows=256)
    v6 = v6_serving_packets(serving6, BATCH, n_flows=256)
    for t in range(4):
        kind = KINDS[t % 3]
        packed = next(v6 if kind == "process6" else v4)
        outs = []
        for dp in engines:
            if kind == "process6":
                out = dp.process6(unpack6(torch.as_tensor(packed)),
                                  now=T0 + t)
            else:
                out = dp.process_packed(torch.as_tensor(packed), now=T0 + t)
            outs.append(list(out[:3]) + list(out[3]) +
                        list(dp.counters) + [dp.ct.state, dp.ct6.state] +
                        list(dp.last_provenance))
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                assert torch.equal(a, b)
    assert engines[1].flow_stats()["occupied"] > 0
