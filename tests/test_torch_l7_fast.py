"""On-device L7 fast verdicts, the optional stages together, and the
steps with every stage off: the JAX package vs the port, on the CPU, at
tolerance 0.

- The host builders array for array: ``build_fast_programs``,
  ``compile_l7_classification``, ``classify``, ``encode_payloads``.
- ``_l7_fast_stage`` alone on payloads with absent, truncated (-2) and
  mid-row negative bytes.
- Both family steps through ``Datapath`` with the stage on (the bench's
  two redirects on a small serving state, ``workloads.l7_serving_*``),
  flows and provenance on; the rows decided inline agree with the port's
  HTTP and DNS policy engines.
- All three stages on together, v4 and v6.
- With every stage off, and after each stage is enabled and disabled
  again, a step gives the outputs of a never-enabled engine and
  dispatches the same sequence of aten operations (recorded with
  ``TorchDispatchMode``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cilium_tpu.compiler import policy_tables as ref_policy_tables
from cilium_tpu.datapath import engine as ref_engine
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.l7 import fast as ref_fast
from cilium_tpu.policy import api as ref_api

from cilium_tpu_torch import convert
from cilium_tpu_torch.compiler.policy_tables import compile_l7_classification
from cilium_tpu_torch.datapath import engine, events, pipeline
from cilium_tpu_torch.l7 import fast
from cilium_tpu_torch.l7.dns import DNSPolicyEngine
from cilium_tpu_torch.l7.http import HTTPPolicyEngine, HTTPRequest
from cilium_tpu_torch.policy.api import PortRuleHTTP
from cilium_tpu_torch.workloads import (FQDN_SELECTORS, HTTP_METHODS,
                                        HTTP_PATHS, HTTP_RULES, L7_DNS_NAMES,
                                        L7_DNS_PORT, L7_HTTP_PORT,
                                        l7_fast_programs,
                                        l7_serving_packets,
                                        l7_serving_packets6,
                                        l7_serving_state, unpack6,
                                        v4_serving_state, v6_of)

from test_torch_full_datapath import _load_ref as _load_ref4
from test_torch_full_datapath6 import _cols6
from test_torch_full_datapath6 import _load_ref as _load_ref6
from test_torch_full_datapath6 import assert_same
from test_torch_threat import DRY_CFG, _models, assert_same_threat

WINDOW = 64
CT_SLOTS = 1 << 10
FLOW_SLOTS = 256
BATCH = 512
T0 = 1_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_programs(window):
    """The reference's fused programs of the bench's rules."""
    rules = [ref_api.PortRuleHTTP(method=r.method, path=r.path,
                                  host=r.host) for r in HTTP_RULES]
    sels = [ref_api.FQDNSelector(match_name=s.match_name,
                                 match_pattern=s.match_pattern)
            for s in FQDN_SELECTORS]
    return ref_fast.build_fast_programs(
        [ref_fast.FastProgramSpec(port=L7_HTTP_PORT,
                                  protocol=ref_fast.FAST_HTTP,
                                  patterns=tuple(
                                      ref_fast.classify_http(rules))),
         ref_fast.FastProgramSpec(port=L7_DNS_PORT,
                                  protocol=ref_fast.FAST_DNS,
                                  patterns=tuple(
                                      ref_fast.classify_dns(sels)))],
        window=window)


@pytest.fixture(scope="module")
def l7state():
    """A small serving state with the bench's two redirects on every
    endpoint; its programs are the reference's, carried by ``convert``."""
    st = l7_serving_state(v4_serving_state(
        n_rules=100, n_endpoints=4, n_services=40, n_prefilter=20,
        n_nodes=8), window=WINDOW)
    st.programs = convert.l7_programs_from_jax(_ref_programs(WINDOW))
    return st


@pytest.mark.parametrize("window", [32, 64])
def test_host_builders_equal_reference(window):
    """``build_fast_programs`` (two programs, and one), the slot
    classification, ``classify`` and ``encode_payloads`` give the
    reference's arrays."""
    ref = _ref_programs(window)
    got = l7_fast_programs(window)
    for f in ("flat", "cmap", "accept", "starts", "pmask"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f), f)
    assert (got.k, got.c1, got.window, got.states, got.port_to_prog,
            got.protocols) == (ref.k, ref.c1, ref.window, ref.states,
                               ref.port_to_prog, ref.protocols)
    assert got.describe() == ref.describe()
    one = fast.build_fast_programs([fast.FastProgramSpec(
        9, fast.FAST_DNS, tuple(fast.classify_dns(FQDN_SELECTORS)))],
        window=window)
    ref_one = ref_fast.build_fast_programs([ref_fast.FastProgramSpec(
        9, ref_fast.FAST_DNS, tuple(one.specs[0].patterns))],
        window=window)
    for f in ("flat", "cmap", "accept", "starts", "pmask"):
        np.testing.assert_array_equal(getattr(ref_one, f),
                                      getattr(one, f), f)
    rng = np.random.default_rng(window)
    values = rng.choice([0, 0, L7_HTTP_PORT, L7_DNS_PORT, 9, 15999],
                        (7, 33)).astype(np.int32)
    np.testing.assert_array_equal(
        compile_l7_classification(values, got.port_to_prog),
        ref_policy_tables.compile_l7_classification(values,
                                                    ref.port_to_prog))
    np.testing.assert_array_equal(got.progs_for_values(values),
                                  ref.progs_for_values(values))
    assert fast.classify("http", []) is None
    assert fast.classify("kafka", HTTP_RULES) is None
    assert fast.classify("http", [PortRuleHTTP(
        method="GET", headers=("X-Token abc",))]) is None
    assert fast.classify("http", HTTP_RULES) == ref_fast.classify(
        "http", [ref_api.PortRuleHTTP(method=r.method, path=r.path,
                                      host=r.host) for r in HTTP_RULES])
    strings = [fast.http_match_string(m, p, "Admin.Example.com")
               for m in HTTP_METHODS for p in HTTP_PATHS] + \
        [fast.dns_match_string(n + ".") for n in L7_DNS_NAMES] + \
        [None, "x" * (window + 1), "", "é" * (window // 2)]
    np.testing.assert_array_equal(fast.encode_payloads(strings, window),
                                  ref_fast.encode_payloads(strings,
                                                           window))


def _payloads(rng, table, b, window):
    """Rows of ``table`` with absent and truncated rows, random bytes,
    and negative bytes in the middle of some rows."""
    out = table[rng.integers(0, table.shape[0], b)].copy()
    noise = rng.random(b) < 0.1
    out[noise] = rng.integers(-2, 256, (int(noise.sum()), window))
    mid = rng.random(b) < 0.1
    out[mid, window // 2] = rng.choice([-1, -2], int(mid.sum()))
    return out.astype(np.int32)


@pytest.mark.parametrize("window", [32, 64])
def test_l7_fast_stage_matches_reference(l7state, window):
    """``_l7_fast_stage`` alone on 4,096 rows: redirect, allow, drop and
    miss verdicts over slots with and without a program (and -1 slots),
    against the reference: verdict, fast-allow and fast-deny."""
    ref_progs = _ref_programs(window)
    progs = convert.l7_programs_from_jax(ref_progs)
    rng = np.random.default_rng(window + 1)
    values = rng.choice([0, L7_HTTP_PORT, L7_DNS_PORT, 15999],
                        (4, 64)).astype(np.int32)
    b = 4096
    table = fast.encode_payloads(
        [fast.http_match_string(m, p, "admin.example.com")
         for m in HTTP_METHODS for p in HTTP_PATHS] +
        [fast.dns_match_string(n) for n in L7_DNS_NAMES] +
        [None, "y" * (window + 3)], window)
    payload = _payloads(rng, table, b, window)
    slot = rng.integers(-1, values.size, b).astype(np.int32)
    flat_v = values.reshape(-1)
    verdict = np.where(slot >= 0, flat_v[np.maximum(slot, 0)],
                       -1).astype(np.int32)
    verdict[rng.random(b) < 0.05] = -2
    names = ("l7_prog", "l7_flat", "l7_map", "l7_accept", "l7_starts",
             "l7_pmask")
    host = (progs.progs_for_values(values), progs.flat, progs.cmap,
            progs.accept, progs.starts, progs.pmask)
    ref_t = ref_pipeline.FullTables(
        datapath=None, lb=None, pf_masks=None, pf_key_a=None,
        pf_key_b=None, pf_value=None, pf_plens=None,
        **{n: jnp.asarray(a) for n, a in zip(names, host)})
    port_t = pipeline.FullTables(
        datapath=None, lb=None, pf_masks=None, pf_key_a=None,
        pf_key_b=None, pf_value=None, pf_plens=None,
        **{n: torch.as_tensor(a) for n, a in zip(names, host)})
    want = ref_pipeline._l7_fast_stage(ref_t, jnp.asarray(payload),
                                       jnp.asarray(verdict),
                                       jnp.asarray(slot), k=progs.k,
                                       c1=progs.c1)
    got = pipeline._l7_fast_stage(port_t, torch.as_tensor(payload),
                                  torch.as_tensor(verdict),
                                  torch.as_tensor(slot), k=progs.k,
                                  c1=progs.c1)
    for name, w, g in zip(("verdict", "fast_allow", "fast_deny"), want,
                          got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), name)
    assert got[1].any() and got[2].any()
    assert (got[0].numpy() == L7_HTTP_PORT).any()


def _l7_pair(st, threat=None, analytics=False, family6=False):
    """(reference, port) engines over ``st`` with the L7 stage, flows
    and provenance on, and optionally threat (``threat`` a config) and
    analytics."""
    ref = ref_engine.Datapath(ct_slots=CT_SLOTS)
    ref.telemetry_enabled = False
    port = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
    if family6:
        st6 = v6_of(st.v4)
        _load_ref6(ref, st6)
        st6.v4.load(port)
        st6.load(port)
    else:
        _load_ref4(ref, st.v4)
        st.v4.load(port)
    ref_m, port_m = _models(threat) if threat is not None else (None, None)
    for dp, progs, m in ((ref, _ref_programs(WINDOW), ref_m),
                         (port, st.programs, port_m)):
        dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=8,
                                   claim_every=1)
        dp.enable_provenance()
        dp.enable_l7_fast(progs)
        if m is not None:
            dp.enable_threat(m, buckets=64, window_s=8, stripe=4)
        if analytics:
            dp.enable_analytics(width=256, depth=2, lanes=4, stripe=4)
    return ref, port


def _serve_l7(ref, port, kind, packed, payload, now):
    pl = torch.as_tensor(payload)
    if kind == "process6":
        return (ref.process6(ref_engine.make_full_batch6(**_cols6(packed)),
                             now=now, payload=jnp.asarray(payload)),
                port.process6(unpack6(torch.as_tensor(packed)), now=now,
                              payload=pl))
    if kind == "process":
        cols = {f: packed[i] for i, f in
                enumerate(pipeline.PACKED_FIELDS)}
        return (ref.process(ref_engine.make_full_batch(**cols), now=now,
                            payload=jnp.asarray(payload)),
                port.process(engine.make_full_batch(**cols, device="cpu"),
                             now=now, payload=pl))
    return (ref.process_packed(jnp.asarray(packed), now=now,
                               payload=jnp.asarray(payload)),
            port.process_packed(torch.as_tensor(packed), now=now,
                                payload=pl))


def _engine_oracle(st, idx, fast_allow, fast_deny):
    """Rows decided inline against the port's HTTP / DNS policy engines
    on their payload strings; returns the rows checked."""
    rows = np.flatnonzero(fast_allow | fast_deny)
    http = HTTPPolicyEngine(list(HTTP_RULES), device="cpu")
    dns = DNSPolicyEngine(list(FQDN_SELECTORS), device="cpu")
    for r in rows:
        s = st.strings[idx[r]]
        if idx[r] < st.n_http:
            m, p, h = s.split("\x00")
            want = bool(http.check([HTTPRequest(method=m, path=p,
                                                host=h)])[0])
        else:
            want = bool(dns.allowed([s])[0])
        assert want == bool(fast_allow[r]), (r, s)
    return rows.shape[0]


@pytest.mark.parametrize("kind", ["process_packed", "process", "process6"])
def test_steps_with_l7_fast_match_reference(l7state, kind):
    """Three steps with the L7 stage, flows and provenance on: every
    output, CT, flow lane and tier equal the reference's; rows decided
    inline agree with the policy engines; absent and truncated payloads
    keep their redirect; a fast-denied row is DROP_POLICY_L7."""
    family6 = kind == "process6"
    ref, port = _l7_pair(l7state, family6=family6)
    stream = l7_serving_packets6(l7state, BATCH, n_flows=512) \
        if family6 else l7_serving_packets(l7state, BATCH, n_flows=512)
    table = l7state.table
    seen = {"allow": 0, "deny": 0, "redirect": 0, "oracle": 0}
    for t in range(3):
        packed, idx = next(stream)
        outs = _serve_l7(ref, port, kind, packed, table[idx], T0 + t)
        assert_same(ref, port, *outs)
        tier = port.last_provenance.tier.numpy()
        v, e = outs[1][0].numpy(), outs[1][1].numpy()
        fa = tier == events.TIER_L7_FAST_ALLOW
        fd = tier == events.TIER_L7_FAST_DENY
        assert (v[fd] == -3).all() and (e[fd] == events.DROP_POLICY_L7).all()
        assert (v[fa] == 0).all()
        bad = (idx == l7state.overlong_row) | (idx == l7state.absent_row)
        assert not (fa | fd)[bad].any()
        seen["allow"] += int(fa.sum())
        seen["deny"] += int(fd.sum())
        seen["redirect"] += int(np.isin(v, [L7_HTTP_PORT,
                                            L7_DNS_PORT]).sum())
        seen["oracle"] += _engine_oracle(l7state, idx, fa, fd)
    assert min(seen.values()) > 0, seen
    assert port.l7_fast_window() == WINDOW
    assert port.l7_fast_report() == ref.l7_fast_report()
    proto_of, ref_proto_of = port.l7_fast_protocol_of(), \
        ref.l7_fast_protocol_of()
    slots = port.last_provenance.match_slot.numpy()
    assert [proto_of(s) for s in slots] == [ref_proto_of(s) for s in slots]
    with pytest.raises(ValueError, match="payload"):
        port.process_packed(torch.as_tensor(packed), now=T0 + 9,
                            payload=torch.zeros((BATCH, WINDOW + 1),
                                                dtype=torch.int32))


@pytest.mark.parametrize("family", ["v4", "v6"])
def test_all_stages_together_match_reference(l7state, family):
    """L7 fast, threat (enforce, a dry bucket) and analytics on at once
    with flows and provenance, three steps, payloads on; then a step
    without a payload (absent: every L7 flow redirects).  Every output,
    the threat and analytics state equal the reference's."""
    family6 = family == "v6"
    ref, port = _l7_pair(l7state, threat=dict(
        DRY_CFG, redirect_score=200, redirect_port=15003),
        analytics=True, family6=family6)
    kind = "process6" if family6 else "process_packed"
    stream = l7_serving_packets6(l7state, BATCH, n_flows=512) \
        if family6 else l7_serving_packets(l7state, BATCH, n_flows=512)
    for t in range(4):
        packed, idx = next(stream)
        if t < 3:
            outs = _serve_l7(ref, port, kind, packed, l7state.table[idx],
                             T0 + t)
        elif family6:
            outs = (ref.process6(ref_engine.make_full_batch6(
                **_cols6(packed)), now=T0 + t),
                port.process6(unpack6(torch.as_tensor(packed)),
                              now=T0 + t))
        else:
            outs = (ref.process_packed(jnp.asarray(packed), now=T0 + t),
                    port.process_packed(torch.as_tensor(packed),
                                        now=T0 + t))
        assert_same(ref, port, *outs)
        assert_same_threat(ref, port)
        np.testing.assert_array_equal(np.asarray(ref.analytics_state.state),
                                      port.analytics_state.state.numpy())
    tier = port.last_provenance.tier
    assert not ((tier == events.TIER_L7_FAST_ALLOW) |
                (tier == events.TIER_L7_FAST_DENY)).any()


class _AtenLog(TorchDispatchMode):
    """The aten operations dispatched inside the mode, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["v4", "v6"])
def test_steps_with_stages_off_are_unchanged(l7state, family):
    """A never-enabled engine, and engines on which each stage (and all
    three) was enabled and then disabled again: two steps each give the
    same outputs, CT and flow state, and dispatch the same sequence of
    aten operations."""
    st6 = v6_of(l7state.v4)

    def make(toggle):
        dp = engine.Datapath(ct_slots=CT_SLOTS, device="cpu")
        st6.v4.load(dp)
        st6.load(dp)
        dp.enable_flow_aggregation(slots=FLOW_SLOTS, max_probe=8,
                                   claim_every=1)
        dp.enable_provenance()
        if toggle in ("l7", "all"):
            dp.enable_l7_fast(l7state.programs)
        if toggle in ("threat", "all"):
            dp.enable_threat(_models(DRY_CFG)[1], buckets=64)
        if toggle in ("analytics", "all"):
            dp.enable_analytics(width=256)
        dp.disable_l7_fast()
        dp.disable_threat()
        dp.disable_analytics()
        return dp

    stream = l7_serving_packets6(l7state, 512, n_flows=256) \
        if family == "v6" else l7_serving_packets(l7state, 512,
                                                  n_flows=256)
    batches = [next(stream) for _ in range(2)]
    runs = {}
    for toggle in ("never", "l7", "threat", "analytics", "all"):
        dp = make(toggle)
        assert dp._statics == make("never")._statics
        logs, outs = [], []
        for t, (packed, idx) in enumerate(batches):
            x = torch.as_tensor(packed)
            pl = torch.as_tensor(l7state.table[idx])
            with _AtenLog() as log:
                if family == "v6":
                    out = dp.process6(unpack6(x), now=T0 + t, payload=pl)
                else:
                    out = dp.process_packed(x, now=T0 + t, payload=pl)
            logs.append(log.ops)
            outs.append(out)
        runs[toggle] = (dp, logs, outs)
    base_dp, base_logs, base_outs = runs.pop("never")
    assert len(base_logs[0]) > 100
    for toggle, (dp, logs, outs) in runs.items():
        assert logs == base_logs, toggle
        for a, b in zip(outs, base_outs):
            for x, y in zip(a[:3], b[:3]):
                assert torch.equal(x, y), toggle
        assert torch.equal(dp.ct6.state if family == "v6" else dp.ct.state,
                           base_dp.ct6.state if family == "v6"
                           else base_dp.ct.state)
        assert torch.equal(dp.flows.state.keys, base_dp.flows.state.keys)
        assert torch.equal(dp.last_provenance.tier,
                           base_dp.last_provenance.tier)
        assert dp.last_threat is None and dp.analytics_state is None


def test_table_manager_row_write_follows_l7_programs(l7state):
    """In table-manager mode a row sync that adds a redirect to a
    program's port is a row write (no rebuild) that also writes the
    row's program ids, as the reference's delta apply does; the next
    step decides that endpoint's flows inline like the reference."""
    from cilium_tpu.endpoint import tables as ref_tables
    from cilium_tpu_torch.endpoint.tables import DeviceTableManager
    from cilium_tpu_torch.policy.mapstate import (INGRESS, PolicyKey,
                                                  PolicyMapState,
                                                  PolicyMapStateEntry)
    from test_torch_full_datapath import _ref_states

    states = l7state.v4.states
    base = [PolicyMapState({k: v for k, v in st.items()
                            if v.proxy_port == 0}) for st in states]
    ref_mgr = ref_tables.DeviceTableManager(initial_endpoints=4,
                                            initial_slots=256)
    mgr = DeviceTableManager(initial_endpoints=4, initial_slots=256,
                             device="cpu")
    for ep, st in enumerate(base):
        ref_mgr.attach(100 + ep)
        mgr.attach(100 + ep)
        ref_mgr.sync_endpoint(100 + ep, _ref_states([st])[0], revision=1)
        mgr.sync_endpoint(100 + ep, st, revision=1)
    ref, port = _l7_pair(l7state)
    ref.use_table_manager(ref_mgr, ipcache_prefixes=l7state.v4.prefixes)
    port.use_table_manager(mgr, ipcache_prefixes=l7state.v4.prefixes)
    stream = l7_serving_packets(l7state, BATCH, n_flows=512)
    packed, idx = next(stream)
    assert_same(ref, port, *_serve_l7(ref, port, "process_packed", packed,
                                      l7state.table[idx], T0))
    redirect = PolicyMapState(base[0])
    redirect[PolicyKey(identity=50001, dest_port=80, nexthdr=6,
                       direction=INGRESS)] = \
        PolicyMapStateEntry(proxy_port=L7_HTTP_PORT)
    ref_mgr.sync_endpoint(100, _ref_states([redirect])[0], revision=2)
    mgr.sync_endpoint(100, redirect, revision=2)
    rebuilds = port.rebuilds
    assert ref.refresh_policy(2) is False and port.refresh_policy(2) is False
    assert port.rebuilds == rebuilds
    np.testing.assert_array_equal(
        port._tables.l7_prog.numpy(),
        l7state.programs.progs_for_values(port._tables.datapath.value
                                          .numpy()))
    packed, idx = next(stream)
    outs = _serve_l7(ref, port, "process_packed", packed,
                     l7state.table[idx], T0 + 1)
    assert_same(ref, port, *outs)
    tier = port.last_provenance.tier.numpy()
    assert ((tier == events.TIER_L7_FAST_ALLOW) |
            (tier == events.TIER_L7_FAST_DENY)).any()
