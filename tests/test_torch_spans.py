"""The port's own ranges on the profiler's clock, and the GC's series,
on the CPU.

``observability/stages.span`` opens a ``dp:<name>`` range only while a
profiler runs.  Under ``torch.profiler`` one ``process_packed`` gives one
``dp:engine.dispatch#<n>`` (n its sequence number) holding the layer
spans in step order, each ``dp:lpm`` a ``dp:lpm.select`` and ``dp:ct``
its ``dp:ct.create``; ``gc()`` gives ``dp:ct.gc``.  Every ``"span"``
that a benchmark metric file names is among them.
"""

import json
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from cilium_tpu_torch.datapath import engine
from cilium_tpu_torch.observability import stages
from cilium_tpu_torch.utils.metrics import CT_GC_ENTRIES, CT_GC_RUNS
from cilium_tpu_torch.workloads import (l7_fast_programs,
                                        l7_serving_packets,
                                        l7_serving_state, unpack6,
                                        v4_serving_packets,
                                        v4_serving_state, v6_of,
                                        v6_serving_packets)

REPO = Path(__file__).resolve().parent.parent
T0 = 1_000_000
WINDOW = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def state():
    return v4_serving_state(n_rules=100, n_endpoints=4, n_services=40,
                            n_prefilter=20, n_nodes=8)


def make_engine(st, ct_slots=1 << 12, ct_probe=8):
    dp = engine.Datapath(ct_slots=ct_slots, ct_probe=ct_probe,
                         device="cpu")
    dp.enable_flow_aggregation(slots=256)
    st.load(dp)
    return dp


# ------------------------------------------------------------------ spans

def _dp_ranges(prof):
    """{thread: [(start, end, name)]} of the profile's ``dp:`` ranges,
    none of them a user annotation (which the profiler would twin on the
    device's timeline)."""
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(stages.SPAN_PREFIX):
            assert not e.is_user_annotation(), e.name()
            out[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(),
                 e.name()[len(stages.SPAN_PREFIX):]))
    return {tid: sorted(r, key=lambda x: (x[0], -x[1]))
            for tid, r in out.items()}


def _tree(ranges):
    """Nested (name, [children]) of ranges sorted by start."""
    root, stack = ("", []), []
    for s, e, name in ranges:
        while stack and stack[-1][1] <= s:
            stack.pop()
        node = (name, [])
        (stack[-1][2] if stack else root)[1].append(node)
        stack.append((s, e, node))
    return root[1]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    (ranges,) = _dp_ranges(prof).values()
    return _tree(ranges)


def test_span_is_the_shared_noop_without_a_profiler():
    assert stages.span("ct") is stages.NOOP_SPAN
    assert stages.span("engine.dispatch", 3) is stages.NOOP_SPAN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert stages.span("ct") is not stages.NOOP_SPAN
    assert stages.span("ct") is stages.NOOP_SPAN


def test_host_span_records_its_stage():
    stages.reset()
    with stages.host_span("fam", "stage-a", "fam.a"):
        pass
    assert stages.pipeline_report()["fam"]["stage-a"]["count"] == 1


def _step_children(l7: bool):
    return (["engine.lock_wait", "lpm", "lb", "lpm", "policy"] +
            (["l7fast"] if l7 else []) +
            ["ct", "lb", "lpm", "flow", "engine.telemetry"])


@pytest.mark.parametrize("l7", [False, True])
def test_one_dispatch_holds_the_layer_spans_in_step_order(state, l7):
    if l7:
        l7st = l7_serving_state(state, window=WINDOW)
        dp = make_engine(l7st.v4)
        dp.enable_l7_fast(l7_fast_programs(WINDOW))
        packed, index = next(l7_serving_packets(l7st, 256, n_flows=64))
        payload = torch.as_tensor(l7st.table[index])
    else:
        dp = make_engine(state)
        packed = next(v4_serving_packets(state, 256, n_flows=64))
        payload = None
    packed = torch.as_tensor(packed)
    dp.process_packed(packed, now=T0, payload=payload)
    tree = _profiled(lambda: dp.process_packed(packed, now=T0 + 1,
                                               payload=payload))
    assert [name for name, _ in tree] == ["engine.dispatch#2"]
    children = tree[0][1]
    assert [name for name, _ in children] == _step_children(l7)
    for name, sub in children:
        want = {"lpm": ["lpm.select"], "ct": ["ct.create"]}.get(name, [])
        assert [n for n, _ in sub] == want, name
        assert all(not s for _, s in sub)
    tree = _profiled(lambda: dp.gc(T0 + 2))
    assert [(name, sub) for name, sub in tree] == [("ct.gc", [])]


def test_every_metric_span_is_in_the_trace(state):
    dp = make_engine(state)
    packed = torch.as_tensor(next(v4_serving_packets(state, 128,
                                                     n_flows=32)))

    def run():
        dp.process_packed(packed, now=T0)
        dp.gc(T0 + 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    names = {name.split("#")[0] for r in _dp_ranges(prof).values()
             for _, _, name in r}
    wanted = set()
    for path in (REPO / "benchmark" / "metrics").glob("*.json"):
        spec = json.loads(path.read_text())
        if "span" in spec:
            wanted.add(spec["span"])
    assert wanted and wanted <= names, wanted - names


# ---------------------------------------------------------------- series

def test_gc_counts_its_runs_and_deletions(state):
    dp = make_engine(state)
    dp.process_packed(torch.as_tensor(next(v4_serving_packets(
        state, 256, n_flows=64))), now=T0)
    live = dp.ct.entry_count()
    runs = CT_GC_RUNS.total()
    deleted = CT_GC_ENTRIES.value({"status": "deleted"})
    assert dp.gc(T0 + 1) == 0
    assert dp.gc(T0 + 100_000) == live > 0
    assert CT_GC_RUNS.total() - runs == 2
    assert CT_GC_ENTRIES.value({"status": "deleted"}) - deleted == live


def test_the_v6_step_shares_the_layer_spans(state):
    """``process6`` runs the helpers the v4 step runs, so one v6 dispatch
    holds the same layer spans in its own step order."""
    st6 = v6_of(state)
    dp = make_engine(st6)
    packed = unpack6(torch.as_tensor(next(v6_serving_packets(
        st6, 256, n_flows=64))))
    dp.process6(packed, now=T0)
    tree = _profiled(lambda: dp.process6(packed, now=T0 + 1))
    assert [name for name, _ in tree] == ["engine.dispatch#2"]
    children = tree[0][1]
    # prefilter, DNAT, ipcache, policy, CT, reverse NAT, flow table: the
    # v6 step has no tunnel lookup
    assert [name for name, _ in children] == [
        "engine.lock_wait", "lpm", "lb", "lpm", "policy", "ct", "lb",
        "flow", "engine.telemetry"]
    for name, sub in children:
        want = {"lpm": ["lpm.select"], "ct": ["ct.create"]}.get(name, [])
        assert [n for n, _ in sub] == want, name
