"""The config-1 verdict path end to end: JAX package vs the port.

``build_config1(n_rules=100, n_endpoints=16)`` with 4,096-packet
batches goes through the JAX ``make_step`` / ``dense_datapath_step``
and through the port's counterparts on the CPU.  Verdicts, identities
and counters must be equal (tolerance 0), and match the scalar oracle.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cilium_tpu.compiler import lpm as ref_lpm
from cilium_tpu.compiler import policy_tables as ref_pt
from cilium_tpu.datapath import pipeline as ref_pipeline
from cilium_tpu.ops import dense_verdict as ref_dense
from cilium_tpu.policy import mapstate as ref_ms

from cilium_tpu_torch import convert, device
from cilium_tpu_torch.compiler import lpm, policy_tables
from cilium_tpu_torch.datapath import pipeline, verdict
from cilium_tpu_torch.ops import dense_verdict as dense
from cilium_tpu_torch.workloads import (build_config1,
                                        config1_allow_heavy_packets,
                                        config1_packets)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run shares the host's cores among several pytest
    workers; small tensors gain nothing from torch's intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_states(states):
    out = []
    for st in states:
        r = ref_ms.PolicyMapState()
        for k, v in st.items():
            r[ref_ms.PolicyKey(k.identity, k.dest_port, k.nexthdr,
                               k.direction)] = \
                ref_ms.PolicyMapStateEntry(v.proxy_port)
        out.append(r)
    return out


def _hit_heavy_loop(prefixes, states, seed=3):
    """Packets sourced inside the policy's prefixes, to the rules'
    ports or near them, so that every stage and counter is exercised:
    the loop that ``config1_allow_heavy_packets`` vectorises."""
    pk = config1_packets(BATCH, len(states), seed=seed)
    rng = np.random.default_rng(seed)
    nets = lpm.parse_prefixes(prefixes)
    pick = rng.integers(0, len(nets), BATCH)
    src = np.array([nets[i][0] + int(rng.integers(0, 2 ** (32 - nets[i][2])))
                    for i in pick], np.uint64)
    ports = np.array(sorted({k.dest_port for k in states[0]}), np.int32)
    pk["src_addr"] = src.astype(np.uint32).view(np.int32)
    pk["dport"] = np.where(rng.random(BATCH) < 0.7, rng.choice(ports, BATCH),
                           pk["dport"]).astype(np.int32)
    pk["length"] = rng.integers(40, 1500, BATCH).astype(np.int32)
    return pk


@pytest.fixture(scope="module")
def config1():
    states, prefixes = build_config1(n_rules=100, n_endpoints=16)
    return states, prefixes


def _both_hash_steps(states, prefixes, pk, frag):
    cp = policy_tables.compile_endpoints(states, revision=1)
    cl = lpm.compile_lpm(prefixes)
    step, tables, counters = pipeline.make_step(cp, cl, device="cpu")
    t = {k: torch.as_tensor(v) for k, v in pk.items()}
    raw = pipeline.RawPacketBatch(is_fragment=torch.as_tensor(frag), **t)
    got = step(tables, counters, raw)

    rcp = ref_pt.compile_endpoints(_ref_states(states), revision=1)
    rcl = ref_lpm.compile_lpm(prefixes)
    rstep, rtables, rcounters = ref_pipeline.make_step(rcp, rcl)
    rraw = ref_pipeline.RawPacketBatch(
        is_fragment=jnp.asarray(frag),
        **{k: jnp.asarray(v) for k, v in pk.items()})
    want = rstep(rtables, rcounters, rraw)
    return got, want, (rtables, rcounters, rcp, rcl, rraw)


def _eq_u32(t, a):
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(a))


@pytest.mark.parametrize("stream", ["bench", "hit-heavy"])
def test_config1_hash_and_dense_match_reference(config1, stream):
    states, prefixes = config1
    pk = config1_packets(BATCH, len(states)) if stream == "bench" \
        else config1_allow_heavy_packets(BATCH, len(states), prefixes, states)
    frag = np.zeros(BATCH, np.int32)
    (v, ident, counters), (rv, rident, rcounters), _ = _both_hash_steps(
        states, prefixes, pk, frag)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ident.numpy(), np.asarray(rident))
    _eq_u32(counters.packets, rcounters.packets)
    _eq_u32(counters.bytes, rcounters.bytes)

    tables = dense.compile_dense(states, device="cpu")
    dlpm = dense.compile_dense_lpm(prefixes, device="cpu")
    n = tables.ep.shape[0]
    zeros = lambda: torch.zeros(n, dtype=torch.int32)  # noqa: E731
    order = ("endpoint", "src_addr", "dport", "proto", "direction", "length")
    dv, dident, cpk, cby = dense.dense_datapath_step(
        tables, dlpm, zeros(), zeros(),
        *(torch.as_tensor(pk[k]) for k in order))
    rt = ref_dense.compile_dense(_ref_states(states))
    rv2, rident2, rcpk, rcby = ref_dense.dense_datapath_step(
        rt, ref_dense.compile_dense_lpm(prefixes), jnp.zeros(n, jnp.uint32),
        jnp.zeros(n, jnp.uint32), *(jnp.asarray(pk[k]) for k in order))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(rv2))
    np.testing.assert_array_equal(dident.numpy(), np.asarray(rident2))
    _eq_u32(cpk, rcpk)
    _eq_u32(cby, rcby)

    # hash == dense, and both == the scalar oracle on a sample
    np.testing.assert_array_equal(v.numpy(), dv.numpy())
    allowed = int((v.numpy() != -1).sum())
    assert int(counters.packets.sum()) == int(cpk.sum()) == allowed
    parsed = lpm.parse_prefixes(prefixes)
    src = pk["src_addr"].view(np.uint32)
    for i in range(0, BATCH, 8):
        want_id = lpm.oracle_lpm_u32(parsed, int(src[i]))
        want_id = 2 if want_id == lpm.LPM_MISS else want_id
        assert ident[i] == want_id
        assert v[i] == policy_tables.oracle_verdict(
            states[pk["endpoint"][i]], want_id, int(pk["dport"][i]), 6, 1)
    if stream == "hit-heavy":
        assert 0 < allowed < BATCH


def test_config1_hash_fragments_and_converted_state(config1):
    """Fragments through the hash step, and the port run on the JAX
    package's own tables carried across by ``convert.from_jax_arrays``."""
    states, prefixes = config1
    pk = config1_allow_heavy_packets(BATCH, len(states), prefixes, states,
                                     seed=5)
    frag = (np.random.default_rng(5).random(BATCH) < 0.2).astype(np.int32)
    (v, _, counters), (rv, _, rc), (rt, _, rcp, rcl, rraw) = \
        _both_hash_steps(states, prefixes, pk, frag)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    _eq_u32(counters.bytes, rc.bytes)
    assert (v.numpy() == verdict.VERDICT_DROP_FRAG).any()

    leaves = lambda nt: {f: np.asarray(getattr(nt, f))  # noqa: E731
                         for f in nt._fields}
    port = convert.from_jax_arrays(
        tables=leaves(rt), counters=leaves(rc), policy_probe=rcp.max_probe,
        lpm_probe=rcl.max_probe, device="cpu")
    assert port.counters.packets.dtype == torch.int32
    t = {k: torch.as_tensor(v) for k, v in pk.items()}
    raw = pipeline.RawPacketBatch(is_fragment=torch.as_tensor(frag), **t)
    v2, _, c2 = pipeline.datapath_step(port.tables, port.counters, raw,
                                       policy_probe=port.policy_probe,
                                       lpm_probe=port.lpm_probe)
    rv2, _, rc2 = ref_pipeline.datapath_step(rt, rc, rraw,
                                             policy_probe=rcp.max_probe,
                                             lpm_probe=rcl.max_probe)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(rv2))
    _eq_u32(c2.packets, rc2.packets)
    _eq_u32(c2.bytes, rc2.bytes)

    rd = ref_dense.compile_dense(_ref_states(states))
    rdl = ref_dense.compile_dense_lpm(prefixes)
    port = convert.from_jax_arrays(dense=leaves(rd), dense_lpm=leaves(rdl),
                                   device="cpu")
    for f in dense.DenseTables._fields:
        np.testing.assert_array_equal(getattr(port.dense, f).numpy(),
                                      np.asarray(getattr(rd, f)))
    assert port.tables is None and port.counters is None
    with pytest.raises(ValueError, match="fields"):
        convert.from_jax_arrays(dense={"ep": np.zeros(4, np.int32)},
                                device="cpu")
    with pytest.raises(ValueError, match="int32 or uint32"):
        convert.from_jax_arrays(dense_lpm={
            f: np.zeros(4, np.int64) for f in dense.DenseLPM._fields},
            device="cpu")


@pytest.mark.parametrize("seed", [3, 5])
def test_allow_heavy_generator_matches_the_loop(config1, seed):
    states, prefixes = config1
    got = config1_allow_heavy_packets(BATCH, len(states), prefixes, states,
                                      seed=seed)
    want = _hit_heavy_loop(prefixes, states, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_entry_points_default_to_cuda_and_raise_without_it(config1):
    assert not torch.cuda.is_available()
    states, prefixes = config1
    cp = policy_tables.compile_endpoints(states[:1], revision=1)
    cl = lpm.compile_lpm(prefixes)
    calls = [lambda: pipeline.make_step(cp, cl),
             lambda: pipeline.build_tables(cp, cl),
             lambda: verdict.VerdictEngine(cp),
             lambda: dense.DenseVerdictEngine(states[:1]),
             lambda: dense.compile_dense(states[:1]),
             lambda: dense.compile_dense_lpm(prefixes),
             lambda: convert.from_jax_arrays()]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_step(cp, cl, device="cuda")
    feats = device.probe()
    assert not feats["cuda_available"]
    assert feats["verdict_engines"] == ["hash", "dense", "bucket"]
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Run in a fresh interpreter (conftest imports jax into this one):
    every module of the port, and chip_smoke.py, import without jax and
    without any module of the JAX package; the agent's modules (daemon,
    REST, CLI, monitor, Hubble, clustermesh) and the proxy plane's (xDS,
    socket proxy, proxy child, supervisor, csum, NAT46) are among
    them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cilium_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    cilium_tpu_torch.__path__, 'cilium_tpu_torch.')]\n"
        "for name in mods + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cilium_tpu' or m.startswith('cilium_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'chip_smoke' in sys.modules and len(mods) >= 15, mods\n"
        "agent = ['cilium_tpu_torch.' + m for m in (\n"
        "    'daemon', 'daemon.rest', 'cli', 'monitor', 'hubble',\n"
        "    'clustermesh', 'kvstore.etcd', 'kvstore.outage',\n"
        "    'kvstore.serve', 'xds', 'l7.xds_wire', 'l7.socket_proxy',\n"
        "    'l7.proxy_child', 'l7.supervisor', 'datapath.csum',\n"
        "    'datapath.nat46')]\n"
        "assert set(agent) <= set(mods), sorted(set(agent) - set(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
