"""Device-lane chaos on the port's serving supervisor
(``datapath/supervisor.py``) against the JAX package's, on the CPU.

Each scenario runs twice, once on the JAX package's engine, lane,
supervisor and fault injector and once on the port's, from the same
policy, the same records and the same injected script; what each run
observes (modes, breaker states, fault and recovery counts, every
verdict and identity, fail-static ones included) must be equal
(tolerance 0).  Scenarios: transient faults opening the breaker while
established flows keep their verdicts, a fatal fault tripping it at
once, a hung completion caught by the watchdog, fail-static answers for
new flows equal to the device's, the degraded new-flow policies, a
failing recovery gate, a transient-then-heal script, recovery rebuilding
corrupted device tables, and the lane without supervision.  Also the
port's CUDA fault markers.
"""

import time

import numpy as np
import pytest
import torch

from cilium_tpu.datapath import serving as ref_serving
from cilium_tpu.datapath import supervisor as ref_supervisor
from cilium_tpu.utils import faultinject as ref_faultinject

from cilium_tpu_torch.datapath import serving, supervisor
from cilium_tpu_torch.observability import events
from cilium_tpu_torch.utils import faultinject
from cilium_tpu_torch.utils.metrics import (DATAPLANE_DEVICE_FAULTS,
                                            DATAPLANE_FAIL_STATIC,
                                            DATAPLANE_RECOVERIES)

from test_torch_serving import chunk, load_pair, ref_alone, _SPORT

REF = (ref_serving, ref_supervisor, ref_faultinject)
PORT = (serving, supervisor, faultinject)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    """(JAX, port, prefixes): shared by the scenarios, each of which
    builds its own lane and supervisor; source ports never repeat."""
    return load_pair()


def supervised(pkg, dp, **kw):
    srv, sup_mod, fi = pkg
    kw.setdefault("watchdog_s", 5.0)
    kw.setdefault("failure_threshold", 2)
    kw.setdefault("reset_s", 0.05)
    sup = sup_mod.DeviceSupervisor(dp, **kw)
    disp = srv.VerdictDispatcher(dp, supervisor=sup,
                                 lane=f"chaos-{id(sup) & 0xFFFF:x}")
    inj = fi.DeviceFaultInjector()
    sup.install_fault_hook(inj)
    return disp, sup, inj


def submit(disp, c):
    n = len(c["sport"])
    t = disp.submit_records({k: v.copy() for k, v in c.items()}, n)
    v, i = t.result(timeout=60)
    return t.error, np.asarray(v), np.asarray(i)


def on_both(pair, scenario, seed, **kw):
    """Run ``scenario(dp, disp, sup, inj, rng, prefixes)`` on the JAX
    package and on the port with the same records; returns both
    observation lists after asserting them equal."""
    out = []
    base = _SPORT[0]
    for pkg, dp in ((REF, pair[0]), (PORT, pair[1])):
        _SPORT[0] = base
        disp, sup, inj = supervised(pkg, dp, **kw)
        try:
            out.append(scenario(dp, disp, sup, inj,
                                np.random.default_rng(seed), pair[2]))
        finally:
            disp.close()
    _SPORT[0] = base + 100_000
    assert len(out[0]) == len(out[1])
    for k, (r, p) in enumerate(zip(*out)):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(r, p, err_msg=f"step {k}")
        else:
            assert r == p, (k, r, p)
    return out


# ------------------------------------------------ fault classification

def test_fault_classification():
    """The port's markers: OutOfMemoryError is transient, a CUDA runtime
    error fatal, caller errors and injected faults as in the
    reference."""
    classify = supervisor.classify_fault
    assert classify(faultinject.DeviceLaneFault(fatal=True)) == "fatal"
    assert classify(faultinject.DeviceLaneFault()) == "transient"
    assert classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "transient"
    assert classify(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "fatal"
    assert classify(RuntimeError(
        "CUDA error: unspecified launch failure")) == "fatal"
    if hasattr(torch, "AcceleratorError"):
        assert classify(torch.AcceleratorError(
            "device-side assert triggered")) == "fatal"
    for e in (OSError("link down"), RuntimeError("no policy loaded"),
              ValueError("payload must be [16, 64] int32")):
        assert classify(e) == ref_supervisor.classify_fault(e), e
    assert classify(RuntimeError("no policy loaded")) == "caller"


# ---------------------------------------------------- fail-static

def test_transient_faults_open_breaker_and_established_flows_survive(pair):
    def scenario(dp, disp, sup, inj, rng, prefixes):
        obs = []
        c1 = chunk(rng, 16, prefixes)
        err, v1, i1 = submit(disp, c1)
        assert err is None and (v1 >= 0).any()
        sup.oracle.refresh()
        obs += [v1, i1, sup.oracle.stats()["ct-entries"] > 0]
        inj.fail_launch(times=2)
        for _ in range(2):
            err, v, i = submit(disp, c1)
            obs += [err is None, v, i]
        obs += [sup.mode, sup.breaker.state, dict(sup.faults)]
        err, vs, _i = submit(disp, c1)
        allowed = v1 >= 0
        np.testing.assert_array_equal(vs[allowed],
                                      np.maximum(v1[allowed], 0))
        obs += [err is None, vs, disp.stats()["static-batches"],
                sup.fail_static_batches]
        return obs

    static0 = DATAPLANE_FAIL_STATIC.total()
    faults0 = DATAPLANE_DEVICE_FAULTS.total()
    obs = on_both(pair, scenario, 5)[1]
    assert DATAPLANE_DEVICE_FAULTS.total() == faults0 + 2
    assert DATAPLANE_FAIL_STATIC.total() > static0
    assert obs[9:12] == ["degraded", "open", {"transient": 2}]


def test_fatal_fault_trips_breaker_immediately(pair):
    def scenario(dp, disp, sup, inj, rng, prefixes):
        _e, v, i = submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        inj.fail_launch(times=1, fatal=True)
        err, v2, i2 = submit(disp, chunk(rng, 16, prefixes))
        return [v, i, err is None, v2, i2, sup.mode, dict(sup.faults)]

    obs = on_both(pair, scenario, 7, failure_threshold=5)[1]
    assert obs[5] == "degraded" and obs[6] == {"fatal": 1}


def test_hung_finalize_is_a_fault_via_watchdog(pair):
    """A completion that outlives the 0.2 s watchdog resolves its batch
    fail-static within the budget; once the abandoned worker finishes,
    the next probe recovers the lane."""
    def scenario(dp, disp, sup, inj, rng, prefixes):
        submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        inj.hang_finalize(seconds=1.2)
        t0 = time.perf_counter()
        err, v, i = submit(disp, chunk(rng, 16, prefixes))
        took = time.perf_counter() - t0
        assert took < 1.0, f"watchdog did not fire ({took:.2f}s)"
        obs = [err is None, v, i, dict(sup.faults), sup.mode]
        time.sleep(1.3)
        err, v, i = submit(disp, chunk(rng, 16, prefixes))
        return obs + [err is None, v, i, sup.mode, sup.recoveries]

    obs = on_both(pair, scenario, 9, watchdog_s=0.2,
                  failure_threshold=3)[1]
    assert obs[3] == {"hung": 1} and obs[4] == "degraded"
    assert obs[-2:] == ["ok", 1]


@pytest.mark.parametrize("seed", [11, 13])
def test_fail_static_new_flows_equal_device(pair, seed):
    """Degraded-mode "oracle" answers for new flows equal what the JAX
    device path decides for them (verdict and identity), on both
    packages."""
    fresh = {}

    def scenario(dp, disp, sup, inj, rng, prefixes):
        submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        fresh["c"] = chunk(rng, 64, prefixes)
        inj.fail_launch(times=2)
        for _ in range(2):
            submit(disp, chunk(rng, 16, prefixes))
        err, sv, si = submit(disp, fresh["c"])
        return [sup.mode, err is None, sv, si]

    obs = on_both(pair, scenario, seed)[1]
    ref, _port, _ = load_pair()
    dv, di = ref_alone(ref, fresh["c"])
    assert obs[0] == "degraded" and obs[1]
    np.testing.assert_array_equal(obs[2], dv)
    np.testing.assert_array_equal(obs[3], di)


@pytest.mark.parametrize("policy,expect", [("deny", -1), ("allow", 0)])
def test_degraded_new_flow_policy(pair, policy, expect):
    def scenario(dp, disp, sup, inj, rng, prefixes):
        submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        inj.fail_launch(times=2)
        for _ in range(2):
            submit(disp, chunk(rng, 16, prefixes))
        err, v, i = submit(disp, chunk(rng, 32, prefixes))
        return [sup.mode, err is None, v, i]

    obs = on_both(pair, scenario, 17, new_flow_policy=policy)[1]
    assert obs[0] == "degraded" and (obs[2] == expect).all()


# ------------------------------------------------------- recovery

def test_recovery_gate_failure_keeps_lane_degraded(pair):
    """The half-open probe may not resume on a failing gate: the breaker
    re-opens (doubling cadence) until the gate passes."""
    def scenario(dp, disp, sup, inj, rng, prefixes):
        calls = []

        def gate():
            calls.append(1)
            return len(calls) >= 3

        sup._recovery_gate = gate
        submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        inj.fail_launch(times=2)
        for _ in range(2):
            submit(disp, chunk(rng, 16, prefixes))
        obs = [sup.mode]
        deadline = time.monotonic() + 20.0
        while sup.mode != "ok" and time.monotonic() < deadline:
            time.sleep(0.05)
            err, _v, _i = submit(disp, chunk(rng, 8, prefixes))
            assert err is None
        return obs + [sup.mode, len(calls), sup.recoveries]

    obs = on_both(pair, scenario, 19)[1]
    assert obs == ["degraded", "ok", 3, 1]


def test_transient_then_heal_script_recovers(pair):
    """Every launch faults for a while, the breaker holds the lane
    static between probes, and the first healthy probe (gated by the
    default replay gate) closes it."""
    def scenario(dp, disp, sup, inj, rng, prefixes):
        submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        inj.script([("launch", "raise", False)] * 4)
        deadline = time.monotonic() + 20.0
        while (sup.mode != "ok" or inj.armed) and \
                time.monotonic() < deadline:
            err, _v, _i = submit(disp, chunk(rng, 8, prefixes))
            assert err is None           # never fail-closed mid-chaos
            time.sleep(0.02)
        err, v, i = submit(disp, chunk(rng, 16, prefixes))
        return [sup.mode, inj.injected, sup.recoveries, err is None, v, i]

    rec0 = DATAPLANE_RECOVERIES.total()
    seq0 = events.recorder.last_seq
    obs = on_both(pair, scenario, 23)[1]
    assert obs[:4] == ["ok", 4, 1, True]
    assert DATAPLANE_RECOVERIES.total() > rec0
    # the port's flight recorder holds the incident's timeline in order
    kinds = [e.type for e in events.recorder.events(since=seq0, limit=0)]
    assert kinds[0] == events.EVENT_DATAPLANE_TRIP
    assert kinds.index(events.EVENT_DATAPLANE_DEGRADED) < \
        kinds.index(events.EVENT_DATAPLANE_REBUILD) < \
        kinds.index(events.EVENT_DATAPLANE_RECOVERED)


def test_recovery_rebuilds_device_tables_from_host_of_record(pair):
    """While degraded, the live device policy tensors are zeroed (what a
    lost device table looks like); recovery rebuilds them from the
    host-of-record, passes the replay gate, and serves the device's
    verdicts again."""
    import jax.numpy as jnp

    def corrupt(dp):
        meta = dp._tables.datapath.key_meta
        if isinstance(meta, torch.Tensor):
            bad = dp._tables.datapath._replace(key_meta=torch.zeros_like(meta))
            dp._tables = dp._tables._replace(datapath=bad)
            return
        bad = dp._tables.datapath._replace(key_meta=jnp.zeros_like(meta))
        dp._tables = dp._tables._replace(datapath=bad)
        dp._tbufs4 = tuple(jnp.zeros_like(b) for b in dp._tbufs4)

    def scenario(dp, disp, sup, inj, rng, prefixes):
        submit(disp, chunk(rng, 16, prefixes))
        sup.oracle.refresh()
        inj.fail_launch(times=2)
        for _ in range(2):
            submit(disp, chunk(rng, 8, prefixes))
        obs = [sup.mode]
        corrupt(dp)
        time.sleep(0.1)
        err, v, i = submit(disp, chunk(rng, 16, prefixes))
        return obs + [sup.mode, sup.recoveries, err is None, v, i]

    obs = on_both(pair, scenario, 29)[1]
    assert obs[:4] == ["degraded", "ok", 1, True]
    assert (obs[4] >= 0).any()


# ------------------------------------- the lane without supervision

def test_supervision_disabled_lane():
    """``configure_supervision(enabled=False)``: no supervisor on the
    engine's lane, a failing launch keeps the fail-closed deny, and the
    same records get the same verdicts as the supervised lane's and the
    JAX package's."""
    ref_off, off, prefixes = load_pair(enabled=False)
    _ref_on, on, _ = load_pair()
    lanes = (ref_off.serving(), off.serving(), on.serving())
    try:
        assert lanes[0].supervisor is None
        assert lanes[1].supervisor is None
        assert lanes[2].supervisor is not None
        assert off.supervision_status() == {
            "mode": "ok", "supervised": False,
            "serving": lanes[1].stats()}
        c = chunk(np.random.default_rng(31), 16, prefixes)
        outs = [submit(lane, c) for lane in lanes]
        for err, v, i in outs:
            assert err is None
            np.testing.assert_array_equal(v, outs[0][1])
            np.testing.assert_array_equal(i, outs[0][2])
        status = on.supervision_status()
        assert status["mode"] == "ok" and status["supervised"]
        assert status["serving"]["supervisor"]["faults"] == {}
    finally:
        for lane in lanes:
            lane.close()
