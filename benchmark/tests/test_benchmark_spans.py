"""The program's ``dp:`` ranges beside the trace's own attribution.

A fake profiler event list of two batches (a dispatch holding a CT
range and its create rounds, a GC, a copy, the harness's ranges, runtime
calls and kernels) is read with and without the program's ranges, once
with the events' ``activity_type`` and once without (the name
fallback): every reader the benchmark had reads the same either way,
and each span reader gives its hand-computed value."""

import pytest
import torch

from benchmark import harness
from benchmark.conftest import REPO
from benchmark.trace import DeviceTrace, read_metrics

MAIN = 1
BATCHES = 2
KIND = "NVIDIA H100 80GB HBM3"


class Event:
    def __init__(self, name, start, end, kind, cid=0, device=False,
                 typed=True, linked=0):
        self._name, self._s, self._e = name, start, end
        self._cid, self._device, self._linked = cid, device, linked
        if typed:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return 0 if self._device else MAIN

    def correlation_id(self):
        return self._cid

    def linked_correlation_id(self):
        return self._linked

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"


# (name, start, end) of the host ranges on the main thread: the
# harness's user annotations, and the program's ranges, recorded as
# functions (the profiler makes no twin of them on the card's timeline)
HARNESS = [("bench:span", 0, 1000), ("bench:submit", 10, 400),
           ("stage:ct", 95, 305), ("bench:gc", 500, 700)]
PROGRAM = [("dp:engine.dispatch#1", 20, 390), ("dp:ct", 100, 300),
           ("dp:ct.create", 150, 250), ("dp:ct.gc", 510, 690)]
# (launch time, device start, device end, name): each launch is a 5 ns
# runtime call on the main thread
DEVICE = [(12, 5, 15, "Memcpy HtoD (Pinned -> Device)"),
          (30, 40, 60, "k_glue_a"), (120, 60, 100, "k_ct"),
          (160, 100, 180, "k_create_a"), (200, 200, 230, "k_create_b"),
          (320, 230, 250, "k_glue_b"), (520, 520, 560, "k_gc_a"),
          (600, 600, 610, "k_gc_b")]


def events(with_program: bool, typed: bool, collide: bool = False):
    """The fake trace; with ``collide`` each runtime call's linked id
    (its operator's, counted apart) equals the previous call's
    correlation id, as the two counters may."""
    out = [Event(n, s, e, "user_annotation", typed=typed)
           for n, s, e in HARNESS]
    out += [Event(n, s, e, "cpu_op", typed=typed)
            for n, s, e in (PROGRAM if with_program else [])]
    for cid, (t, s, e, name) in enumerate(DEVICE, start=1):
        copy = name.startswith("Memcpy")
        linked = (cid - 2) % len(DEVICE) + 1 if collide else 0
        out.append(Event("cudaMemcpyAsync" if copy else "cudaLaunchKernel",
                         t, t + 5, "cuda_runtime", cid=cid, typed=typed,
                         linked=linked))
        out.append(Event(name, s, e, "gpu_memcpy" if copy else "kernel",
                         cid=cid, device=True, typed=typed))
    return out


class Kineto:
    def __init__(self, evs):
        self.kineto_results = self
        self._evs = evs

    def events(self):
        return self._evs


SPECS = harness.find_cell(REPO, "v4-node-10k-l7.pool").per_layer
FACTS = {"batch": 1 << 20, "kind": KIND, "dispatch_ms": [40.0, 42.0],
         "lane_width": 128}


def profile(with_program: bool, typed: bool, collide: bool = False):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.profiler = Kineto(events(with_program, typed, collide))
    return prof


def read(with_program: bool, typed: bool, collide: bool = False):
    prof = profile(with_program, typed, collide)
    return read_metrics(SPECS, DeviceTrace(prof, BATCHES), FACTS)


NEW = {"ct_create_ms", "lpm_select_ms", "step_self_ms", "gc_idle_ms",
       "dispatch_idle_ms", "dispatch_self_ms", "launch_wait_ms"}


@pytest.mark.parametrize("typed", [True, False])
def test_the_readers_it_had_read_the_same_beside_the_program_spans(typed):
    plain, spans = read(False, typed), read(True, typed)
    assert not set(plain) & NEW
    assert {k: v for k, v in spans.items() if k not in NEW} == plain
    assert plain["ct_ms"] == pytest.approx(150 / 1e6 / BATCHES)
    assert plain["kernels_per_batch"] == 7 / BATCHES


@pytest.mark.parametrize("collide", [False, True])
@pytest.mark.parametrize("typed", [True, False])
def test_each_span_reader_gives_its_hand_computed_value(typed, collide):
    """Also where the runtime calls' linked ids collide with other
    calls' correlation ids: an activity is matched by its own."""
    got = read(True, typed, collide)
    ms = 1e6 * BATCHES
    want = {
        # kernels launched with ct.create innermost: 80 + 30 ns
        "ct_create_ms": 110 / ms,
        # launched in the dispatch outside every layer span: 20 + 20 ns
        "step_self_ms": 40 / ms,
        # idle while ct.gc [510, 690) was open: [510, 520), [560, 600),
        # [610, 690); the rest of the last gap is the harness's
        "gc_idle_ms": 130 / ms,
        # idle while the dispatch [20, 390) was open: [20, 40),
        # [180, 200), [250, 390)
        "dispatch_idle_ms": 180 / ms,
        # the dispatch's 370 ns, 5 runtime calls of 5 ns inside it
        "dispatch_self_ms": 345 / ms,
        "launch_wait_ms": 25 / ms,
    }
    assert {k: got[k] for k in want} == pytest.approx(want)
    # no LPM ran: the select's reader finds nothing to read
    assert "lpm_select_ms" not in got


def test_a_span_reader_with_no_profile_to_read_raises():
    """The span readers take the profiler's events from the calling
    driver's frame: where no caller holds the profile, they raise rather
    than read as a program without spans."""
    trace = DeviceTrace(profile(True, True), BATCHES)
    with pytest.raises(LookupError):
        read_metrics(SPECS, trace, FACTS)
