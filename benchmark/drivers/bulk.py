"""The bulk driver: large batches straight into
``Datapath.process_packed(packed, now=, payload=)``, as a node's
forwarding loop would feed it.

Set-up builds the deployment from the seed, loads it into the system,
generates a ring of the mix's ``ring`` batches in page-locked host
memory and serves ``WARMUP`` of them.  The window then replays the ring
in order with the clock still advancing (batch t at ``T0 + t`` seconds):

- a batch is copied host to device (its payload lane too, where the
  mix has one) on a copy stream of its own, one batch ahead: the copy of
  batch t + 1 is issued once batch t is queued, so that it runs while
  the card steps, as a node that double-buffers its input would feed
  it; the step waits for its batch's copy, and its verdict and event
  vectors are copied back into page-locked memory;
- ``IN_FLIGHT`` batches are in flight: before a batch is submitted, the
  oldest one is waited for;
- the conntrack GC runs every ``GC_EVERY`` batches, as the agent's
  ``ct-gc`` controller would;
- a batch counts once its verdict and event vectors are in host memory.

``verdicts_per_s`` is the rows whose verdicts reached host memory
inside the window over the window's seconds; ``verdict_p95_ms`` the
95th percentile, over every batch submitted in the window, of the time
from its submission (the issue of its copy) to its completion.  A
traced run profiles the window's first ``TRACE_BATCHES`` batches and
reads the per-layer metrics from them.  These settings are the driver's, the same for every
mix; a traffic file holds only the mix.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, generate
from ..harness import Clock, Outcome, RunContext, on_device, power_limit
from ..trace import SPAN, DeviceTrace, read_metrics, stage_ranges

ROWS = len(generate.FIELDS)
IN_FLIGHT = 2
GC_EVERY = 8
T0 = 1_000_000           # the clock at the first warm-up batch, seconds
WARMUP = 12
TRACE_BATCHES = 24


class Pipeline:
    """Batches of the ring through the system, ``IN_FLIGHT`` at a time,
    one clock second apart."""

    def __init__(self, system, clock: Clock, ring: torch.Tensor,
                 lanes: Optional[torch.Tensor], device):
        self.system, self.clock = system, clock
        self.ring, self.lanes = ring, lanes
        self.depth = IN_FLIGHT
        b = ring.shape[2]
        # one input slot more than in flight: the next batch's copy
        # fills the slot that the oldest batch, waited for, has left
        n_in = self.depth + 1
        self.slots = [torch.empty((ROWS, b), dtype=torch.int32,
                                  device=device) for _ in range(n_in)]
        self.lane_slots = None if lanes is None else [
            torch.empty(lanes.shape[1:], dtype=torch.int32, device=device)
            for _ in range(n_in)]
        self.copies = torch.cuda.Stream(device) if clock.cuda else None
        self.loads: Dict[int, tuple] = {}    # t: (issued, copied event)
        self.out = [clock.host((2, b)) for _ in range(self.depth)]
        self.pending = deque()
        self.finished: List[Dict] = []
        self.on_complete = None
        self.t = 0

    @staticmethod
    def now(t: int) -> int:
        return T0 + t

    def submit(self, keep: bool = False, before: bool = False,
               after: bool = False) -> Dict:
        """Queue the next batch; ``keep`` holds its outputs, ``before``
        and ``after`` snapshot the system's state around it (after the
        GC that follows it, where one is due)."""
        if len(self.pending) >= self.depth:
            self.complete()
        t = self.t
        k, j = t % self.depth, t % len(self.slots)
        rec = {"t": t}
        with record_function("bench:submit"):
            self._load(t)
            rec["submit"], copied = self.loads.pop(t)
            if copied is not None:
                torch.cuda.current_stream(self.slots[j].device) \
                    .wait_event(copied)
            lane = None if self.lanes is None else self.lane_slots[j]
            if before:
                rec["before"] = self.system.snapshot()
            t_call = time.perf_counter()
            outs = self.system.step(self.slots[j], self.now(t), lane)
            rec["call_ms"] = (time.perf_counter() - t_call) * 1e3
            self.out[k][0].copy_(outs[0], non_blocking=True)
            self.out[k][1].copy_(outs[1], non_blocking=True)
            rec["event"] = self.clock.mark()
            self._load(t + 1)
        if keep or before:
            rec["outputs"] = outs
        self.t += 1
        if self.t % GC_EVERY == 0:
            with record_function("bench:gc"):
                self.system.gc(self.now(self.t))
        if after:
            rec["after"] = self.system.snapshot()
        rec["slot"] = k
        self.pending.append(rec)
        return rec

    def _load(self, t: int) -> None:
        """Issue the copy of batch ``t`` into its input slot, once."""
        if t in self.loads:
            return
        j, r = t % len(self.slots), t % self.ring.shape[0]
        issued = time.perf_counter()
        if self.copies is None:
            self.slots[j].copy_(self.ring[r])
            if self.lanes is not None:
                self.lane_slots[j].copy_(self.lanes[r])
            self.loads[t] = (issued, None)
            return
        with torch.cuda.stream(self.copies):
            self.slots[j].copy_(self.ring[r], non_blocking=True)
            if self.lanes is not None:
                self.lane_slots[j].copy_(self.lanes[r], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.copies)
        self.loads[t] = (issued, copied)

    def complete(self) -> None:
        rec = self.pending.popleft()
        with record_function("bench:wait"):
            self.clock.wait(rec.pop("event"))
        rec["complete"] = time.perf_counter()
        if self.on_complete is not None:
            self.on_complete(rec, self.out[rec["slot"]])
        self.finished.append(rec)

    def drain(self) -> None:
        """Wait for every batch in flight.  The next batch's copy is
        issued anew when it is submitted, so that no batch's latency
        takes in the pause that follows a drain."""
        while self.pending:
            self.complete()
        self.loads.clear()


# the event codes a v4 step gives (traces 0, 1, 4; drops -130, -131,
# -133, -134)
EVENT_CODES = (0, 1, 4, -130, -131, -133, -134)


def _event_shares(by_pass: Dict[int, np.ndarray]) -> str:
    parts = []
    for p, counts in sorted(by_pass.items()):
        total = counts.sum()
        codes = {c: counts[i] / total for i, c in enumerate(EVENT_CODES)
                 if counts[i]}
        parts.append(f"pass {p}: " + " ".join(
            f"{c}:{s:.4f}" for c, s in codes.items()))
    return "; ".join(parts)


def run(ctx: RunContext) -> Outcome:
    cell, dev, log = ctx.cell, ctx.device, ctx.log
    config, traffic = cell.config, cell.traffic
    clock = Clock(dev)
    seeds = generate.seeds_of(ctx.seed, config)
    marks = {"start": ctx.process_start, "imports": time.perf_counter()}

    node = generate.node_state(config["state"], seeds, config.get("l7"))
    marks["state"] = time.perf_counter()
    restore = stage_ranges(cell.per_layer) if ctx.trace else None
    system = ctx.make_system(node, config, dev)
    marks["load"] = time.perf_counter()

    n_ring, b = traffic["ring"], traffic["batch"]
    ring = clock.host((n_ring, ROWS, b))
    lanes = None
    if traffic.get("l7"):
        table = generate.payload_table(node, traffic)
        lanes = clock.host((n_ring, b, table.shape[1]))
    pinned = ring.nbytes + (0 if lanes is None else lanes.nbytes)
    if traffic.get("pinned_bytes") not in (None, pinned):
        raise ValueError(f"the mix records {traffic['pinned_bytes']} "
                         f"pinned bytes, the ring takes {pinned}")
    stream = generate.batches(node, traffic, seeds)
    ring_np = ring.numpy()
    for r in range(n_ring):
        packed, index = next(stream)
        ring_np[r] = packed
        if lanes is not None:
            # torch's gather runs on every core, numpy's on one
            torch.index_select(torch.as_tensor(table), 0,
                               torch.as_tensor(index).long(),
                               out=lanes[r])
    marks["ring"] = time.perf_counter()

    pipe = Pipeline(system, clock, ring, lanes, dev)
    warm = [pipe.submit(keep=True) for _ in range(WARMUP)]
    pipe.drain()
    replay = [tuple(o.cpu() for o in rec.pop("outputs")) for rec in warm]
    start_state = on_device(system.snapshot(), "cpu")
    clock.sync()
    marks["warmup"] = time.perf_counter()

    rng = np.random.default_rng(
        np.random.SeedSequence([int(ctx.seed), 1]))
    n_samples = compare.SAMPLES
    samples: List[Dict] = []
    seen = 0
    n_trace = TRACE_BATCHES if ctx.trace else 0
    prof = span = None
    by_pass: Dict[int, np.ndarray] = {}
    if ctx.trace:
        def shares(rec, out):
            ev = out[1].numpy()
            counts = np.array([(ev == c).sum() for c in EVENT_CODES])
            p = rec["t"] // n_ring
            by_pass[p] = by_pass.get(p, 0) + counts
        pipe.on_complete = shares
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        span = record_function(SPAN)
        span.__enter__()

    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx.process_start
    window: List[Dict] = []
    traced = 0
    while time.perf_counter() - t_w0 < ctx.seconds:
        i = len(window)
        if span is not None and i == n_trace:
            pipe.drain()
            clock.sync()
            span.__exit__(None, None, None)
            prof.stop()
            span = None
            traced = i
        take, slot = False, None
        if span is None:
            # reservoir sample of the batches outside the traced span
            seen += 1
            if len(samples) < n_samples:
                take, slot = True, len(samples)
            else:
                j = int(rng.integers(0, seen))
                take, slot = j < n_samples, j
        rec = pipe.submit(before=take, after=take)
        if take:
            if slot < len(samples):
                for key in ("before", "after", "outputs"):
                    samples[slot].pop(key)
                samples[slot] = rec
            else:
                samples.append(rec)
        window.append(rec)
    t_end = t_w0 + ctx.seconds
    pipe.drain()
    clock.sync()
    if span is not None:       # the window ended inside the traced span
        span.__exit__(None, None, None)
        prof.stop()
        traced = len(window)
    if restore is not None:
        restore()

    done_in = [r for r in window if r["complete"] <= t_end]
    lat = np.array([(r["complete"] - r["submit"]) * 1e3 for r in window])
    e2e = {"verdicts_per_s": len(done_in) * b / ctx.seconds,
           "verdict_p95_ms": float(np.percentile(lat, 95)),
           "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    log(f"card: {power_limit()}")
    phases = ("start", "imports", "state", "load", "ring", "warmup")
    log("setup: " + ", ".join(
        f"{k} {marks[k] - marks[p]:.3f}s"
        for p, k in zip(phases, phases[1:])) +
        f"; pinned {pinned} bytes in a ring of {n_ring}")
    log(f"window: {len(window)} batches of {b} submitted, "
        f"{len(done_in)} done inside {ctx.seconds}s; latency ms p50 "
        f"{np.percentile(lat, 50):.3f} p95 {e2e['verdict_p95_ms']:.3f} "
        f"max {lat.max():.3f} over {len(lat)} requests")
    # a stall shows as a few long gaps between completions, a slower
    # card or copy as every gap longer
    gaps = np.diff([r["complete"] for r in window]) * 1e3
    halves = np.array_split(gaps, 2)
    log(f"gaps: ms p50 {np.percentile(gaps, 50):.3f} p99 "
        f"{np.percentile(gaps, 99):.3f} max {gaps.max():.3f}, "
        f"{int((gaps > 2 * np.median(gaps)).sum())} over twice the "
        f"median; mean {halves[0].mean():.3f} / {halves[1].mean():.3f} "
        f"in the two halves")
    if clock.cuda:
        # the host-to-device rate of this run, the window's copies
        # alone, once it has closed
        pairs = [(pipe.slots[0], ring)]
        if lanes is not None:
            pairs.append((pipe.lane_slots[0], lanes))
        rates = []
        for dst, src in pairs:
            t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
            t0.record()
            for r in range(n_ring):
                dst.copy_(src[r], non_blocking=True)
            t1.record()
            t1.synchronize()
            rates.append(src.nbytes / t0.elapsed_time(t1) / 1e6)
        log("copies: host to device GB/s " +
            " / ".join(f"{g:.2f}" for g in rates) + " (batch / lane)")

    per_layer, extra, breakdown = {}, {}, None
    if prof is not None:
        trace = DeviceTrace(prof, traced)
        untraced = [r["call_ms"] for r in window[traced:]]
        run_facts = {"batch": b, "kind": torch.cuda.get_device_name(dev)
                     if clock.cuda else "cpu", "dispatch_ms": untraced,
                     "lane_width": None if lanes is None
                     else lanes.shape[2]}
        per_layer = read_metrics(cell.per_layer, trace, run_facts)
        extra = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps()}
        log(f"trace: {traced} batches, {len(trace.acts)} device "
            f"activities, {trace.unlinked} without a launch; "
            f"event shares {_event_shares(by_pass)}")
        del prof, trace

    keys = system.counter_keys()
    read_state = system.read_state
    system.close()
    del system, pipe
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()

    def state(snap):
        return None if snap is None else read_state(on_device(snap, dev))

    def batch(rec, outputs):
        t, r = rec["t"], rec["t"] % n_ring
        return {"packed": ring[r],
                "payload": None if lanes is None else lanes[r],
                "now": Pipeline.now(t), "outputs": outputs, "call": t,
                "gc": Pipeline.now(t + 1) if (t + 1) % GC_EVERY == 0
                else None,
                "before": state(rec.get("before")),
                "after": state(rec.get("after"))}
    t_ref = time.perf_counter()
    checks = compare.judge(
        node, config, [batch(r, o) for r, o in zip(warm, replay)],
        state(start_state), [batch(s, s["outputs"]) for s in samples],
        keys, dev, log=log)
    log(f"compare: {time.perf_counter() - t_ref:.3f}s")
    return Outcome(attempted=len(window), failed=0, end_to_end=e2e,
                   per_layer=per_layer, checks=checks,
                   memory_peak_bytes=int(peak), device_extra=extra,
                   breakdown=breakdown)
