"""The lane driver: tickets of packet records through the agent's
serving lane, ``Datapath.serving().submit_records``, which coalesces
concurrent submissions into ``process_packed`` launches.

Load, from the traffic file:

- closed loop: ``submitters`` threads, each keeping ``outstanding``
  tickets of ``records`` records in flight;
- open loop (``rate`` tickets a second): one scheduler submits ticket i
  at ``i / rate`` seconds into the window, whatever is in flight, and
  each ticket is timed from when it was due.

Records come from a ring of ``ring`` generated batches, a ticket's
records the next ``records`` rows of it (its payload rows too, where
the mix has an L7 lane).  ``WARMUP_SECONDS`` of the same load are
served before the window, and a traced run profiles its first
``TRACE_SECONDS``; both are the driver's, the same for every mix.
``verdicts_per_s`` is the records whose tickets resolved inside the
window over its seconds; ``verdict_p95_ms`` the 95th percentile over
every ticket of the window.

The lane stamps each launch with the wall clock and coalesces as the
threads race, so ``correct`` is judged launch by launch: the launch
that the harness wraps around ``process_packed`` keeps every warm-up
launch (replayed by the reference from an empty node) and a reservoir
sample of the window's launches, with the system's state around them.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, generate
from ..harness import Clock, Outcome, RunContext, on_device, power_limit
from ..reference.node import FIELDS

WARMUP_SECONDS = 2.0
TRACE_SECONDS = 3.0
from ..trace import SPAN, DeviceTrace, read_metrics, stage_ranges


class LaunchRecorder:
    """Wraps the engine's ``process_packed``: stamps each launch's time,
    counts launches, keeps every launch while ``keep_all`` and a
    reservoir sample of ``n_samples`` launches while ``sampling``, with
    the system's state before and after each sampled one."""

    def __init__(self, system, n_samples: int, rng):
        self.system = system
        self.dp = system.dp
        self.inner = self.dp.process_packed
        self.n_samples, self.rng = n_samples, rng
        self.calls = 0
        self.seen = 0
        self.keep_all = False
        self.sampling = False
        self.kept: List[Dict] = []
        self.samples: List[Dict] = []
        self.call_ms: List[float] = []
        self.call_rows: List[int] = []
        self.dp.process_packed = self

    def __call__(self, packed, now=None, payload=None):
        now = int(time.time()) if now is None else now
        call = self.calls
        self.calls += 1
        slot = None
        if self.sampling:
            self.seen += 1
            if len(self.samples) < self.n_samples:
                slot = len(self.samples)
            else:
                j = int(self.rng.integers(0, self.seen))
                slot = j if j < self.n_samples else None
        rec = None
        if self.keep_all or slot is not None:
            rec = {"packed": packed.clone(), "now": now, "call": call,
                   "gc": None, "payload": None if payload is None
                   else payload.clone()}
        if slot is not None:
            rec["before"] = self.system.snapshot()
        t = time.perf_counter()
        out = self.inner(packed, now=now, payload=payload)
        self.call_ms.append((time.perf_counter() - t) * 1e3)
        self.call_rows.append(int(packed.shape[1]))
        if rec is not None:
            verdict, event, identity, nat = out
            rec["outputs"] = (verdict, event, identity) + tuple(nat)
            if self.keep_all:
                self.kept.append(rec)
        if slot is not None:
            rec["after"] = self.system.snapshot()
            if slot < len(self.samples):
                self.samples[slot] = rec
            else:
                self.samples.append(rec)
        return out

    def restore(self) -> None:
        self.dp.process_packed = self.inner


class Load:
    """The ticket source: the next ``records`` rows of the ring."""

    def __init__(self, ring: np.ndarray, lanes, records: int):
        self.ring, self.lanes, self.records = ring, lanes, records
        self.pos = 0
        self.lock = threading.Lock()

    def next(self):
        with self.lock:
            pos = self.pos
            self.pos += self.records
        n_ring, _, b = self.ring.shape
        r, off = (pos // b) % n_ring, pos % b
        n = min(self.records, b - off)
        soa = {f: self.ring[r, i, off:off + n].copy()
               for i, f in enumerate(FIELDS)}
        pl = None if self.lanes is None else \
            self.lanes[r, off:off + n].copy()
        return soa, n, pl


class _Stamp:
    """When a ticket resolved: set by its done callback, which the lane
    runs just after the ticket's result is ready."""

    def __init__(self, tk):
        self.at = None
        self.set = threading.Event()
        tk.add_done_callback(self)

    def __call__(self, tk) -> None:
        self.at = time.perf_counter()
        self.set.set()

    def wait(self, tk) -> float:
        tk.result(timeout=120)
        if not self.set.wait(timeout=120):
            raise TimeoutError("a ticket's done callback did not run")
        return self.at


def _closed(lane, load: Load, stop: threading.Event, outstanding: int,
            out: List, errors: List) -> None:
    q = deque()
    try:
        while not stop.is_set():
            if len(q) >= outstanding:
                tk, stamp, t_sub, n = q.popleft()
                out.append((t_sub, stamp.wait(tk), n, tk.error))
            soa, n, pl = load.next()
            t_sub = time.perf_counter()
            tk = lane.submit_records(soa, n, payload=pl)
            q.append((tk, _Stamp(tk), t_sub, n))
        while q:
            tk, stamp, t_sub, n = q.popleft()
            out.append((t_sub, stamp.wait(tk), n, tk.error))
    except Exception as e:  # noqa: BLE001 - reported by the driver
        errors.append(e)


def _open(lane, load: Load, stop: threading.Event, rate: float,
          t0: float, out: List, errors: List) -> None:
    pending = []
    i = 0
    try:
        while not stop.is_set():
            due = t0 + i / rate
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if stop.is_set():
                break
            soa, n, pl = load.next()
            tk = lane.submit_records(soa, n, payload=pl)
            pending.append((tk, _Stamp(tk), due, n))
            i += 1
        for tk, stamp, due, n in pending:
            out.append((due, stamp.wait(tk), n, tk.error))
    except Exception as e:  # noqa: BLE001 - reported by the driver
        errors.append(e)


def _serve(lane, load, traffic, seconds: float, t0: float) -> List:
    """Drive the lane for ``seconds``; (submitted or due, done, records,
    error) of every ticket, once all have resolved."""
    stop = threading.Event()
    out: List = []
    errors: List = []
    if traffic.get("rate"):
        threads = [threading.Thread(
            target=_open, args=(lane, load, stop, traffic["rate"], t0, out,
                                errors))]
    else:
        threads = [threading.Thread(
            target=_closed, args=(lane, load, stop, traffic["outstanding"],
                                  out, errors))
            for _ in range(traffic["submitters"])]
    for th in threads:
        th.start()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    stop.set()
    for th in threads:
        th.join(timeout=300)
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a submitter did not finish")
    return out


def run(ctx: RunContext) -> Outcome:
    cell, dev, log = ctx.cell, ctx.device, ctx.log
    config, traffic = cell.config, cell.traffic
    clock = Clock(dev)
    seeds = generate.seeds_of(ctx.seed, config)
    node = generate.node_state(config["state"], seeds, config.get("l7"))
    restore = stage_ranges(cell.per_layer) if ctx.trace else None
    system = ctx.make_system(node, config, dev)
    n_ring, b = traffic["ring"], traffic["batch"]
    stream = generate.batches(node, traffic, seeds)
    ring = np.empty((n_ring, len(FIELDS), b), np.int32)
    lanes = None
    if traffic.get("l7"):
        table = generate.payload_table(node, traffic)
        lanes = np.empty((n_ring, b, table.shape[1]), np.int32)
    for r in range(n_ring):
        packed, index = next(stream)
        ring[r] = packed
        if lanes is not None:
            np.take(table, index, axis=0, out=lanes[r])
    load = Load(ring, lanes, traffic["records"])
    rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 1]))
    rec = LaunchRecorder(system, compare.SAMPLES, rng)
    lane = system.dp.serving()

    rec.keep_all = True
    warm_s = WARMUP_SECONDS
    _serve(lane, load, traffic, warm_s, time.perf_counter())
    rec.keep_all = False
    clock.sync()
    start_state = on_device(system.snapshot(), "cpu")
    replay = rec.kept
    rec.kept = []

    prof = span = None
    if ctx.trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        span = record_function(SPAN)
        span.__enter__()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx.process_start
    calls0 = rec.calls
    traced = 0
    if ctx.trace:
        trace_s = min(TRACE_SECONDS, ctx.seconds)
        tickets = _serve(lane, load, traffic, trace_s, t_w0)
        clock.sync()
        span.__exit__(None, None, None)
        prof.stop()
        traced = rec.calls - calls0
        n_call_ms = len(rec.call_ms)
        rec.sampling = True
        tickets += _serve(lane, load, traffic, ctx.seconds - trace_s,
                          time.perf_counter())
        untraced_ms = rec.call_ms[n_call_ms:]
    else:
        rec.sampling = True
        tickets = _serve(lane, load, traffic, ctx.seconds, t_w0)
        untraced_ms = rec.call_ms[calls0:]
    rec.sampling = False
    clock.sync()
    rec.restore()
    if restore is not None:
        restore()
    t_end = t_w0 + ctx.seconds
    done_in = sum(n for _, done, n, _ in tickets if done <= t_end)
    lat = np.array([(done - sub) * 1e3 for sub, done, _, _ in tickets])
    failed = sum(1 for *_, err in tickets if err is not None)
    e2e = {"verdicts_per_s": done_in / ctx.seconds,
           "verdict_p95_ms": float(np.percentile(lat, 95)),
           "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    log(f"card: {power_limit()}")
    log(f"window: {len(tickets)} tickets, {rec.calls - calls0} launches, "
        f"latency ms p50 {np.percentile(lat, 50):.3f} p95 "
        f"{e2e['verdict_p95_ms']:.3f} max {lat.max():.3f}; "
        f"{len(replay)} warm-up launches")

    per_layer, extra, breakdown = {}, {}, None
    if prof is not None:
        trace = DeviceTrace(prof, max(traced, 1))
        rows = rec.call_rows[calls0:calls0 + traced] or [0]
        facts = {"batch": sum(rows) / len(rows), "kind":
                 torch.cuda.get_device_name(dev) if clock.cuda else "cpu",
                 "dispatch_ms": untraced_ms,
                 "lane_width": None if lanes is None else lanes.shape[2]}
        per_layer = read_metrics(cell.per_layer, trace, facts)
        extra = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps()}
        del prof, trace

    lane.close()
    keys = system.counter_keys()
    samples = rec.samples
    read_state = system.read_state
    system.close()
    del system, lane, rec
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    for s in samples:
        s["before"] = read_state(on_device(s["before"], dev))
        s["after"] = read_state(on_device(s["after"], dev))
    checks = compare.judge(node, config, replay,
                           read_state(on_device(start_state, dev)), samples,
                           keys, dev, log=log)
    return Outcome(attempted=len(tickets), failed=failed, end_to_end=e2e,
                   per_layer=per_layer, checks=checks,
                   memory_peak_bytes=int(peak), device_extra=extra,
                   breakdown=breakdown)
