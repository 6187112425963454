"""The latency-tier serving path: continuous micro-batching with an
async, double-buffered dispatch core, on CUDA streams.

Port of ``cilium_tpu/datapath/serving.py``.  Every submitter enqueues
record chunks into one shared :class:`VerdictDispatcher`; concurrent
submitters coalesce into one ``Datapath.process_packed`` launch, and
tickets map the results back to exactly the submitted records.

The reference leans on JAX's asynchronous dispatch; here the same
properties come from one CUDA stream (the engine device's current
stream, which every thread of the process shares) and events:

* **Launch** packs the coalesced records into a page-locked [10, rows]
  staging matrix of the batch's bucket (and the [rows, W] payload lane
  when the engine's L7 fast verdict is on), queues one non-blocking
  host-to-device copy of each, the step, and non-blocking
  device-to-host copies of ``verdict`` and ``identity`` into a
  page-locked [2, rows] output matrix, then records one event.  Nothing
  on this path waits for the card.
* **Complete** waits on that event (the path's one blocking boundary,
  ``pipeline_stage_seconds{stage="complete"}``, under the supervisor's
  watchdog) and slices the output matrix per ticket.
* Up to ``depth`` batches stay in flight, so batch N+1 is packed and
  queued while batch N runs on the card.  Whether that overlaps depends
  on the launch queue: a step of more kernels than it holds blocks in
  ``cudaLaunchKernel`` inside ``process_packed`` (``dispatch``).

Failure semantics as in the reference: a dispatch (or completion) that
raises fails closed, denying exactly that batch's frames; with a
``DeviceSupervisor`` (``datapath/supervisor.py``) device faults are
served fail-static from the host oracle instead, and breaker-gated
recovery brings the device lane back.  Admission control: the pending
queue is weight-bounded (``max_pending``, overflow shed at submit),
tickets may carry a deadline (expired work shed at drain), and a
hysteresis watermark pair flips ``dataplane_overloaded``.

Sync-point discipline: the only wait for the card on this path is the
event wait in ``_finalize_records``; tests/test_torch_sync_lint.py
holds the module to it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import host_buffer
from ..observability.events import (EVENT_SERVING_OVERLOAD,
                                    recorder as flight_recorder)
from ..observability.slo import slo_tracker
from ..observability.stages import record_stage
from ..utils.bucketing import bucket_size
from ..utils.metrics import DATAPLANE_OVERLOADED, registry
from .events import DROP_POLICY
from .pipeline import PACKED_FIELDS

SERVING_BATCHES = registry.counter(
    "serving_batches_total",
    "Device launches issued by the continuous micro-batching "
    "dispatcher, by lane")
SERVING_FRAMES = registry.counter(
    "serving_frames_total",
    "Frames (submissions) coalesced through the serving dispatcher, "
    "by lane")
SERVING_SHED = registry.counter(
    "serving_shed_total",
    "Frames shed fail-closed by serving admission control, by lane "
    "and reason (overflow / deadline / closed)")

# the overload watermarks, as fractions of ``max_pending`` (the
# reference's defaults): the lane reads overloaded from the high mark
# until the pending weight drains to the low one
OVERLOAD_HIGH = 0.75
OVERLOAD_LOW = 0.25


class ShedError(RuntimeError):
    """The frame was shed by admission control (queue overflow or an
    expired ticket deadline) — fail-closed, never dispatched."""

    def __init__(self, reason: str):
        super().__init__(f"shed by admission control: {reason}")
        self.reason = reason


class Ticket:
    """One submission's future: resolved by the dispatcher thread with
    the per-frame results (or, on a failed batch, the fail-closed deny
    results plus the error that caused them)."""

    __slots__ = ("_event", "value", "error", "submitted_at",
                 "deadline", "_callbacks", "_cb_lock")

    def __init__(self, deadline: Optional[float] = None):
        self._event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        # absolute monotonic deadline: unserved work older than this
        # is shed at drain time (admission control), never dispatched
        self.deadline = None if deadline is None else \
            time.monotonic() + deadline
        self._callbacks: List[Callable] = []
        self._cb_lock = threading.Lock()

    def resolve(self, value, error: Optional[BaseException] = None
                ) -> None:
        self.value = value
        self.error = error
        # set-then-drain under the callback lock: a concurrent
        # add_done_callback either sees the event and runs its
        # callback itself, or lands in the list we drain here —
        # never neither
        with self._cb_lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad callback must
                pass           # not poison the dispatcher thread

    def add_done_callback(self, cb: Callable) -> None:
        """Run ``cb(ticket)`` on resolution (immediately if already
        resolved) — the asyncio bridge used by VerdictBatcher."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolved.  Fail-closed contract: a failed batch
        still RETURNS (the deny results) — callers that must
        distinguish inspect ``.error`` afterwards."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving ticket not resolved in time")
        return self.value


class ContinuousDispatcher:
    """Generic continuous micro-batching core (one dispatcher thread).

    ``launch(items, total)`` must dispatch the batch WITHOUT device
    synchronization and return an in-flight handle; ``finalize(handle,
    weights)`` performs the one blocking transfer and returns one
    result per item.  ``deny(item)`` builds the fail-closed result for
    one item.  ``weight(item)`` sizes items against ``max_batch``.

    The loop keeps up to ``depth`` launches in flight: while batch N
    computes on device, batch N+1 is drained+packed+launched — the
    double buffer.  Completion happens one batch behind the launch
    front, so the steady-state dispatch loop never blocks on device
    compute between launches.  A launch happens only with fewer than
    ``depth`` batches in flight: every batch ``depth`` or more launches
    older has completed (the staging rings below rely on this).
    """

    def __init__(self, launch: Callable, finalize: Callable,
                 deny: Callable, *, max_batch: int = 1 << 15,
                 depth: int = 2, window: float = 0.0,
                 weight: Callable = lambda item: 1,
                 lane: str = "serving",
                 telemetry: Callable[[], bool] = lambda: True,
                 max_pending: Optional[int] = None,
                 default_deadline: Optional[float] = None,
                 supervisor=None):
        self._launch = launch
        self._finalize = finalize
        self._deny = deny
        self.max_batch = max_batch
        self.depth = max(1, depth)
        self.window = window
        self._weight = weight
        self.lane = lane
        self.family = f"serving-{lane}"
        self._telemetry = telemetry
        self._cond = threading.Condition()
        self._pending: "deque[Tuple[object, Ticket]]" = deque()
        self._inflight: "deque[Tuple[object, list, list]]" = deque()
        self._closed = False
        # ---- admission control: weight-bounded pending queue with a
        # hysteresis overload watermark pair (None = unbounded, the
        # pre-supervision behavior)
        self.max_pending = max_pending
        self.default_deadline = default_deadline
        self._pending_weight = 0
        self._high_mark = None if max_pending is None else \
            max(1, int(max_pending * OVERLOAD_HIGH))
        self._low_mark = None if max_pending is None else \
            max(0, int(max_pending * OVERLOAD_LOW))
        self.overloaded = False
        # ---- device-fault supervision (datapath/supervisor.py):
        # classify faults, fail static from the host oracle, recover
        self.supervisor = supervisor
        # the shard a shard-scoped supervisor guards (parallel/
        # sharded.py), carried into the lane's events and SLO samples
        self._shard = getattr(supervisor, "shard", None)
        # observability: how well the batching is working
        self.batches = 0
        self.frames = 0
        self.items_total = 0
        self.max_batch_seen = 0
        self.errors = 0
        self.static_batches = 0
        self.shed: Dict[str, int] = {}
        self.max_pending_seen = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"serving-{lane}")
        self._thread.start()

    # ------------------------------------------------------------ submit

    def _shed(self, item, ticket: Ticket, reason: str) -> Ticket:
        """Fail the item closed at admission time."""
        self.shed[reason] = self.shed.get(reason, 0) + 1
        SERVING_SHED.inc(labels={"lane": self.lane, "reason": reason})
        ticket.resolve(self._deny(item), ShedError(reason))
        return ticket

    def _set_overloaded_locked(self, value: bool) -> None:
        if value != self.overloaded:
            self.overloaded = value
            DATAPLANE_OVERLOADED.set(1.0 if value else 0.0,
                                     labels={"lane": self.lane})
            # watermark crossings are incident-timeline transitions
            flight_recorder.record(
                EVENT_SERVING_OVERLOAD, shard=self._shard,
                lane=self.lane, state="on" if value else "off",
                pending=self._pending_weight)

    def submit(self, item, deadline: Optional[float] = None) -> Ticket:
        """Queue one item from any thread; returns its Ticket.

        ``deadline`` (seconds from now; falls back to the lane's
        ``default_deadline``) bounds how long the item may wait
        unserved: expired work is shed fail-closed, never dispatched.
        A full pending queue sheds immediately (reason "overflow")."""
        if deadline is None:
            deadline = self.default_deadline
        ticket = Ticket(deadline=deadline)
        w = self._weight(item)
        with self._cond:
            if self._closed:
                ticket.resolve(self._deny(item),
                               RuntimeError("dispatcher closed"))
                return ticket
            if self.max_pending is not None and \
                    self._pending_weight + w > self.max_pending:
                return self._shed(item, ticket, "overflow")
            self._pending.append((item, ticket))
            self._pending_weight += w
            if self._pending_weight > self.max_pending_seen:
                self.max_pending_seen = self._pending_weight
            if self._high_mark is not None and \
                    self._pending_weight >= self._high_mark:
                self._set_overloaded_locked(True)
            self._cond.notify()
        return ticket

    # ----------------------------------------------------- dispatcher loop

    def _take_batch(self, wait: bool):
        """Drain up to ``max_batch`` worth of pending items.  With
        ``wait`` (nothing in flight), blocks for work; a nonzero
        collection ``window`` then lets concurrent submitters pile in
        before the first drain (the ``VerdictBatcher`` micro-batch
        window, paid only from idle); a busy pipeline coalesces
        naturally while batches compute."""
        with self._cond:
            if wait:
                while not self._pending and not self._closed:
                    self._cond.wait()
        if wait and self.window > 0 and not self._closed:
            time.sleep(self.window)
        batch: List[Tuple[object, Ticket]] = []
        expired: List[Tuple[object, Ticket]] = []
        total = 0
        now = time.monotonic()
        with self._cond:
            while self._pending:
                w = self._weight(self._pending[0][0])
                head_deadline = self._pending[0][1].deadline
                if head_deadline is not None and head_deadline <= now:
                    # deadline-aware admission: expired work is shed
                    # fail-closed, never dispatched — a stale verdict
                    # answers nothing and only delays live traffic
                    expired.append(self._pending.popleft())
                    self._pending_weight -= w
                    continue
                if batch and total + w > self.max_batch:
                    break
                item, ticket = self._pending.popleft()
                self._pending_weight -= w
                batch.append((item, ticket))
                total += w
            if self._low_mark is not None and self.overloaded and \
                    self._pending_weight <= self._low_mark:
                self._set_overloaded_locked(False)
        for item, ticket in expired:
            self._shed(item, ticket, "deadline")
        return batch, total

    def _run(self) -> None:
        while True:
            idle = not self._inflight
            with self._cond:
                if self._closed and not self._pending:
                    break
            batch, total = self._take_batch(wait=idle)
            if batch:
                self._launch_batch(batch, total)
            # double buffer: complete the oldest launch only once the
            # pipeline is full (or nothing new arrived) — packing the
            # next batch above overlapped this one's device walk
            if self._inflight and (len(self._inflight) >= self.depth
                                   or not batch):
                self._complete_oldest()
        # shutdown: drain in-flight work, then fail any stragglers
        while self._inflight:
            self._complete_oldest()
        with self._cond:
            leftovers = list(self._pending)
            self._pending.clear()
            self._pending_weight = 0
            if self._low_mark is not None:
                self._set_overloaded_locked(False)
        for item, ticket in leftovers:
            ticket.resolve(self._deny(item),
                           RuntimeError("dispatcher closed"))

    def _launch_batch(self, batch, total: int) -> None:
        telem = self._telemetry()
        t0 = time.perf_counter() if telem else 0.0
        items = [item for item, _t in batch]
        if self.supervisor is not None:
            on_device, payload = self.supervisor.launch(
                self._launch, items, total)
            if not on_device:
                self._resolve_static(batch, payload)
                return
            handle = payload
        else:
            try:
                handle = self._launch(items, total)
            except Exception as e:  # noqa: BLE001 — fail closed: deny
                self._fail(batch, e)   # exactly this batch's frames
                return
        if telem:
            record_stage(self.family, "queue-wait",
                         t0 - batch[0][1].submitted_at)
            record_stage(self.family, "dispatch",
                         time.perf_counter() - t0)
        # SLO flight sample: queue state as of this launch (racy reads
        # are fine — observability, not control flow)
        slo_tracker.sample_queue(self.lane, queued=len(self._pending),
                                 inflight=len(self._inflight),
                                 pending_weight=self._pending_weight,
                                 shard=self._shard)
        self._inflight.append(
            (handle, batch, [self._weight(item) for item, _t in batch]))
        self.batches += 1
        self.frames += len(batch)
        self.items_total += total
        self.max_batch_seen = max(self.max_batch_seen, total)
        SERVING_BATCHES.inc(labels={"lane": self.lane})
        SERVING_FRAMES.inc(len(batch), labels={"lane": self.lane})

    def _complete_oldest(self) -> None:
        handle, batch, weights = self._inflight.popleft()
        telem = self._telemetry()
        t0 = time.perf_counter() if telem else 0.0
        if self.supervisor is not None:
            ok, payload = self.supervisor.finalize(
                self._finalize, handle, weights,
                [item for item, _t in batch])
            if not ok:
                self._resolve_static(batch, payload)
                return
            results = payload
        else:
            try:
                results = self._finalize(handle, weights)
            except Exception as e:  # noqa: BLE001 — fail closed: deny
                self._fail(batch, e)   # exactly this batch's frames
                return
        if telem:
            # the one blocking boundary on this path: host waits out
            # device compute for the batch launched one step earlier
            record_stage(self.family, "complete",
                         time.perf_counter() - t0)
        for (item, ticket), res in zip(batch, results):
            ticket.resolve(res)
        self._observe_slo(batch)

    def _observe_slo(self, batch) -> None:
        """Feed resolved tickets into the serving SLO tier: one
        submit->finalize latency observation per frame, judged against
        the lane's objective (its admission deadline when set)."""
        now = time.perf_counter()
        for _item, ticket in batch:
            slo_tracker.observe(self.lane,
                                now - ticket.submitted_at,
                                shard=self._shard,
                                objective_s=self.default_deadline)

    def _fail(self, batch, error: BaseException) -> None:
        self.errors += 1
        for item, ticket in batch:
            ticket.resolve(self._deny(item), error)
        self._observe_slo(batch)

    def _resolve_static(self, batch, payload) -> None:
        """Resolve one batch with the supervisor's fail-static answer
        (results carry NO error: they are real last-known-good
        verdicts, not denials); an unusable oracle falls back to the
        fail-closed deny contract."""
        results, error = payload
        if results is None:
            self._fail(batch, error or
                       RuntimeError("dataplane degraded"))
            return
        self.static_batches += 1
        self.frames += len(batch)
        for (item, ticket), res in zip(batch, results):
            ticket.resolve(res)
        self._observe_slo(batch)

    # ---------------------------------------------------------- lifecycle

    def stats(self) -> Dict:
        with self._cond:
            queued = len(self._pending)
            pending_weight = self._pending_weight
        out = {"lane": self.lane, "batches": self.batches,
               "frames": self.frames, "items": self.items_total,
               "max_batch": self.max_batch_seen,
               "errors": self.errors, "queued": queued,
               "inflight": len(self._inflight),
               "mean_batch": round(
                   self.items_total / self.batches, 2)
               if self.batches else 0.0,
               # admission control + supervision
               "shed": dict(self.shed),
               "overloaded": self.overloaded,
               "pending-weight": pending_weight,
               "max-pending-seen": self.max_pending_seen,
               "static-batches": self.static_batches}
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
        return out

    def close(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)


class _Slot:
    """One entry of a bucket's staging ring: the page-locked [10, rows]
    batch matrix, the [2, rows] output matrix (verdict, identity), the
    optional [rows, W] payload lane, and the event recorded after the
    last batch that used them (None on the CPU or before first use)."""

    __slots__ = ("stage", "stage_np", "out", "out_np", "pl", "pl_np",
                 "done")

    def __init__(self, rows: int, pinned: bool):
        self.stage, self.stage_np = host_buffer((len(PACKED_FIELDS), rows),
                                                pinned)
        self.out, self.out_np = host_buffer((2, rows), pinned)
        self.pl = self.pl_np = None
        self.done: Optional[torch.cuda.Event] = None

    def payload(self, width: int, pinned: bool) -> np.ndarray:
        rows = self.stage_np.shape[1]
        if self.pl_np is None or self.pl_np.shape[1] != width:
            self.pl, self.pl_np = host_buffer((rows, width), pinned)
        return self.pl_np


class VerdictDispatcher(ContinuousDispatcher):
    """The engine-backed lane: SoA packet-record chunks in, (verdict,
    identity) int32 arrays out, one ``Datapath.process_packed`` launch
    per coalesced batch.

    Padding keeps the verdict-service invariant: batches round up to the
    shared power-of-two bucket (``utils/bucketing.bucket_size``) and pad
    rows duplicate row 0, so padding can never mint new conntrack keys;
    pad results are sliced off before tickets resolve.

    Staging: each bucket has a ring of ``depth + 1`` slots used in turn.
    A slot's host buffers are read by the copies its launch queued until
    that launch's event completes, so a slot must not be refilled
    before then.  Rotation guarantees it on the healthy path: a launch
    happens only with fewer than ``depth`` batches in flight, so the
    batch that last used the slot (``depth + 1`` launches of this bucket
    ago) has completed, and its completion waited on its event.  A batch
    whose completion faulted or was abandoned by the watchdog was not
    waited on; a slot whose event has not completed is therefore
    replaced by a fresh one (``staging_replaced``), never waited on.
    """

    def __init__(self, datapath, *, max_batch: int = 1 << 15,
                 min_rows: int = 16, depth: int = 2,
                 lane: str = "verdict",
                 max_pending: Optional[int] = None,
                 default_deadline: Optional[float] = None,
                 supervisor=None):
        self._datapath = datapath
        self._min_rows = min_rows
        self._pinned = datapath.device.type == "cuda"
        self._rings: Dict[int, List[_Slot]] = {}
        self._ticks: Dict[int, int] = {}
        self.staging_replaced = 0
        super().__init__(self._launch_records, self._finalize_records,
                         self._deny_records, max_batch=max_batch,
                         depth=depth,
                         weight=lambda chunk: chunk[1], lane=lane,
                         telemetry=lambda: getattr(
                             datapath, "telemetry_enabled", False),
                         max_pending=max_pending,
                         default_deadline=default_deadline,
                         supervisor=supervisor)

    def submit_records(self, soa: Dict[str, np.ndarray], n: int,
                       deadline: Optional[float] = None,
                       payload: Optional[np.ndarray] = None) -> Ticket:
        """Queue ``n`` records given as the PacketRing SoA dict (int32
        arrays, caller-owned: they are read once at pack time on the
        dispatcher thread, so hand over fresh arrays, not ring-backed
        views).  ``payload`` is the optional [n, W] int32 L7 payload
        block (``l7/fast.encode_payloads``) riding with the records into
        the fast-verdict stage; None = every L7 rule redirects for these
        records."""
        return self.submit((soa, int(n), payload), deadline=deadline)

    # ------------------------------------------------------------- pack

    def _slot_for(self, rows: int) -> _Slot:
        ring = self._rings.get(rows)
        if ring is None:
            ring = self._rings[rows] = [_Slot(rows, self._pinned)
                                        for _ in range(self.depth + 1)]
            self._ticks[rows] = 0
        tick = self._ticks[rows]
        self._ticks[rows] = tick + 1
        k = tick % len(ring)
        slot = ring[k]
        if slot.done is not None and not slot.done.query():
            # its batch was never waited on (a faulted or abandoned
            # completion): its copies may still be queued
            slot = ring[k] = _Slot(rows, self._pinned)
            self.staging_replaced += 1
        return slot

    def _launch_records(self, items, total: int):
        telem = self._telemetry()
        t0 = time.perf_counter() if telem else 0.0
        dp = self._datapath
        rows = bucket_size(total, self._min_rows)
        slot = self._slot_for(rows)
        stage = slot.stage_np
        width = dp.l7_fast_window()
        pstage = slot.payload(width, self._pinned) if width else None
        off = 0
        for soa, n, pl in items:
            for fi, f in enumerate(PACKED_FIELDS):
                stage[fi, off:off + n] = soa[f][:n]
            if pstage is not None:
                if pl is None:
                    pstage[off:off + n] = -1
                else:
                    w = min(width, pl.shape[1])
                    pstage[off:off + n, :w] = pl[:n, :w]
                    if w < width:
                        pstage[off:off + n, w:] = -1
                    if pl.shape[1] > width:
                        # bytes beyond the engine window: poison the
                        # overflowing rows (fail-to-redirect) instead
                        # of judging a truncated string
                        over = (pl[:n, width:] >= 0).any(axis=1)
                        pstage[off:off + n][over] = -2
            off += n
        # pad rows are copies of the first real record: they re-touch an
        # existing flow's CT entry instead of minting new keys
        stage[:, total:rows] = stage[:, :1]
        if pstage is not None:
            # pad payloads stay absent: a duplicated header row with a
            # real payload could flip the pad's verdict arm
            pstage[total:rows] = -1
        if telem:
            record_stage(self.family, "pack", time.perf_counter() - t0)
        dev = dp.device
        packed = slot.stage.to(dev, non_blocking=True)
        payload = None if pstage is None else \
            slot.pl.to(dev, non_blocking=True)
        verdict, _event, identity, _nat = dp.process_packed(
            packed, payload=payload)
        slot.out[0].copy_(verdict, non_blocking=True)
        slot.out[1].copy_(identity, non_blocking=True)
        if dev.type == "cuda":
            slot.done = torch.cuda.Event()
            slot.done.record(torch.cuda.current_stream(dev))
        return slot, slot.done

    def _finalize_records(self, handle, weights: Sequence[int]):
        slot, done = handle
        if done is not None:
            done.synchronize()  # sync-ok: the serving path's one blocking boundary (stage="complete"): the batch's device-to-host copies
        total = sum(weights)
        v = slot.out_np[0, :total].copy()
        i = slot.out_np[1, :total].copy()
        out = []
        off = 0
        for w in weights:
            out.append((v[off:off + w], i[off:off + w]))
            off += w
        return out

    @staticmethod
    def _deny_records(item):
        n = item[1]
        return (np.full(n, DROP_POLICY, np.int32),
                np.zeros(n, np.int32))
