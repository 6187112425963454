"""Dataplane supervision: device-fault circuit breaking with a
fail-static host fallback and gated recovery.

Port of ``cilium_tpu/datapath/supervisor.py``, wrapped around the
serving dispatcher (``datapath/serving.py``):

- **Fault classification + circuit breaking.**  ``DeviceSupervisor``
  wraps every launch/finalize.  Exceptions are classified transient
  (count toward ``utils/resilience.CircuitBreaker``'s consecutive-failure
  threshold) or fatal (trip it at once); a finalize that outlives the
  watchdog deadline (a hung completion wait) is a fault too, detected by
  running the one blocking wait on a replaceable watchdog worker.
- **Fail-static host fallback.**  While the breaker is open, batches
  are served from the ``HostStaticOracle``: the host CT view keeps
  established flows on their recorded verdicts, and new flows get the
  configured degraded-mode policy (the compiler oracle over the
  host-of-record map states by default, blanket deny/allow if
  configured), by ``pipeline.host_fail_static_step``'s precedence.
- **Gated recovery.**  The breaker's half-open probe first rebuilds the
  device tables from the host-of-record, then replays sampled keys
  through them on the card (``Datapath.policy_replay``); only a passing
  gate lets the probe batch dispatch.  A failing gate re-opens the
  breaker on the doubling cadence.

The fault markers are CUDA's, not XLA's (``classify_fault``).  A sticky
CUDA error leaves the context unusable: every later launch, rebuild and
replay raises, so recovery fails its gate and the lane stays
fail-static; the dispatcher thread never sees the exception.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compiler.policy_tables import oracle_verdict
from ..observability.events import (EVENT_DATAPLANE_DEGRADED,
                                    EVENT_DATAPLANE_FAIL_STATIC,
                                    EVENT_DATAPLANE_REBUILD,
                                    EVENT_DATAPLANE_RECOVERED,
                                    EVENT_DATAPLANE_TRIP,
                                    recorder as flight_recorder)
from ..utils.faultinject import DeviceLaneFault
from ..utils.metrics import (DATAPLANE_DEVICE_FAULTS,
                             DATAPLANE_FAIL_STATIC, DATAPLANE_MODE,
                             DATAPLANE_RECOVERIES,
                             DATAPLANE_SHARD_FAULTS,
                             DATAPLANE_SHARD_MODE)
from ..utils.resilience import (STATE_CLOSED, STATE_HALF_OPEN,
                                CircuitBreaker)
from .codes import VERDICT_DROP, WORLD_IDENTITY
from .pipeline import host_fail_static_step

MODE_OK = "ok"
MODE_DEGRADED = "degraded"
MODE_RECOVERING = "recovering"
_MODE_CODE = {MODE_OK: 0, MODE_DEGRADED: 1, MODE_RECOVERING: 2}

# the reference's defaults, which no caller changes: the breaker's
# longest reset after doubling, the healthy lane's host-view refresh
# period, and the keys the default recovery gate replays
MAX_RESET_S = 30.0
ORACLE_REFRESH_S = 5.0
GATE_SAMPLES = 32

# The CUDA fault markers (the reference names XLA's types and statuses):
# - torch.cuda.OutOfMemoryError is the allocator's RESOURCE_EXHAUSTED:
#   transient, the next batch may fit once tensors are freed;
# - a CUDA runtime error, torch.AcceleratorError where the installed
#   torch has it, else a RuntimeError whose message starts with
#   "CUDA error", is fatal: an illegal address or a launch failure is
#   sticky and leaves the context unusable.
_TRANSIENT_TYPES = (torch.cuda.OutOfMemoryError,)
_FATAL_TYPES = tuple(t for t in (getattr(torch, "AcceleratorError", None),)
                     if t is not None)
_FATAL_MESSAGE_PREFIXES = ("CUDA error",)
# deterministic engine-precondition errors: the device is fine, the
# caller dispatched into an engine that cannot serve (no policy loaded)
# — these keep the plain fail-closed contract and never touch the
# breaker
_CALLER_MARKERS = ("no policy loaded",)


def classify_fault(e: BaseException) -> str:
    """"transient", "fatal", or "caller".  Transient faults count toward
    the breaker's consecutive-failure threshold; fatal ones trip it
    immediately; caller errors (engine preconditions) are not device
    faults at all — they fail closed without breaker accounting."""
    if isinstance(e, DeviceLaneFault):
        return "fatal" if e.fatal else "transient"
    if isinstance(e, _TRANSIENT_TYPES):
        return "transient"
    if isinstance(e, _FATAL_TYPES) or \
            str(e).startswith(_FATAL_MESSAGE_PREFIXES):
        return "fatal"
    if any(m in str(e) for m in _CALLER_MARKERS):
        return "caller"
    return "transient"


# --------------------------------------------------------------------------
# Host fail-static oracle
# --------------------------------------------------------------------------

def _pack_u32(x: int) -> int:
    return x & 0xFFFFFFFF


class HostStaticOracle:
    """Last-known-good host view the degraded lane answers from.

    Three host-of-record pieces, refreshed periodically while the
    device lane is healthy (and best-effort on fault entry):

    - the host CT view (``Datapath.snapshot_ct``): live forward-tuple
      keys -> (expiry, recorded proxy port), so established flows keep
      their verdicts;
    - per-slot ``PolicyMapState``s (``Datapath.host_policy_states``):
      the same states the device tables were compiled from — the
      ``oracle_verdict`` fallback chain over them IS last-known-good
      policy;
    - a host ipcache LPM built from ``Datapath.ipcache_prefixes``.

    ``new_flow_policy``: "oracle" (enforce last-known-good policy on
    host — the fail-static default), "deny" (no new flows while
    degraded), or "allow".
    """

    def __init__(self, datapath, new_flow_policy: str = "oracle"):
        if new_flow_policy not in ("oracle", "deny", "allow"):
            raise ValueError(f"bad new_flow_policy {new_flow_policy!r}")
        self.datapath = datapath
        self.new_flow_policy = new_flow_policy
        self._mu = threading.Lock()
        self._ct: Dict[Tuple[int, int, int, int], Tuple[int, int]] = {}
        self._states: Dict[int, object] = {}
        self._lpm: List[Tuple[int, int, Dict[int, int]]] = []
        self.refreshed_at = 0.0
        self.refreshes = 0

    # ----------------------------------------------------------- refresh

    def refresh(self) -> bool:
        """Rebuild the host view from the live engine.  Returns False
        (keeping the previous view) when the device CT cannot be read
        — a dead device must not wipe the last-known-good state."""
        dp = self.datapath
        states = {int(s): st for s, st in
                  (dp.host_policy_states() or {}).items()}
        lpm = self._compile_host_lpm(dict(dp.ipcache_prefixes))
        try:
            snap, _snap6 = dp.snapshot_ct()
            ct = self._decode_ct(snap)
        except Exception:  # noqa: BLE001 — device read failed: keep
            ct = None      # the last good CT view
        with self._mu:
            self._states = states
            self._lpm = lpm
            if ct is not None:
                self._ct = ct
            self.refreshed_at = time.monotonic()
            self.refreshes += 1
        return ct is not None

    @staticmethod
    def _decode_ct(snap) -> Dict:
        # exclude the sentinel slot (last row), like entry_count
        live = np.flatnonzero(snap["k3"][:-1])

        def col(name, dtype):
            # a memoryview iterates as Python ints, without a numpy
            # scalar a value
            return memoryview(np.ascontiguousarray(
                snap[name][live]).view(dtype))

        keys = zip(col("k0", np.uint32), col("k1", np.uint32),
                   col("k2", np.uint32), col("k3", np.uint32))
        return dict(zip(keys, zip(col("expires", np.int32),
                                  col("proxy_port", np.int32))))

    @staticmethod
    def _compile_host_lpm(prefixes: Dict[str, int]):
        by_plen: Dict[int, Dict[int, int]] = {}
        for cidr, ident in prefixes.items():
            addr, _, plen_s = cidr.partition("/")
            plen = int(plen_s) if plen_s else 32
            a, b, c, d = (int(x) for x in addr.split("."))
            val = (a << 24) | (b << 16) | (c << 8) | d
            mask = 0 if plen == 0 else \
                _pack_u32(0xFFFFFFFF << (32 - plen))
            by_plen.setdefault(plen, {})[val & mask] = int(ident)
        return [(plen, (0 if plen == 0 else
                        _pack_u32(0xFFFFFFFF << (32 - plen))), table)
                for plen, table in sorted(by_plen.items(),
                                          reverse=True)]

    # ------------------------------------------------------ lookups

    def _identity_of(self, addr: int) -> int:
        for _plen, mask, table in self._lpm:
            ident = table.get(addr & mask)
            if ident is not None:
                return ident
        return WORLD_IDENTITY

    def _established(self, sa, da, sp, dp_, proto, direction
                     ) -> Optional[int]:
        now = time.time()
        fwd = (sa, da, _pack_u32((sp & 0xFFFF) << 16 | (dp_ & 0xFFFF)),
               _pack_u32((proto & 0xFF) << 8 | (direction & 1) << 1 | 1))
        hit = self._ct.get(fwd)
        if hit is not None and hit[0] > now:
            return hit[1]  # the flow's recorded verdict (0 = allow)
        rev = (da, sa, _pack_u32((dp_ & 0xFFFF) << 16 | (sp & 0xFFFF)),
               _pack_u32((proto & 0xFF) << 8 |
                         ((1 - direction) & 1) << 1 | 1))
        hit = self._ct.get(rev)
        if hit is not None and hit[0] > now:
            return 0  # reply direction of a live flow: forward it
        return None

    def _policy_verdict(self, slot, ident, dport, proto, direction
                        ) -> int:
        # verdict codes are the device's: <0 drop, 0 allow, >0 proxy
        # port — bit-compatible with what process() would answer
        if self.new_flow_policy == "deny":
            return VERDICT_DROP
        if self.new_flow_policy == "allow":
            return 0
        state = self._states.get(slot)
        if state is None:
            return VERDICT_DROP  # no host-of-record: fail closed
        return oracle_verdict(state, ident, dport, proto, direction)

    def classify(self, soa, n: int):
        """(verdict [n], identity [n]) for one SoA record chunk, by
        the fail-static precedence (pipeline.host_fail_static_step)."""
        with self._mu:
            return host_fail_static_step(
                soa, n, established=self._established,
                identity_of=self._identity_of,
                policy_verdict=self._policy_verdict)

    def stats(self) -> Dict:
        with self._mu:
            return {"ct-entries": len(self._ct),
                    "policy-slots": len(self._states),
                    "ipcache-prefixes": sum(len(t) for _p, _m, t
                                            in self._lpm),
                    "new-flow-policy": self.new_flow_policy,
                    "refreshes": self.refreshes}


# --------------------------------------------------------------------------
# Watchdogged finalize worker
# --------------------------------------------------------------------------

class _WatchdogRunner:
    """Runs one callable at a time on a worker thread with a deadline.
    A call that outlives the deadline marks this runner abandoned —
    the stuck thread is left to die with its call (Python cannot
    interrupt a hung native sync) and the supervisor spawns a fresh
    runner; a late result from an abandoned call is discarded."""

    def __init__(self, name: str):
        self._req: "queue.SimpleQueue" = queue.SimpleQueue()
        self._resp: "queue.SimpleQueue" = queue.SimpleQueue()
        self.abandoned = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            gen, fn = self._req.get()
            if fn is None:
                return
            try:
                out = ("ok", fn())
            except BaseException as e:  # noqa: BLE001 — classified
                out = ("error", e)      # by the supervisor
            self._resp.put((gen, out))

    def run(self, fn: Callable, timeout: float):
        """("ok", result) | ("error", exc) | ("hung", None)."""
        gen = time.monotonic_ns()
        self._req.put((gen, fn))
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.abandoned = True
                return ("hung", None)
            try:
                got_gen, out = self._resp.get(timeout=remaining)
            except queue.Empty:
                self.abandoned = True
                return ("hung", None)
            if got_gen == gen:
                return out
            # stale result from a call a previous owner abandoned

    def close(self) -> None:
        self._req.put((0, None))


# --------------------------------------------------------------------------
# The supervisor
# --------------------------------------------------------------------------

class DeviceSupervisor:
    """Wraps the serving dispatcher's launch/finalize with fault
    classification, circuit breaking, fail-static fallback, and gated
    recovery.  One instance per engine serving lane.

    The dispatcher calls :meth:`launch` / :meth:`finalize`; both
    return ``(True, payload)`` to proceed on the device path, or
    ``(False, (results, error))`` where ``results`` is the fail-static
    answer for the batch (``None`` if the host oracle could not serve,
    in which case the dispatcher falls back to its fail-closed deny).
    """

    def __init__(self, datapath, *, watchdog_s: float = 10.0,
                 failure_threshold: int = 3, reset_s: float = 0.5,
                 new_flow_policy: str = "oracle",
                 recovery_gate: Optional[Callable[[], bool]] = None,
                 shard: Optional[int] = None):
        self.datapath = datapath
        self.watchdog_s = watchdog_s
        # shard scoping (parallel/sharded.py): this supervisor guards
        # ONE ep-shard's engine — its breaker, watchdog, fault
        # accounting and fail-static fallback cover only endpoints
        # mapped to that shard; sibling shards keep serving on device
        self.shard = shard
        self._name = "dataplane" if shard is None else \
            f"dataplane-shard{shard}"
        self.oracle = HostStaticOracle(datapath,
                                       new_flow_policy=new_flow_policy)
        self.breaker = CircuitBreaker(
            self._name, failure_threshold=failure_threshold,
            reset_timeout=reset_s, max_reset=MAX_RESET_S)
        self._recovery_gate = recovery_gate
        self._hook = None  # chaos hand: utils/faultinject injector
        self._runner: Optional[_WatchdogRunner] = None
        self._probing = False
        self._refreshing = threading.Lock()
        self._mode = MODE_OK
        self._set_mode_gauge(0.0)
        # observability
        self.fail_static_batches = 0
        self.fail_static_records = 0
        self.faults: Dict[str, int] = {}
        self.recoveries = 0
        self.last_fault: Optional[str] = None
        # flight recorder: the first fail-static batch of each
        # degradation window is an event; subsequent batches are the
        # steady degraded state, not transitions
        self._static_reported = False

    # ----------------------------------------------------------- chaos

    def install_fault_hook(self, hook) -> None:
        """Arm a DeviceFaultInjector (utils/faultinject) — the chaos
        hand's device-lane entry point.  The injector inherits this
        supervisor's shard scope: its faults land on exactly this
        shard's launches/finalizes."""
        if hasattr(hook, "shard"):
            hook.shard = self.shard
        self._hook = hook

    # ------------------------------------------------------------ mode

    @property
    def mode(self) -> str:
        state = self.breaker.state
        if state == STATE_CLOSED:
            return MODE_OK
        if state == STATE_HALF_OPEN:
            return MODE_RECOVERING
        return MODE_DEGRADED

    def _set_mode_gauge(self, code: float) -> None:
        if self.shard is None:
            DATAPLANE_MODE.set(code)
        else:
            # shard-scoped lanes report per shard; the aggregate
            # dataplane_mode is maintained by the sharded plane
            DATAPLANE_SHARD_MODE.set(code,
                                     labels={"shard": str(self.shard)})

    def _sync_mode(self) -> None:
        mode = self.mode
        if mode != self._mode:
            prev, self._mode = self._mode, mode
            self._set_mode_gauge(float(_MODE_CODE[mode]))
            # flight recorder: mode flips ARE the incident timeline's
            # spine (trip -> degraded -> fail-static -> rebuild ->
            # recovered)
            if mode == MODE_DEGRADED:
                flight_recorder.record(
                    EVENT_DATAPLANE_DEGRADED,
                    detail=self.last_fault or "", shard=self.shard,
                    breaker=self.breaker.state)
            elif mode == MODE_OK and prev != MODE_OK:
                flight_recorder.record(
                    EVENT_DATAPLANE_RECOVERED, shard=self.shard,
                    recoveries=self.recoveries,
                    fail_static_records=self.fail_static_records)
                self._static_reported = False

    # --------------------------------------------------------- dispatch

    def launch(self, launch_fn: Callable, items, total: int):
        if not self.breaker.allow():
            return False, self._serve_static(items, total)
        if self.breaker.state == STATE_HALF_OPEN:
            # we carry the single probe: table rebuild + drift gate
            # must pass BEFORE any batch goes back to the device
            self._probing = True
            self._sync_mode()
            if not self._recover():
                self.breaker.record_failure()
                self._probing = False
                self._sync_mode()
                return False, self._serve_static(items, total)
        try:
            if self._hook is not None:
                self._hook.on_launch()
            return True, launch_fn(items, total)
        except Exception as e:  # noqa: BLE001 — classified below
            if classify_fault(e) == "caller":
                # engine precondition, not a device fault: keep the
                # plain fail-closed contract (deny + error on ticket)
                return False, (None, e)
            self._on_fault("launch", e)
            return False, self._serve_static(items, total)

    def finalize(self, finalize_fn: Callable, handle, weights, items):
        hook = self._hook

        def run():
            if hook is not None:
                hook.on_finalize()
            return finalize_fn(handle, weights)

        if not self.watchdog_s:
            try:
                results = run()
            except Exception as e:  # noqa: BLE001 — classified below
                if classify_fault(e) == "caller":
                    return False, (None, e)
                self._on_fault("finalize", e)
                return False, self._serve_static(items, sum(weights))
            self._on_success()
            return True, results
        if self._runner is None or self._runner.abandoned:
            self._runner = _WatchdogRunner(f"{self._name}-watchdog")
        status, payload = self._runner.run(run, self.watchdog_s)
        if status == "ok":
            self._on_success()
            return True, payload
        if status == "hung":
            self._on_fault("finalize", TimeoutError(
                f"finalize outlived watchdog ({self.watchdog_s}s)"),
                kind="hung")
        elif classify_fault(payload) == "caller":
            return False, (None, payload)
        else:
            self._on_fault("finalize", payload)
        return False, self._serve_static(items, sum(weights))

    # ------------------------------------------------- fault accounting

    def _on_fault(self, stage: str, e: BaseException,
                  kind: Optional[str] = None) -> None:
        kind = kind or classify_fault(e)
        self.faults[kind] = self.faults.get(kind, 0) + 1
        self.last_fault = f"{stage}: {e!r}"
        flight_recorder.record(EVENT_DATAPLANE_TRIP,
                               detail=self.last_fault,
                               shard=self.shard, stage=stage,
                               kind=kind)
        DATAPLANE_DEVICE_FAULTS.inc(labels={"stage": stage,
                                            "kind": kind})
        if self.shard is not None:
            DATAPLANE_SHARD_FAULTS.inc(
                labels={"shard": str(self.shard), "kind": kind})
        if kind == "transient":
            self.breaker.record_failure()
        else:
            self.breaker.trip()
        self._probing = False
        if self.breaker.state != STATE_CLOSED and \
                not self.oracle.refreshes:
            # entering degraded with no host view yet: best-effort
            # refresh (an injected fault leaves the device readable; a
            # real device loss keeps whatever was seeded earlier)
            self.oracle.refresh()
        self._sync_mode()

    def _on_success(self) -> None:
        closed_before = self.breaker.state == STATE_CLOSED
        self.breaker.record_success()
        if self._probing and not closed_before:
            self._probing = False
            self.recoveries += 1
            DATAPLANE_RECOVERIES.inc()
        self._sync_mode()
        if time.monotonic() - self.oracle.refreshed_at > ORACLE_REFRESH_S:
            self._refresh_async()

    def _refresh_async(self) -> None:
        """Periodic host-view refresh OFF the dispatcher thread — a
        CT snapshot + decode must never ride the serving hot path."""
        if not self._refreshing.acquire(blocking=False):
            return  # a refresh is already in flight

        def run():
            try:
                self.oracle.refresh()
            except Exception:  # noqa: BLE001 — a failed refresh keeps
                pass           # the last good view
            finally:
                self._refreshing.release()

        threading.Thread(target=run, daemon=True,
                         name=f"{self._name}-oracle-refresh").start()

    # ------------------------------------------------------ fail-static

    def _serve_static(self, items, total: int):
        """The degraded answer for one batch: per-item fail-static
        results, or (None, error) when the oracle cannot serve."""
        self._sync_mode()
        if not self.oracle.refreshes:
            # never seeded: best-effort refresh — even with the CT
            # view unreadable (real device loss), the policy states
            # and host ipcache still serve last-known-good policy
            try:
                self.oracle.refresh()
            except Exception as e:  # noqa: BLE001 — no host view at
                return None, e      # all: fail closed
        try:
            # items are (soa, n[, payload]) chunks; the host oracle
            # answers policy, not L7 — fast-eligible flows degrade to
            # their redirect verdict (fail-to-redirect holds degraded)
            results = [self.oracle.classify(item[0], item[1])
                       for item in items]
        except Exception as e:  # noqa: BLE001 — a broken oracle must
            return None, e      # fall back to fail-closed deny
        self.fail_static_batches += 1
        self.fail_static_records += total
        DATAPLANE_FAIL_STATIC.inc(total)
        if not self._static_reported:
            # first fail-static batch of this degradation window
            self._static_reported = True
            flight_recorder.record(EVENT_DATAPLANE_FAIL_STATIC,
                                   shard=self.shard, records=total,
                                   new_flow_policy=self.oracle
                                   .new_flow_policy)
        return results, None

    # --------------------------------------------------------- recovery

    def _recover(self) -> bool:
        """Rebuild device tables from the host-of-record, then gate on
        a drift-audit replay.  True admits the probe batch."""
        dp = self.datapath
        try:
            if getattr(dp, "_table_mgr", None) is not None:
                # force_rebuild: recovery must regenerate the packed
                # dispatch buffers too — a corrupted device buffer is
                # exactly what the fast (write-through) path would keep
                dp.refresh_policy(force_rebuild=True)
            else:
                dp.reload_services()  # full rebuild from compiled
        except Exception as e:  # noqa: BLE001 — rebuild failed: the
            self.last_fault = f"recovery-rebuild: {e!r}"
            flight_recorder.record(EVENT_DATAPLANE_REBUILD,
                                   detail=self.last_fault,
                                   shard=self.shard,
                                   result="rebuild-failed")
            return False
        gate = self._recovery_gate or self._default_gate
        try:
            ok = bool(gate())
        except Exception as e:  # noqa: BLE001 — a gate that raises is
            self.last_fault = f"recovery-gate: {e!r}"
            flight_recorder.record(EVENT_DATAPLANE_REBUILD,
                                   detail=self.last_fault,
                                   shard=self.shard,
                                   result="gate-raised")
            return False        # a gate that failed
        flight_recorder.record(
            EVENT_DATAPLANE_REBUILD, shard=self.shard,
            result="ok" if ok else "gate-failed",
            detail="" if ok else (self.last_fault or ""))
        return ok

    def _default_gate(self) -> bool:
        """Self-contained drift replay: sample installed keys from the
        host-of-record states, replay them through the freshly rebuilt
        device tables (``Datapath.policy_replay``, on the card), and
        require verdict parity with the compiler oracle."""
        states = self.datapath.host_policy_states() or {}
        rows = []
        for slot, state in sorted(states.items()):
            for key in list(state.keys())[:4]:
                rows.append((slot, state, key))
            if len(rows) >= GATE_SAMPLES:
                break
        if not rows:
            return True  # nothing installed: nothing to diverge
        replayed = self.datapath.policy_replay(
            [r[0] for r in rows],
            [r[2].identity for r in rows],
            [r[2].dest_port for r in rows],
            [r[2].nexthdr for r in rows],
            [r[2].direction for r in rows])
        for (slot, state, key), dev in zip(rows, replayed):
            want = oracle_verdict(state, key.identity, key.dest_port,
                                  key.nexthdr, key.direction)
            if int(dev["verdict"]) != int(want):
                self.last_fault = (
                    f"recovery-gate: drift at slot {slot} {key}: "
                    f"device {dev['verdict']} != oracle {want}")
                return False
        return True

    # ---------------------------------------------------------- status

    def stats(self) -> Dict:
        return {"mode": self.mode,
                "shard": self.shard,
                "breaker": self.breaker.state,
                "probe-in": round(self.breaker.retry_in(), 3),
                "faults": dict(self.faults),
                "last-fault": self.last_fault,
                "fail-static": {
                    "batches": self.fail_static_batches,
                    "records": self.fail_static_records},
                "recoveries": self.recoveries,
                "oracle": self.oracle.stats()}
