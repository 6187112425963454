"""Control-plane outage survivability: the kvstore outage guard.

A whole copy of ``cilium_tpu/kvstore/outage.py``.

Reference: the defining robustness property of the reference agent is
that the *dataplane* keeps enforcing last-known-good policy through
pinned maps while the *control plane* is down (daemon/state.go restore
semantics, pkg/kvstore's reconnect machinery).  This module gives the
kvstore client the same property:

- ``OutageGuard`` wraps any ``BackendOperations`` and classifies every
  operation's outcome into a breaker (utils/resilience.CircuitBreaker).
  Sustained failure — consecutive op failures, failed idle probes, or
  lease-keepalive failures reported by the transport — flips
  ``kvstore_mode`` to **degraded**.
- While degraded (opt-in): watch-fed consumers (allocator caches,
  ipcache, node registry) pin last-known-good state automatically
  (their streams just go quiet); *mutations* are recorded in a bounded
  per-key-coalescing ``WriteJournal`` instead of failing the caller;
  reads and lock/CAS ops fail fast with ``KVStoreDegradedError`` so
  callers (the identity fallback path) can degrade in microseconds
  instead of per-op timeouts.  Local lease-backed keys are tracked in
  a desired-state registry and are NOT dropped: the reconcile pass
  re-asserts any that the server's lease reaper expired during the
  outage (the lease grace window).
- On reconnect (a half-open probe succeeding), mode becomes
  **reconciling**: the journal replays in sequence order
  (rate-limited), then a relist-and-diff over the tracked prefixes
  repairs divergence between the store and the local desired-state
  registry — the outbound twin of the etcd watcher's compaction
  relist (``etcd.py``), which handles the inbound direction on its own.

With ``degrade=False`` the guard is a pure pass-through that only
keeps last-success/failure bookkeeping — the status() staleness fix —
and is behavior-identical to an unwrapped backend.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..observability.events import (EVENT_KVSTORE_DEGRADED,
                                    EVENT_KVSTORE_RECONCILING,
                                    EVENT_KVSTORE_RECOVERED,
                                    recorder as flight_recorder)
from ..utils.metrics import (KVSTORE_JOURNAL_DEPTH, KVSTORE_MODE,
                             KVSTORE_RECONCILE, KVSTORE_STALENESS)
from ..utils.resilience import CircuitBreaker
from .backend import BackendOperations, Lock, Watcher
from .journal import (OP_CREATE_IF_EXISTS, OP_CREATE_ONLY, OP_DELETE,
                      OP_DELETE_PREFIX, OP_SET, WriteJournal)

MODE_OK = "ok"
MODE_DEGRADED = "degraded"
MODE_RECONCILING = "reconciling"

_MODE_GAUGE = {MODE_OK: 0, MODE_DEGRADED: 1, MODE_RECONCILING: 2}

# cheap read used by idle/half-open probes; never written
PROBE_KEY = "cilium/.outage-probe"


class KVStoreDegradedError(RuntimeError):
    """The kvstore is in degraded mode: the operation cannot be served
    from last-known-good state and was not journaled (reads, locks,
    non-lease CAS creates).  Callers degrade locally — the identity
    path falls back to node-local ephemeral allocation."""


class OutageGuard(BackendOperations):
    """BackendOperations wrapper with outage detection, degraded-mode
    journaling, and reconnect reconciliation."""

    def __init__(self, inner: BackendOperations, degrade: bool = False,
                 failure_threshold: int = 3,
                 probe_interval: float = 0.5, grace_s: float = 60.0,
                 journal_max: int = 8192,
                 replay_ops_per_s: float = 2000.0):
        self.inner = inner
        self.name = inner.name
        self.degrade_enabled = degrade
        self.grace_s = grace_s
        self.probe_interval = probe_interval
        self._replay_sleep = 1.0 / replay_ops_per_s \
            if replay_ops_per_s and replay_ops_per_s > 0 else 0.0
        self._mu = threading.RLock()
        self._mode = MODE_OK
        self._last_ok = time.monotonic()
        self._consecutive_failures = 0
        self._degraded_at: Optional[float] = None
        self._outages = 0
        self._last_reconcile: Optional[Dict] = None
        self.journal = WriteJournal(journal_max)
        # desired state of locally written keys (key -> (value, lease)):
        # lease-backed entries here are what the reconcile re-asserts
        # after a server-side lease expiry during the outage
        self._local_keys: Dict[str, "tuple[bytes, bool]"] = {}
        self._tracked_prefixes: List[str] = []
        self._breaker = CircuitBreaker(
            f"kvstore-{inner.name}",
            failure_threshold=failure_threshold,
            reset_timeout=max(0.05, probe_interval),
            max_reset=max(5.0, probe_interval * 8))
        KVSTORE_MODE.set(0)
        # observe the transport's lease keepalive when it offers the
        # hook (kvstore/etcd.py, kvstore/remote.py): a dying keepalive
        # is an outage signal even when no foreground op is in flight
        if degrade:
            try:
                inner.keepalive_listener = self._keepalive_result
            except AttributeError:
                pass

    # ------------------------------------------------------- detector

    def _keepalive_result(self, ok: bool) -> None:
        if ok:
            self._note_success()
        else:
            self._note_failure()

    def _note_success(self) -> None:
        with self._mu:
            self._last_ok = time.monotonic()
            self._consecutive_failures = 0
            # the breaker always hears about success (a half-open probe
            # carried by a foreground read must close it or it wedges),
            # but MODE only returns to ok through the reconcile path
            self._breaker.record_success()

    def _note_failure(self) -> None:
        with self._mu:
            self._consecutive_failures += 1
            self._breaker.record_failure()
            if self.degrade_enabled and self._mode == MODE_OK and \
                    self._breaker.state != "closed":
                self._set_mode_locked(MODE_DEGRADED)
                self._degraded_at = time.monotonic()
                self._outages += 1
                flight_recorder.record(
                    EVENT_KVSTORE_DEGRADED,
                    detail=f"{self.name}: "
                           f"{self._consecutive_failures} consecutive "
                           f"failures; pinning last-known-good",
                    outage=self._outages,
                    journal_depth=self.journal.depth())

    def _set_mode_locked(self, mode: str) -> None:
        self._mode = mode
        KVSTORE_MODE.set(_MODE_GAUGE[mode])

    @property
    def mode(self) -> str:
        with self._mu:
            return self._mode

    def staleness(self) -> float:
        """Seconds since the last successful operation; 0 while the
        last operation succeeded (the status() contract: a dead
        backend can no longer report 'ok' between calls)."""
        with self._mu:
            if self._consecutive_failures == 0 and \
                    self._mode == MODE_OK:
                return 0.0
            return max(0.0, time.monotonic() - self._last_ok)

    # ----------------------------------------------------- op routing

    def _degraded(self) -> bool:
        with self._mu:
            return self._mode != MODE_OK

    def _read(self, fn: Callable, what: str):
        """Reads: live while ok; while degraded, only the breaker's
        half-open probe slot may try the backend — everyone else fails
        fast (the caches are the degraded read path)."""
        if self._degraded():
            if not self._breaker.allow():
                raise KVStoreDegradedError(
                    f"{self.name}: degraded ({what})")
        try:
            out = fn()
        except Exception:
            self._note_failure()
            raise
        self._note_success()
        return out

    def _mutate(self, op: str, key: str, fn: Callable,
                value: bytes = b"", lease: bool = False,
                cond_key: str = "", journaled_result=None):
        """Mutations: journal while degraded (mode-gated, so replay
        ordering can never interleave with live writes); on a live
        attempt that fails, journal instead of failing the caller —
        the mutation is not lost, it is deferred to the reconcile."""
        if self.degrade_enabled and self._degraded():
            self._journal(op, key, value, lease, cond_key)
            return journaled_result
        try:
            out = fn()
        except Exception:
            self._note_failure()
            if self.degrade_enabled:
                self._journal(op, key, value, lease, cond_key)
                return journaled_result
            raise
        self._note_success()
        # a live write supersedes any pending journaled mutation of the
        # same key (a transient blip may have journaled one without
        # ever flipping the mode)
        self.journal.discard_key(key)
        self._track(op, key, value, lease, result=out)
        return out

    def _journal(self, op, key, value, lease, cond_key) -> None:
        self.journal.record(op, key, value=value, lease=lease,
                            cond_key=cond_key)
        KVSTORE_JOURNAL_DEPTH.set(self.journal.depth())
        self._track(op, key, value, lease, result=True)

    def _track(self, op, key, value, lease, result) -> None:
        """Maintain the desired-state registry of locally written
        keys (what the lease-grace repair re-asserts)."""
        with self._mu:
            if op == OP_SET:
                self._local_keys[key] = (value, lease)
            elif op in (OP_CREATE_ONLY, OP_CREATE_IF_EXISTS):
                if result:
                    self._local_keys[key] = (value, lease)
            elif op == OP_DELETE:
                self._local_keys.pop(key, None)
            elif op == OP_DELETE_PREFIX:
                for k in [k for k in self._local_keys
                          if k.startswith(key)]:
                    del self._local_keys[k]

    # ------------------------------------------------- plain ops

    def get(self, key: str):
        return self._read(lambda: self.inner.get(key), "get")

    def get_prefix(self, prefix: str):
        return self._read(lambda: self.inner.get_prefix(prefix),
                          "get_prefix")

    def list_prefix(self, prefix: str):
        return self._read(lambda: self.inner.list_prefix(prefix),
                          "list_prefix")

    def set(self, key: str, value: bytes, lease: bool = False) -> None:
        return self._mutate(
            OP_SET, key, lambda: self.inner.set(key, value, lease),
            value=value, lease=lease)

    def delete(self, key: str) -> None:
        return self._mutate(OP_DELETE, key,
                            lambda: self.inner.delete(key))

    def delete_prefix(self, prefix: str) -> None:
        return self._mutate(OP_DELETE_PREFIX, prefix,
                            lambda: self.inner.delete_prefix(prefix))

    # ------------------------------------------------- atomic ops

    def create_only(self, key: str, value: bytes,
                    lease: bool = False) -> bool:
        if not lease:
            # a non-lease CAS create (allocator master keys) must not
            # be faked: its boolean answer decides ID ownership.
            # Degraded callers take the local identity fallback instead.
            if self.degrade_enabled and self._degraded():
                raise KVStoreDegradedError(
                    f"{self.name}: degraded (create_only)")
            try:
                out = self.inner.create_only(key, value, lease)
            except Exception:
                self._note_failure()
                raise
            self._note_success()
            return out
        return self._mutate(
            OP_CREATE_ONLY, key,
            lambda: self.inner.create_only(key, value, lease),
            value=value, lease=lease, journaled_result=True)

    def create_if_exists(self, cond_key: str, key: str, value: bytes,
                         lease: bool = False) -> bool:
        if not lease:
            if self.degrade_enabled and self._degraded():
                raise KVStoreDegradedError(
                    f"{self.name}: degraded (create_if_exists)")
            try:
                out = self.inner.create_if_exists(cond_key, key, value,
                                                  lease)
            except Exception:
                self._note_failure()
                raise
            self._note_success()
            return out
        return self._mutate(
            OP_CREATE_IF_EXISTS, key,
            lambda: self.inner.create_if_exists(cond_key, key, value,
                                                lease),
            value=value, lease=lease, cond_key=cond_key,
            journaled_result=True)

    # -------------------------------------------- listing / watching

    def watch(self, prefix: str) -> Watcher:
        return self.inner.watch(prefix)

    def list_and_watch(self, prefix: str) -> Watcher:
        return self.inner.list_and_watch(prefix)

    def _remove_watcher(self, watcher: Watcher) -> None:
        self.inner._remove_watcher(watcher)

    # --------------------------------------------- locks / liveness

    def lock_path(self, path: str, timeout: float = 30.0) -> Lock:
        if self.degrade_enabled and self._degraded():
            raise KVStoreDegradedError(
                f"{self.name}: degraded (lock {path!r})")
        try:
            out = self.inner.lock_path(path, timeout)
        except Exception:
            self._note_failure()
            raise
        self._note_success()
        return out

    def _unlock(self, path: str, token: str) -> None:
        self.inner._unlock(path, token)

    def renew_lease(self) -> None:
        return self._read(lambda: self.inner.renew_lease(),
                          "renew_lease")

    def close(self) -> None:
        self.inner.close()

    def status(self) -> str:
        with self._mu:
            mode, age = self._mode, None
            if self._degraded_at is not None and mode != MODE_OK:
                age = time.monotonic() - self._degraded_at
        if mode != MODE_OK:
            return (f"{self.name}: {mode.upper()} (outage "
                    f"{age:.1f}s, serving last-known-good, "
                    f"{self.journal.depth()} journaled)")
        text = self.inner.status()
        # a dead backend reports 'unreachable' in its status string —
        # feed the detector so staleness/mode reflect it.  (Success is
        # NOT inferred from the text: only real operations and probes
        # reset the staleness clock.)
        if "unreachable" in text:
            self._note_failure()
        return text

    # ------------------------------------------------- tick/reconcile

    def track_prefix(self, prefix: str) -> None:
        """Register a prefix for the reconnect relist-and-diff repair
        (identity slave keys, ipcache entries, node registrations)."""
        with self._mu:
            if prefix not in self._tracked_prefixes:
                self._tracked_prefixes.append(prefix)

    def tick(self) -> Dict:
        """Periodic driver (the daemon's kvstore-outage controller):
        refresh gauges; while ok, probe when idle so an outage is
        detected even with no op flow; while degraded, carry the
        half-open probe and run the reconcile on reconnect.  Returns
        {"reconciled": True, ...} exactly once per recovery."""
        KVSTORE_STALENESS.set(self.staleness())
        KVSTORE_JOURNAL_DEPTH.set(self.journal.depth())
        if not self.degrade_enabled:
            return {}
        with self._mu:
            mode = self._mode
            idle = time.monotonic() - self._last_ok
        if mode == MODE_OK:
            if idle >= self.probe_interval:
                try:
                    self.inner.get(PROBE_KEY)
                    self._note_success()
                except Exception:  # noqa: BLE001 — any failure counts
                    self._note_failure()
            with self._mu:
                # the probe can block for the backend's timeout, and the
                # mode can leave ok meanwhile: what is journaled since
                # then belongs to the reconcile (the reference drains it
                # here on the stale reading, and the reconcile's report
                # then counts none of it replayed)
                still_ok = self._mode == MODE_OK
            if still_ok and self.journal.depth():
                # a transient blip journaled mutations without ever
                # flipping the mode: drain them now
                try:
                    self._drain_journal()
                except Exception:  # noqa: BLE001 — stays queued
                    pass
                KVSTORE_JOURNAL_DEPTH.set(self.journal.depth())
            return {}
        # degraded: only the breaker's half-open slot probes
        if not self._breaker.allow():
            return {}
        try:
            self.inner.get(PROBE_KEY)
        except Exception:  # noqa: BLE001
            self._note_failure()
            return {}
        # reconnected: reconcile before announcing ok
        with self._mu:
            self._set_mode_locked(MODE_RECONCILING)
        flight_recorder.record(
            EVENT_KVSTORE_RECONCILING,
            detail=f"{self.name}: reconnect detected; replaying "
                   f"journal + relist repair",
            journal_depth=self.journal.depth())
        ok = self._reconcile()
        if not ok:
            with self._mu:
                self._set_mode_locked(MODE_DEGRADED)
            self._breaker.trip()
            KVSTORE_RECONCILE.inc(labels={"result": "failed"})
            flight_recorder.record(
                EVENT_KVSTORE_DEGRADED,
                detail=f"{self.name}: reconcile failed mid-replay; "
                       f"journal tail stays queued",
                journal_depth=self.journal.depth())
            return {}
        self._breaker.record_success()
        with self._mu:
            self._set_mode_locked(MODE_OK)
            self._consecutive_failures = 0
            self._last_ok = time.monotonic()
            report = self._last_reconcile
        KVSTORE_RECONCILE.inc(labels={"result": "ok"})
        KVSTORE_STALENESS.set(0.0)
        KVSTORE_JOURNAL_DEPTH.set(self.journal.depth())
        flight_recorder.record(
            EVENT_KVSTORE_RECOVERED, detail=self.name,
            replayed=(report or {}).get("replayed", 0),
            repaired=(report or {}).get("repaired", 0),
            outage_s=(report or {}).get("outage-s", 0.0))
        return {"reconciled": True, "report": report}

    def _reconcile(self) -> bool:
        """Journal replay (in sequence order, rate-limited) followed by
        the relist-and-diff repair of locally owned keys over the
        tracked prefixes — divergence (a lease the server reaped
        mid-outage) is repaired with one re-put per key, never a full
        regeneration storm."""
        t0 = time.monotonic()
        with self._mu:
            outage_s = time.monotonic() - self._degraded_at \
                if self._degraded_at is not None else 0.0
            journal_depth = self.journal.depth()
            overflow = self.journal.dropped
        try:
            replayed, conflicts = self._drain_journal()
            # lease-grace repair: relist each tracked prefix once and
            # re-assert any locally owned key the outage cost us
            repaired, checked = self._repair_local_keys()
        except Exception:  # noqa: BLE001 — backend re-failed mid-
            return False   # reconcile; the journal tail stays queued
        self._last_reconcile = {
            "duration-s": round(time.monotonic() - t0, 4),
            "outage-s": round(outage_s, 3),
            "journal-depth": journal_depth,
            "replayed": replayed,
            "conflicts": conflicts,
            "repaired": repaired,
            "local-keys-checked": checked,
            "journal-overflowed": overflow,
            "exceeded-grace": outage_s > self.grace_s,
        }
        return True

    def _drain_journal(self) -> "tuple[int, int]":
        """Replay pending journal entries in sequence order, looping
        until the journal drains (mutations racing in while replaying
        land in later snapshots).  Raises on a backend failure — the
        unapplied tail stays queued for the next attempt."""
        replayed = conflicts = 0
        while True:
            batch = self.journal.snapshot()
            if not batch:
                return replayed, conflicts
            for entry in batch:
                if entry.op == OP_SET:
                    self.inner.set(entry.key, entry.value, entry.lease)
                elif entry.op == OP_DELETE:
                    self.inner.delete(entry.key)
                elif entry.op == OP_DELETE_PREFIX:
                    self.inner.delete_prefix(entry.key)
                elif entry.op == OP_CREATE_ONLY:
                    if not self.inner.create_only(
                            entry.key, entry.value, entry.lease):
                        conflicts += 1
                elif entry.op == OP_CREATE_IF_EXISTS:
                    if not self.inner.create_if_exists(
                            entry.cond_key, entry.key,
                            entry.value, entry.lease):
                        conflicts += 1
                self.journal.discard(entry)
                replayed += 1
                if self._replay_sleep:
                    time.sleep(self._replay_sleep)

    def _repair_local_keys(self) -> "tuple[int, int]":
        with self._mu:
            tracked = list(self._tracked_prefixes)
            desired = dict(self._local_keys)
        repaired = checked = 0
        actual: Dict[str, bytes] = {}
        covered: List[str] = []
        for prefix in tracked:
            actual.update(self.inner.list_prefix(prefix))
            covered.append(prefix)
        for key, (value, lease) in desired.items():
            in_tracked = any(key.startswith(p) for p in covered)
            checked += 1
            current = actual.get(key) if in_tracked \
                else self.inner.get(key)
            if current != value:
                self.inner.set(key, value, lease)
                repaired += 1
            if self._replay_sleep:
                time.sleep(self._replay_sleep)
        return repaired, checked

    # ------------------------------------------------------ reporting

    def report(self) -> Dict:
        """The status() view: mode, staleness, breaker, journal."""
        with self._mu:
            out = {
                "mode": self._mode,
                "degrade-enabled": self.degrade_enabled,
                "staleness-seconds": round(self.staleness(), 3),
                "consecutive-failures": self._consecutive_failures,
                "breaker": self._breaker.state,
                "outages": self._outages,
                "grace-seconds": self.grace_s,
                "local-keys": len(self._local_keys),
                "last-reconcile": self._last_reconcile,
            }
        out.update({"journal": self.journal.stats(),
                    "journal-depth": self.journal.depth()})
        return out
