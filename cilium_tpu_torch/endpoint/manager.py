"""Endpoint registry + parallel regeneration build queue.

A whole copy of ``cilium_tpu/endpoint/manager.py``.

Reference: pkg/endpointmanager (registry, RegenerateAllEndpoints),
daemon/daemon.go:1133 StartEndpointBuilders (>=4 parallel workers) and
pkg/buildqueue (per-endpoint build serialization with coalescing: a
build requested while one is queued folds into it; a build requested
while one is *running* queues exactly one follow-up).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

from ..utils.metrics import (ENDPOINT_COUNT, ENDPOINT_REGENERATION_COUNT,
                             ENDPOINT_REGENERATION_TIME)
from .endpoint import Endpoint, EndpointState

MIN_BUILDERS = 4  # reference: daemon.go:1133 numWorkerThreads floor


class EndpointManager:
    """Registry by id / container name + the build queue."""

    def __init__(self, regenerate_fn: Optional[Callable[[Endpoint], None]]
                 = None, builders: int = MIN_BUILDERS,
                 on_outcome: Optional[Callable[[int, bool], None]] = None):
        self._lock = threading.RLock()
        self._by_id: Dict[int, Endpoint] = {}
        self._by_container: Dict[str, Endpoint] = {}
        self.regenerate_fn = regenerate_fn
        # (endpoint_id, ok) observer — the daemon feeds the monitor's
        # AgentNotify regenerate success/fail events from here
        self.on_outcome = on_outcome
        # build queue state (buildqueue semantics)
        self._queue: "queue.Queue[int]" = queue.Queue()
        self._queued: set = set()     # ids with a pending queue slot
        self._building: set = set()   # ids currently building
        self._rebuild: set = set()    # ids needing a follow-up build
        self._qlock = threading.Lock()
        self._idle = threading.Condition(self._qlock)
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"ep-builder-{i}")
            for i in range(max(MIN_BUILDERS, builders))]
        for w in self._workers:
            w.start()

    # ---------------------------------------------------------- registry

    def insert(self, ep: Endpoint) -> None:
        with self._lock:
            self._by_id[ep.id] = ep
            if ep.container_name:
                self._by_container[ep.container_name] = ep
            ENDPOINT_COUNT.set(len(self._by_id))

    def remove(self, endpoint_id: int) -> Optional[Endpoint]:
        with self._lock:
            ep = self._by_id.pop(endpoint_id, None)
            if ep is not None and ep.container_name:
                self._by_container.pop(ep.container_name, None)
            ENDPOINT_COUNT.set(len(self._by_id))
            return ep

    def lookup(self, endpoint_id: int) -> Optional[Endpoint]:
        with self._lock:
            return self._by_id.get(endpoint_id)

    def lookup_container(self, name: str) -> Optional[Endpoint]:
        with self._lock:
            return self._by_container.get(name)

    def endpoints(self) -> List[Endpoint]:
        with self._lock:
            return list(self._by_id.values())

    def __len__(self):
        with self._lock:
            return len(self._by_id)

    # ------------------------------------------------------- build queue

    def queue_regeneration(self, endpoint_id: int) -> bool:
        """Enqueue a build for one endpoint. Coalesces: pending builds
        fold, a build during an active build queues one follow-up.
        Returns False if it folded into an existing request."""
        with self._qlock:
            if endpoint_id in self._building:
                self._rebuild.add(endpoint_id)
                return False
            if endpoint_id in self._queued:
                return False
            self._queued.add(endpoint_id)
            self._queue.put(endpoint_id)
            return True

    def regenerate_all(self, reason: str = "") -> int:
        """Reference: endpointmanager RegenerateAllEndpoints (fired by
        TriggerPolicyUpdates). Returns the number of builds enqueued."""
        n = 0
        for ep in self.endpoints():
            ep.set_state(EndpointState.WAITING_TO_REGENERATE,
                         reason or "regenerate-all")
            if self.queue_regeneration(ep.id):
                n += 1
        return n

    def building(self) -> set:
        """The ids of the endpoints whose build is running now."""
        with self._qlock:
            return set(self._building)

    def wait_for_quiesce(self, timeout: float = 30.0) -> bool:
        """Block until no builds are queued or running (test barrier)."""
        with self._idle:
            return self._idle.wait_for(
                lambda: not self._queued and not self._building and
                not self._rebuild, timeout=timeout)

    def shutdown(self) -> None:
        self._stop.set()
        for _ in self._workers:
            self._queue.put(-1)
        for w in self._workers:
            w.join(timeout=5)

    def _worker(self) -> None:
        while not self._stop.is_set():
            ep_id = self._queue.get()
            if ep_id < 0:
                return
            with self._qlock:
                self._queued.discard(ep_id)
                self._building.add(ep_id)
            try:
                self._build_one(ep_id)
            except Exception:
                pass  # _build_one accounts failures; keep the worker alive
            finally:
                with self._qlock:
                    self._building.discard(ep_id)
                    if ep_id in self._rebuild:
                        self._rebuild.discard(ep_id)
                        self._queued.add(ep_id)
                        self._queue.put(ep_id)
                    self._idle.notify_all()

    def _build_one(self, ep_id: int) -> None:
        ep = self.lookup(ep_id)
        if ep is None or self.regenerate_fn is None:
            return
        if not ep.set_state(EndpointState.REGENERATING, "build queue"):
            # disconnecting/disconnected endpoints drop the build; any
            # other blocked state is accounted so it can't vanish silently
            if ep.state not in (EndpointState.DISCONNECTING,
                                EndpointState.DISCONNECTED):
                ENDPOINT_REGENERATION_COUNT.inc(
                    labels={"outcome": "skipped-state"})
            return
        ok = False
        import time
        t0 = time.perf_counter()
        try:
            self.regenerate_fn(ep)
            ok = True
        finally:
            ENDPOINT_REGENERATION_COUNT.inc(
                labels={"outcome": "success" if ok else "failure"})
            ENDPOINT_REGENERATION_TIME.observe(time.perf_counter() - t0)
            ep.set_state(EndpointState.READY if ok
                         else EndpointState.NOT_READY, "build done")
            if self.on_outcome is not None:
                try:
                    self.on_outcome(ep_id, ok)
                except Exception:  # noqa: BLE001 — observer must not
                    pass           # poison the build pipeline
