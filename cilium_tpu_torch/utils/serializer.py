"""Ordered function execution queue.

Reference: pkg/serializer/func_queue.go — the k8s watcher pushes every
informer event through a FunctionQueue per resource type, so events
apply in arrival order while the informer thread never blocks on the
handler, and a failing handler can be retried with caller-controlled
backoff (WaitFunc).

A whole copy of ``cilium_tpu/utils/serializer.py``.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Callable

# WaitFunc(n_retries) -> True to retry the failed function again.
# Contract: a call with a retry count the caller's budget can never
# reach (the queue uses sys.maxsize on shutdown-discard) means "this
# function will never run — release anything recorded for it".
WaitFunc = Callable[[int], bool]


def no_retry(_n: int) -> bool:
    return False


class FunctionQueue:
    """Executes enqueued functions one at a time, in order.

    ``enqueue(f, wait_func)``: f runs on the worker thread; when it
    raises, wait_func(n) decides whether to re-run (reference
    semantics: WaitFunc returns false -> drop and move on).
    """

    def __init__(self, name: str = "fq"):
        # unbounded: enqueue inserts while holding the _idle lock the
        # worker needs after every function, so a blocking put on a
        # full bounded queue would deadlock the pair
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._idle = threading.Condition()
        self._pending = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"serializer-{name}")
        self._thread.start()

    def enqueue(self, f: Callable[[], None],
                wait_func: WaitFunc = no_retry) -> None:
        # the stop check, pending count, and queue insert share the
        # _idle lock with stop(): without it an item slipped in after
        # stop()'s check is never executed and wait_idle hangs on the
        # orphaned _pending count
        with self._idle:
            if self._stop.is_set():
                raise RuntimeError("FunctionQueue is stopped")
            self._pending += 1
            self._q.put((f, wait_func))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                f, wait = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            retries = 0
            observed = False  # f() completed, or wait_func declined
            while not self._stop.is_set():
                try:
                    f()
                    observed = True
                    break
                except Exception:  # noqa: BLE001 — handler errors are
                    # the caller's to observe via wait_func
                    retries += 1
                    if not wait(retries):
                        observed = True
                        break
            if not observed:
                # stop() raced the dequeue: this item was pulled off
                # the queue but never (finally) executed, so stop()'s
                # drain can't see it — issue the give-up call here so
                # enqueue-time bookkeeping (e.g. the k8s watcher's
                # recorded resourceVersion) is rolled back, not
                # silently skipped
                try:
                    wait(sys.maxsize)
                except Exception:  # noqa: BLE001 — discard must finish
                    pass
            with self._idle:
                self._pending -= 1
                if self._pending == 0:
                    self._idle.notify_all()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until every enqueued function has finished (test and
        shutdown barrier)."""
        with self._idle:
            return self._idle.wait_for(lambda: self._pending == 0,
                                       timeout=timeout)

    def stop(self, drain: bool = True,
             timeout: float = 10.0) -> None:
        if drain:
            self.wait_idle(timeout)
        discarded = []
        with self._idle:
            self._stop.set()
            # anything still queued will never run (non-drain stop, or
            # wait_idle timed out): drop it and zero _pending so
            # wait_idle callers wake instead of timing out
            while True:
                try:
                    discarded.append(self._q.get_nowait())
                except queue.Empty:
                    break
                self._pending -= 1
            if self._pending <= 0:
                self._idle.notify_all()
        # tell each dropped item's wait_func via the give-up call so
        # callers can roll back bookkeeping they did at enqueue time
        # (the k8s watcher un-records the event's resourceVersion on
        # this path).  Outside the _idle lock: wait_funcs take caller
        # locks whose holders may be blocked on _idle in enqueue()
        for _f, wait in discarded:
            try:
                wait(sys.maxsize)
            except Exception:  # noqa: BLE001 — discard must finish
                pass
        self._thread.join(timeout=2.0)
