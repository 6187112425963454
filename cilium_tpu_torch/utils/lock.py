"""Deadlock-detecting locks (pkg/lock/lock.go:21-40).

A whole copy of ``cilium_tpu/utils/lock.py``.

The reference wraps sync.Mutex/RWMutex with go-deadlock under the
"lockdebug" build tag: an acquisition that waits longer than the
detector's timeout reports both stacks (the waiter's and the one the
holder acquired at) and aborts.  These wrappers do the same for
threading locks: every acquisition records the owner and its stack;
an acquire that exceeds ``DEADLOCK_TIMEOUT`` raises
``PotentialDeadlockError`` carrying both stacks instead of hanging the
daemon forever.

Like the reference, detection is opt-in (the "lockdebug" build tag
analog) and decided at LOCK CONSTRUCTION time, exactly like a build
tag: set the ``CILIUM_TPU_LOCKDEBUG`` env var before the process
starts (or ``cilium_tpu_torch.utils.lock.DEBUG = True`` before constructing
the daemon).  With it off (the default) the Mutex/RMutex factories
return raw C-level threading locks — zero overhead, no wait bound.
With it on, any wait past ``DEADLOCK_TIMEOUT`` raises instead of
hanging; a legitimately long hold under debug is expected to trip it,
which is the point of the debug build.  Toggling DEBUG at runtime does
not affect locks that already exist.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import List, Optional

DEADLOCK_TIMEOUT = 30.0
DEBUG = os.environ.get("CILIUM_TPU_LOCKDEBUG", "") not in ("", "0")


class PotentialDeadlockError(RuntimeError):
    """An acquisition waited past the detector timeout."""

    def __init__(self, name: str, waiter_stack: str,
                 holder: Optional[str], holder_stack: Optional[str]):
        self.lock_name = name
        msg = (f"potential deadlock: lock {name!r} not acquired within "
               f"{DEADLOCK_TIMEOUT}s\n--- waiter stack ---\n"
               f"{waiter_stack}")
        if holder is not None:
            msg += (f"--- held by {holder}, acquired at ---\n"
                    f"{holder_stack or '<unknown>'}")
        super().__init__(msg)


def _stack() -> str:
    return "".join(traceback.format_stack(limit=12)[:-2])


class _DebugLockBase:
    """Common owner/stack bookkeeping + timeout acquire."""

    def __init__(self, name: str = "", reentrant: bool = False):
        self.name = name or f"lock@{id(self):x}"
        self._inner = threading.RLock() if reentrant \
            else threading.Lock()
        self._reentrant = reentrant
        # diagnostics (written while holding _inner, read racily on
        # timeout — a torn read only degrades the error message)
        self._owner: Optional[str] = None
        self._owner_stack: Optional[str] = None
        self._depth = 0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not blocking or timeout >= 0:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._note_acquired()
            return got
        got = self._inner.acquire(timeout=DEADLOCK_TIMEOUT)
        if not got:
            raise PotentialDeadlockError(
                self.name, _stack(), self._owner, self._owner_stack)
        self._note_acquired()
        return True

    def _note_acquired(self) -> None:
        self._depth += 1
        if self._depth == 1:
            self._owner = threading.current_thread().name
            self._owner_stack = _stack()

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
            self._owner_stack = None
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._owner is not None


class _DebugMutex(_DebugLockBase):
    """threading.Lock with deadlock detection (lock.go Mutex)."""

    def __init__(self, name: str = ""):
        super().__init__(name, reentrant=False)


class _DebugRMutex(_DebugLockBase):
    """threading.RLock with deadlock detection."""

    def __init__(self, name: str = ""):
        super().__init__(name, reentrant=True)


def Mutex(name: str = ""):  # noqa: N802 — type-factory, lock.go Mutex
    """The build-tag factory: a raw C-level threading.Lock in the
    default build (truly zero overhead on the hot path), the detecting
    wrapper under lockdebug."""
    return _DebugMutex(name) if DEBUG else threading.Lock()


def RMutex(name: str = ""):  # noqa: N802 — type-factory
    return _DebugRMutex(name) if DEBUG else threading.RLock()


class RWMutex:
    """Reader/writer lock with deadlock detection on the writer side
    and reader-acquire (lock.go RWMutex).

    Writer-preferring: a waiting writer blocks new readers, so a
    steady reader stream cannot starve RLock()->Lock() upgrades the
    way a naive implementation would."""

    def __init__(self, name: str = ""):
        self.name = name or f"rwlock@{id(self):x}"
        self._cond = threading.Condition()
        self._readers = 0
        # per-thread read depth: a thread already holding a read lock
        # bypasses the waiting-writer gate on re-acquisition, or the
        # nested-read / waiting-writer pair would deadlock each other
        self._read_counts: dict = {}
        self._writer: Optional[str] = None
        self._writer_stack: Optional[str] = None
        self._writers_waiting = 0

    # ---------------------------------------------------------- writers

    def acquire_write(self) -> None:
        me = threading.current_thread().name
        with self._cond:
            self._writers_waiting += 1
            ok = self._cond.wait_for(
                lambda: self._readers == 0 and self._writer is None,
                timeout=DEADLOCK_TIMEOUT if DEBUG else None)
            self._writers_waiting -= 1
            if not ok:
                raise PotentialDeadlockError(
                    self.name, _stack(), self._writer,
                    self._writer_stack)
            self._writer = me
            self._writer_stack = _stack() if DEBUG else None

    def release_write(self) -> None:
        with self._cond:
            self._writer = None
            self._writer_stack = None
            self._cond.notify_all()

    # ---------------------------------------------------------- readers

    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._read_counts.get(me, 0) > 0:
                # reentrant read: already inside, never gate on
                # waiting writers (they're gated on US finishing)
                self._read_counts[me] += 1
                self._readers += 1
                return
            ok = self._cond.wait_for(
                lambda: self._writer is None and
                self._writers_waiting == 0,
                timeout=DEADLOCK_TIMEOUT if DEBUG else None)
            if not ok:
                raise PotentialDeadlockError(
                    self.name, _stack(), self._writer,
                    self._writer_stack)
            self._readers += 1
            self._read_counts[me] = 1

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            self._readers -= 1
            n = self._read_counts.get(me, 1) - 1
            if n <= 0:
                self._read_counts.pop(me, None)
            else:
                self._read_counts[me] = n
            if self._readers == 0:
                self._cond.notify_all()

    # ------------------------------------------------------ context mgrs

    class _WriteCtx:
        def __init__(self, rw): self.rw = rw  # noqa: E704

        def __enter__(self): self.rw.acquire_write()  # noqa: E704

        def __exit__(self, *e):  # noqa: E704
            self.rw.release_write()
            return False

    class _ReadCtx:
        def __init__(self, rw): self.rw = rw  # noqa: E704

        def __enter__(self): self.rw.acquire_read()  # noqa: E704

        def __exit__(self, *e):  # noqa: E704
            self.rw.release_read()
            return False

    def write_locked(self) -> "_WriteCtx":
        return RWMutex._WriteCtx(self)

    def read_locked(self) -> "_ReadCtx":
        return RWMutex._ReadCtx(self)
