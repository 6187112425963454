"""Host fast path: the eBPF-hit-path stand-in over the C++ cache.

Reference architecture (SURVEY §2.8): the in-kernel policymap serves
per-packet verdicts; the TPU engine wins on bulk throughput. Here the
native VerdictCache plays the policymap role per endpoint — the full
3-stage fallback of bpf/lib/policy.h:46 __policy_can_access evaluated
host-side in three batched C++ lookups — so small/latency-critical
batches never pay a device round trip, and the result provably matches
the device tables (same packed keys, same hash).

A copy of ``cilium_tpu/native/fastpath.py`` over the port's own g++
build of ``runtime.cc``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from ..compiler.policy_tables import pack_key
from ..policy.mapstate import PolicyMapState
from . import VerdictCache, load

VERDICT_DROP = -1


class _Scratch:
    """Preallocated request/response buffers + their ctypes pointers.

    Creating a ``ctypes`` POINTER object per array per call costs
    ~2µs each with multi-µs p99 outliers — measured as the dominant
    term of the classify path (5 pointer wraps ≈ 11µs p50 / 34µs p99
    at b256 on this box, vs 3.2µs/8.9µs for the native call itself).
    Wrapping the pointers ONCE and memcpy-ing inputs into pinned
    buffers (4×1KiB at b256) buys the <50µs p99 target its structural
    margin."""

    def __init__(self, cap: int):
        self.cap = cap
        self.ident = np.empty(cap, np.uint32)
        self.dport = np.empty(cap, np.int32)
        self.proto = np.empty(cap, np.int32)
        self.dirn = np.empty(cap, np.int32)
        self.out = np.empty(cap, np.int32)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_u32 = ctypes.POINTER(ctypes.c_uint32)
        self.p_ident = self.ident.ctypes.data_as(p_u32)
        self.p_dport = self.dport.ctypes.data_as(p_i32)
        self.p_proto = self.proto.ctypes.data_as(p_i32)
        self.p_dirn = self.dirn.ctypes.data_as(p_i32)
        self.p_out = self.out.ctypes.data_as(p_i32)


class HostVerdictPath:
    """Per-endpoint C++ verdict caches + batched 3-stage evaluation."""

    def __init__(self, slots_per_endpoint: int = 1 << 14,
                 scratch_batch: int = 4096):
        # force the native build NOW so callers' optional-probe
        # try/except actually engages when g++/dlopen fails
        self._lib = load()
        self.slots = slots_per_endpoint
        self._lock = threading.Lock()
        self._caches: Dict[int, VerdictCache] = {}
        self._scratch = _Scratch(scratch_batch)

    def sync_endpoint(self, endpoint_id: int,
                      state: PolicyMapState) -> None:
        """Realize one endpoint's map state: build a fresh cache and
        swap it in (double-buffered, like the device-table swap), so a
        concurrent classify never observes a half-populated table. The
        old cache is released by refcount — an in-flight classify keeps
        it alive until it finishes."""
        cache = VerdictCache(self.slots)
        if state:
            packed = [pack_key(k) for k in state]
            cache.update_batch(
                np.array([p[0] for p in packed], np.uint32),
                np.array([p[1] for p in packed], np.uint32),
                np.array([v.proxy_port for v in state.values()],
                         np.int32))
        with self._lock:
            self._caches[endpoint_id] = cache

    def remove_endpoint(self, endpoint_id: int) -> None:
        """Drop the endpoint's cache; the C++ object is freed when the
        last in-flight user releases it (VerdictCache.__del__)."""
        with self._lock:
            self._caches.pop(endpoint_id, None)

    def classify(self, endpoint_id: int, identity: np.ndarray,
                 dport: np.ndarray, proto: np.ndarray,
                 direction: np.ndarray) -> Optional[np.ndarray]:
        """3-stage verdict for one endpoint's batch; None if the
        endpoint has no cache. Returns int32 verdicts: -1 drop, 0
        allow, >0 proxy port — identical to the device kernel.

        The whole exact -> L3-only -> L4-wildcard fallback runs in ONE
        native call (vc_classify_batch): one lock acquisition, zero
        per-stage Python/numpy round trips, which is what keeps the
        small-batch latency under the device round trip.  Batches up
        to ``scratch_batch`` go through preallocated buffers with
        pre-wrapped ctypes pointers (see _Scratch); the lock is held
        across the native call so the shared scratch (and the cache
        swap in sync_endpoint) stay race-free — uncontended acquire is
        ~0.1µs, three orders under the pointer-wrapping it replaces."""
        n = len(identity)
        s = self._scratch
        with self._lock:
            cache = self._caches.get(endpoint_id)
            if cache is None:
                return None
            if n <= s.cap:
                s.ident[:n] = identity
                s.dport[:n] = dport
                s.proto[:n] = proto
                s.dirn[:n] = direction
                self._lib.vc_classify_batch(
                    cache._h, s.p_ident, s.p_dport, s.p_proto,
                    s.p_dirn, n, s.p_out)
                return s.out[:n].copy()
        return cache.classify_batch(identity, dport, proto, direction)

    def stats(self) -> Dict[int, Dict]:
        with self._lock:
            return {ep: {"entries": len(c), "slots": c.slots}
                    for ep, c in self._caches.items()}

    def close(self) -> None:
        """Shutdown path only: callers must have quiesced classifiers
        (a classify concurrent with close would use a freed handle)."""
        with self._lock:
            caches = list(self._caches.values())
            self._caches.clear()
        for c in caches:
            c.close()
