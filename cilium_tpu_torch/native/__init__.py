"""Native host runtime: ctypes bindings over ``runtime.cc``.

``runtime.cc`` is a copy of ``cilium_tpu/native/runtime.cc``.  The
shared library is compiled once with ``g++`` at first use (never when
this module is imported) into ``cilium_tpu_torch/_build/``, keyed by a
digest of the source, and loaded with ctypes; a failed build raises.
Bound here:

- ``PKT_HEADER_DTYPE`` and ``check_struct_alignment()``: the numpy
  mirror of the C++ ``PktHeader`` and the check that both agree
  (pkg/alignchecker analog);
- ``PacketRing``: the lock-free SPSC packet-header ring whose drain
  fills struct-of-arrays int32 arrays, the verdict service's ingest
  tier;
- ``VerdictCache``: the exact-match (key_a, key_b) -> verdict cache with
  the whole three-stage ``__policy_can_access`` fallback in one call,
  under the host fast path (``native/fastpath.HostVerdictPath``);
- ``ScalarDFA``: the host walk of one byte string over a compiled
  stacked DFA table, the single-request tier of the HTTP and DNS
  engines (``check_one`` / ``allowed_one``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "runtime.cc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# numpy mirror of struct PktHeader (runtime.cc), verified against the
# compiled layout by check_struct_alignment()
PKT_HEADER_DTYPE = np.dtype([
    ("endpoint", "<u4"), ("saddr", "<u4"), ("daddr", "<u4"),
    ("sport", "<u2"), ("dport", "<u2"), ("proto", "u1"),
    ("direction", "u1"), ("tcp_flags", "u1"), ("is_fragment", "u1"),
    ("length", "<u4"),
])
# the SoA order ring_pop_batch_soa fills
_SOA_FIELDS = ("endpoint", "saddr", "daddr", "sport", "dport", "proto",
               "direction", "tcp_flags", "is_fragment", "length")

_lib = None
_lib_lock = threading.Lock()


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"runtime-{digest}.so"
    if so_path.exists():
        return so_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(so_path.name + f".tmp{os.getpid()}")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def load() -> ctypes.CDLL:
    """Compile (once) and load the native runtime."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        u64, u32, i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int32
        vp = ctypes.c_void_p
        lib.pkt_header_size.restype = ctypes.c_int
        lib.pkt_header_size.argtypes = []
        lib.pkt_header_offsets.restype = ctypes.c_int
        lib.pkt_header_offsets.argtypes = [ctypes.POINTER(u32),
                                           ctypes.c_int]
        lib.ring_create.restype = vp
        lib.ring_create.argtypes = [u64]
        lib.ring_destroy.restype = None
        lib.ring_destroy.argtypes = [vp]
        lib.ring_capacity.restype = u64
        lib.ring_capacity.argtypes = [vp]
        lib.ring_size.restype = u64
        lib.ring_size.argtypes = [vp]
        lib.ring_dropped.restype = u64
        lib.ring_dropped.argtypes = [vp]
        lib.ring_push_burst.restype = u64
        lib.ring_push_burst.argtypes = [vp, vp, u64]
        lib.ring_note_dropped.restype = None
        lib.ring_note_dropped.argtypes = [vp, u64]
        lib.ring_pop_batch_soa.restype = u64
        lib.ring_pop_batch_soa.argtypes = [vp, u64] + \
            [ctypes.POINTER(i32)] * len(_SOA_FIELDS)
        p, u8 = ctypes.POINTER, ctypes.c_uint8
        lib.vc_create.restype = vp
        lib.vc_create.argtypes = [u64]
        lib.vc_destroy.restype = None
        lib.vc_destroy.argtypes = [vp]
        lib.vc_update.restype = ctypes.c_int
        lib.vc_update.argtypes = [vp, u32, u32, i32]
        lib.vc_update_batch.restype = u64
        lib.vc_update_batch.argtypes = [vp, p(u32), p(u32), p(i32), u64]
        lib.vc_delete.restype = ctypes.c_int
        lib.vc_delete.argtypes = [vp, u32, u32]
        lib.vc_lookup_batch.restype = u64
        lib.vc_lookup_batch.argtypes = [vp, p(u32), p(u32), u64,
                                        p(i32), p(u8)]
        lib.vc_classify_batch.restype = u64
        lib.vc_classify_batch.argtypes = [vp, p(u32), p(i32), p(i32),
                                          p(i32), u64, p(i32)]
        lib.vc_len.restype = u64
        lib.vc_len.argtypes = [vp]
        lib.vc_slots.restype = u64
        lib.vc_slots.argtypes = [vp]
        lib.vc_flush.restype = None
        lib.vc_flush.argtypes = [vp]
        lib.dfa_match_scalar.restype = u64
        lib.dfa_match_scalar.argtypes = [p(i32), p(u8), p(i32), u64,
                                         p(u8), u64, p(u8)]
        _lib = lib
        return lib


def check_struct_alignment() -> None:
    """Raise unless the C++ PktHeader layout equals PKT_HEADER_DTYPE."""
    lib = load()
    c_size = lib.pkt_header_size()
    if c_size != PKT_HEADER_DTYPE.itemsize:
        raise AssertionError(
            f"PktHeader size mismatch: C++ {c_size} != "
            f"numpy {PKT_HEADER_DTYPE.itemsize}")
    offs = (ctypes.c_uint32 * 16)()
    n = lib.pkt_header_offsets(offs, 16)
    names = PKT_HEADER_DTYPE.names
    if n != len(names):
        raise AssertionError(
            f"PktHeader field count mismatch: C++ {n} != {len(names)}")
    for i, name in enumerate(names):
        np_off = PKT_HEADER_DTYPE.fields[name][1]
        if offs[i] != np_off:
            raise AssertionError(
                f"PktHeader field {name!r} offset mismatch: "
                f"C++ {offs[i]} != numpy {np_off}")


class PacketRing:
    """SPSC packet-header ring with SoA batch drain."""

    def __init__(self, capacity: int = 1 << 16):
        self._lib = load()
        self._h = self._lib.ring_create(capacity)
        if not self._h:
            raise MemoryError("ring_create failed")

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._h)

    def __len__(self) -> int:
        return self._lib.ring_size(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.ring_dropped(self._h)

    def push(self, records: np.ndarray, drop_on_full: bool = True) -> int:
        """Push a PKT_HEADER_DTYPE record array; returns count pushed.
        With ``drop_on_full`` records that do not fit count as drops
        (perf-ring lost-samples semantics); pass False when the producer
        retries the remainder itself."""
        recs = np.ascontiguousarray(records, dtype=PKT_HEADER_DTYPE)
        pushed = self._lib.ring_push_burst(
            self._h, recs.ctypes.data_as(ctypes.c_void_p), len(recs))
        if drop_on_full and pushed < len(recs):
            self._lib.ring_note_dropped(self._h, len(recs) - pushed)
        return pushed

    def pop_batch(self, max_records: int
                  ) -> Tuple[Dict[str, np.ndarray], int]:
        """Drain up to ``max_records`` into fresh int32 SoA arrays
        (trimmed to the count drained)."""
        out = {f: np.empty(max_records, np.int32) for f in _SOA_FIELDS}
        ptrs = [out[f].ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
                for f in _SOA_FIELDS]
        n = self._lib.ring_pop_batch_soa(self._h, max_records, *ptrs)
        return {f: a[:n] for f, a in out.items()}, int(n)

    def close(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class VerdictCache:
    """C++ exact-match verdict cache (host fast path)."""

    def __init__(self, slots: int = 1 << 14):
        self._lib = load()
        self._h = self._lib.vc_create(slots)
        if not self._h:
            raise MemoryError("vc_create failed")

    def update(self, key_a: int, key_b: int, value: int) -> bool:
        return bool(self._lib.vc_update(
            self._h, key_a & 0xFFFFFFFF, key_b & 0xFFFFFFFF, value))

    def update_batch(self, key_a: np.ndarray, key_b: np.ndarray,
                     values: np.ndarray) -> int:
        """Bulk upsert; returns records applied (kb==0 rows skipped)."""
        ka = np.ascontiguousarray(key_a, dtype=np.uint32)
        kb = np.ascontiguousarray(key_b, dtype=np.uint32)
        vals = np.ascontiguousarray(values, dtype=np.int32)
        return self._lib.vc_update_batch(
            self._h, ka.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            kb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ka))

    def delete(self, key_a: int, key_b: int) -> bool:
        return bool(self._lib.vc_delete(
            self._h, key_a & 0xFFFFFFFF, key_b & 0xFFFFFFFF))

    def lookup_batch(self, key_a: np.ndarray, key_b: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(values int32[n], found bool[n]) for uint32 key arrays."""
        ka = np.ascontiguousarray(key_a, dtype=np.uint32)
        kb = np.ascontiguousarray(key_b, dtype=np.uint32)
        n = len(ka)
        values = np.empty(n, np.int32)
        found = np.empty(n, np.uint8)
        self._lib.vc_lookup_batch(
            self._h, ka.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            kb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            found.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return values, found.astype(bool)

    def classify_batch(self, identity: np.ndarray, dport: np.ndarray,
                       proto: np.ndarray, direction: np.ndarray
                       ) -> np.ndarray:
        """Full 3-stage __policy_can_access over a batch in one native
        call (bpf/lib/policy.h:46 semantics; -1 drop, 0 allow, >0
        proxy port).  The latency path: no per-stage Python round
        trips."""
        ident = np.ascontiguousarray(identity, dtype=np.uint32)
        dpt = np.ascontiguousarray(dport, dtype=np.int32)
        pro = np.ascontiguousarray(proto, dtype=np.int32)
        dirn = np.ascontiguousarray(direction, dtype=np.int32)
        n = len(ident)
        out = np.empty(n, np.int32)
        self._lib.vc_classify_batch(
            self._h, ident.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            dpt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pro.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dirn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def __len__(self) -> int:
        return self._lib.vc_len(self._h)

    @property
    def slots(self) -> int:
        return self._lib.vc_slots(self._h)

    def flush(self) -> None:
        self._lib.vc_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.vc_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class ScalarDFA:
    """Host walker over a compiled stacked DFA table (``compiler/regexc.
    CompiledRegexSet``: table [S, 256] int32, accept [S], starts [R],
    state 0 dead), the live proxy's per-request match
    (envoy/cilium_l7policy.cc analog).  It holds contiguous host copies
    of the same arrays the device engines walk, so both tiers share one
    compiled artifact."""

    def __init__(self, compiled):
        self._lib = load()
        self._table = np.ascontiguousarray(compiled.table, np.int32)
        self._accept = np.ascontiguousarray(
            compiled.accept.astype(np.uint8))
        self._starts = np.ascontiguousarray(compiled.starts, np.int32)
        self.num_regex = len(self._starts)
        p32 = ctypes.POINTER(ctypes.c_int32)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        self._t = self._table.ctypes.data_as(p32)
        self._a = self._accept.ctypes.data_as(pu8)
        self._s = self._starts.ctypes.data_as(p32)

    def match(self, data: bytes) -> np.ndarray:
        """[R] bool anchored-match mask for one byte string."""
        out = np.empty(self.num_regex, np.uint8)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) \
            if data else (ctypes.c_uint8 * 1)()
        self._lib.dfa_match_scalar(
            self._t, self._a, self._s, self.num_regex,
            ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(bool)
