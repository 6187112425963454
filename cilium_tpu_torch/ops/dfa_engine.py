"""Quantized, depth-reduced DFA engines for the L7 hot loop.

Port of ``cilium_tpu/ops/dfa_engine.py``.  Three optimizations, chosen
per (table size, payload length, batch) when the engine is built:

1. **Quantization**: on a card the transition tables are stored and
   gathered at the narrowest dtype the state count allows (int8 for
   S <= 127, int16 for S <= 32767), read back as int32.  On the CPU they
   stay int32.  ``on_accel`` follows the engine's device (``cuda`` ->
   True) unless the caller fixes it, so a CPU engine can reproduce a
   card's selection exactly.
2. **Depth reduction**: the byte alphabet collapses into equivalence
   classes (``compiler/regexc.byte_equivalence_classes``), then k
   consecutive class functions are precomposed on the host into one
   stride table [S, (C+1)^k], so the walk takes ceil(L/k) dependent
   gathers instead of L (``stride``).  When that table would not fit its
   budget, the same reduction runs on the device per batch
   (``compose``), and a log-depth composition (``assoc``) is the
   long-payload end.
3. **Split dispatch**: the class map and stride packing run either in
   the device program (``match`` on a byte block) or on the host
   (``encode`` -> ``match_encoded``), so that host packing of batch N+1
   can overlap the device walk of batch N.

Every strategy and both dispatch forms give the bits of the
``dfa_ops.dfa_match`` oracle: negative bytes (-1 padding, -2 poison) map
to an identity class that composes as the identity function, and the
-2 row poison is masked at accept time.  The walks are loops of
dependent gathers with no host read inside.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .dfa_ops import overlong_rows, start_states
from .dfa_parallel import (dfa_match_compose, dfa_match_parallel,
                           dfa_parallel_scan, dfa_scan_compose)

# Host-precomposed stride tables must stay in fast memory: a card's
# budget is the tighter one.
STRIDE_BUDGET_ACCEL = 4 << 20
STRIDE_BUDGET_CPU = 16 << 20
# Packed-column bound: (C+1)^k columns; 2^16 keeps S * cols * state
# index arithmetic inside int32.
MAX_PACKED_COLS = 1 << 16
MAX_STRIDE = 8
# [B, L, S] transition-function materialization bound for the on-device
# strategies (compose/assoc).
DEVICE_F_BUDGET = 256 << 20
# Payload lengths below this never leave the stride path.
SHORT_PAYLOAD = 64

Block = Union[np.ndarray, torch.Tensor]


def quantize_dtype(num_states: int) -> np.dtype:
    """Narrowest signed dtype that can index ``num_states`` states."""
    if num_states <= (1 << 7) - 1:
        return np.dtype(np.int8)
    if num_states <= (1 << 15) - 1:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


@dataclass
class PackedBatch:
    """Encoded input for ``match_encoded``.

    For the stride strategy ``idx`` is the [B, G] packed class-group
    index block (G = ceil(L/k)); otherwise it is the raw [B, L] byte
    block and the device program does its own mapping.  ``overlong`` is
    the -2 poison row mask, so the device never re-scans the bytes.  The
    fields are numpy arrays from ``DFAEngine.encode``, or tensors after
    ``to``."""

    idx: Block
    overlong: Block
    rows: int
    packed: bool

    def to(self, device: DeviceLike) -> "PackedBatch":
        """The same batch with its blocks as tensors on ``device``."""
        dev = resolve_device(device)
        return PackedBatch(idx=torch.as_tensor(self.idx, device=dev),
                           overlong=torch.as_tensor(self.overlong,
                                                    device=dev),
                           rows=self.rows, packed=self.packed)


def _stride_scan(k: int, c1: int, flat_tab, class_map, states, data):
    """Fused form: class map + packing + ceil(L/k) dependent gathers.

    flat_tab: [S * c1**k] stride table; class_map: [258] int32 (byte + 2
    -> class, both negative bytes mapped to the identity class c1-1);
    states: [B, R] int32; data: [B, L] int32 bytes."""
    b, l = data.shape
    cls = class_map[(data + 2).to(torch.int64)]
    pad = (-l) % k
    if pad:
        cls = torch.cat([cls, cls.new_full((b, pad), c1 - 1)], dim=1)
    g = cls.reshape(b, -1, k)
    idx = g[:, :, 0]
    for j in range(1, k):                           # earlier byte = high digit
        idx = idx * c1 + g[:, :, j]                 # [B, G]
    return _packed_walk(c1 ** k, flat_tab, states, idx)


def _packed_walk(w: int, flat_tab, states, idx):
    """The dependent-gather carry walk of both dispatch forms: the
    narrow table is read back as int32, the carried states are cast to
    int64 for the gather."""
    st = states
    for col in idx.unbind(1):                       # col: [B]; st: [B, R]
        at = st.to(torch.int64) * w + col.to(torch.int64)[:, None]
        st = flat_tab[at].to(torch.int32)
    return st


class DFAEngine:
    """One compiled regex set on one device, matched by the best strategy
    for its (table size, payload length, batch) point.

    Strategies:
      - ``stride``: host-precomposed k-class stride table; the default
        whenever the packed table fits the budget (k=1 is a
        class-compressed serial walk).
      - ``compose``: device-side k-group composition, then an L/k walk;
        for tables too big to precompose but payloads long enough that
        depth dominates.
      - ``assoc``: log-depth composition; the long-payload end on a
        card.
    """

    def __init__(self, compiled, max_len: int, batch_hint: int = 2048,
                 prefer: Optional[str] = None,
                 stride_budget: Optional[int] = None,
                 dtype: Optional[np.dtype] = None,
                 on_accel: Optional[bool] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.compiled = compiled
        self.max_len = int(max_len)
        self.batch_hint = int(batch_hint)
        s = int(compiled.num_states)
        self.on_accel = self.device.type == "cuda" if on_accel is None \
            else bool(on_accel)
        self._dtype = np.dtype(dtype) if dtype is not None else (
            quantize_dtype(s) if self.on_accel else np.dtype(np.int32))
        if np.iinfo(self._dtype).max < s - 1:
            raise ValueError(f"dtype {self._dtype} cannot hold {s} states")
        itemsize = self._dtype.itemsize
        if stride_budget is None:
            stride_budget = STRIDE_BUDGET_ACCEL if self.on_accel \
                else STRIDE_BUDGET_CPU
        class_of, class_tab = compiled.byte_classes()
        self.num_classes = int(class_tab.shape[1])
        self._c1 = self.num_classes + 1             # + identity class

        # largest stride whose precomposed table stays in budget
        k = 1
        while (k < MAX_STRIDE and self._c1 ** (k + 1) <= MAX_PACKED_COLS
               and s * self._c1 ** (k + 1) * itemsize <= stride_budget):
            k += 1
        device_f_bytes = self.batch_hint * self.max_len * s * itemsize
        if prefer is not None:
            if prefer not in ("stride", "compose", "assoc"):
                raise ValueError(f"unknown DFA strategy {prefer!r}")
            strategy = prefer
        elif (self.on_accel and self.max_len >= 256
              and (self.max_len + k - 1) // k > 64
              and device_f_bytes <= DEVICE_F_BUDGET):
            # stride can't get the depth down on a card: go log-depth
            strategy = "assoc"
        elif (k == 1 and self.max_len >= SHORT_PAYLOAD
              and device_f_bytes <= DEVICE_F_BUDGET):
            # class alphabet too rich to precompose: reduce depth on
            # the device instead
            strategy = "compose"
        else:
            strategy = "stride"
        self.strategy = strategy
        self.k = k if strategy == "stride" else \
            (4 if strategy == "compose" else 1)

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=self.device)
        self._accept = put(np.asarray(compiled.accept, bool))
        self._starts = put(np.asarray(compiled.starts, np.int32))
        self._flat = None
        self._map = None
        self._map_np = None
        self._table_q = None
        if strategy == "stride":
            tab_c = np.concatenate(
                [class_tab, np.arange(s, dtype=np.int32)[:, None]],
                axis=1)                             # [S, C+1]
            t = tab_c
            for _ in range(self.k - 1):
                # T'[s, i*C1 + c] = tab_c[T[s, i], c]: one more byte of
                # lookahead folded into every column
                t = tab_c[t].reshape(s, -1)
            self._packed_bytes = int(t.size * itemsize)
            self._flat = put(t.astype(self._dtype).reshape(-1))
            map258 = np.full(258, self.num_classes, np.int32)
            map258[2:] = class_of                   # byte b at index b+2
            self._map_np = map258
            self._map = put(map258)
        else:
            self._packed_bytes = int(s * 256 * itemsize)
            self._table_q = put(compiled.table.astype(self._dtype))

    # ----------------------------------------------------- host encode

    def encode(self, data: np.ndarray) -> PackedBatch:
        """Host stage of the split dispatch: class-map and stride-pack a
        [B, L] byte block (numpy), so the device program is the carry
        walk alone.  Non-stride strategies pass the bytes through."""
        data = np.asarray(data)
        overlong = (data == -2).any(axis=1)
        if self.strategy != "stride":
            return PackedBatch(idx=data, overlong=overlong,
                               rows=data.shape[0], packed=False)
        b, l = data.shape
        cls = self._map_np[data + 2]
        pad = (-l) % self.k
        if pad:
            cls = np.concatenate(
                [cls, np.full((b, pad), self.num_classes, np.int32)],
                axis=1)
        g = cls.reshape(b, -1, self.k)
        idx = g[:, :, 0].astype(np.int32)
        for j in range(1, self.k):
            idx = idx * self._c1 + g[:, :, j]
        return PackedBatch(idx=idx, overlong=overlong, rows=b,
                           packed=True)

    # ------------------------------------------------------------ match

    def _tensor(self, x: Block) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def match(self, data) -> torch.Tensor:
        """Anchored match, [B, R] bool on the device: the ``dfa_match``
        contract (padding freeze, -2 poison).  Takes a raw byte block
        (numpy or a tensor) or a :class:`PackedBatch`."""
        if isinstance(data, PackedBatch):
            return self.match_encoded(data)
        data = self._tensor(data)
        if self.strategy == "compose":
            return dfa_match_compose(self._table_q, self._accept,
                                     self._starts, data, self.k)
        if self.strategy == "assoc":
            return dfa_match_parallel(self._table_q, self._accept,
                                      self._starts, data)
        final = _stride_scan(self.k, self._c1, self._flat, self._map,
                             start_states(self._starts, data.shape[0]),
                             data)
        return self._accept[final.to(torch.int64)] & \
            ~overlong_rows(data)[:, None]

    def match_encoded(self, packed: PackedBatch) -> torch.Tensor:
        """Device half of the split dispatch (see :meth:`encode`)."""
        if not packed.packed:
            return self.match(packed.idx)
        idx = self._tensor(packed.idx)
        final = _packed_walk(self._c1 ** self.k, self._flat,
                             start_states(self._starts, idx.shape[0]), idx)
        return self._accept[final.to(torch.int64)] & \
            ~self._tensor(packed.overlong)[:, None]

    def scan(self, states, data, donate: bool = False) -> torch.Tensor:
        """Streaming chunk scan: advance [B, R] carried states over a
        [B, L] chunk (the ``dfa_scan`` contract), as int32.  With
        ``donate=True`` the result is written into ``states`` (an int32
        tensor on the device) and returned, so a chunk loop carries one
        buffer."""
        data = self._tensor(data)
        carry = self._tensor(states).to(torch.int32)
        if self.strategy == "stride":
            out = _stride_scan(self.k, self._c1, self._flat, self._map,
                               carry, data)
        elif self.strategy == "compose":
            out = dfa_scan_compose(self._table_q, carry, data, self.k)
        else:
            out = dfa_parallel_scan(self._table_q, carry, data)
        out = out.to(torch.int32)
        if donate:
            return states.copy_(out)
        return out

    # ------------------------------------------------------------ report

    def depth(self, length: Optional[int] = None) -> int:
        """Dependent-step count for a payload of ``length`` bytes."""
        ln = self.max_len if length is None else int(length)
        if self.strategy == "assoc":
            return max(1, int(np.ceil(np.log2(max(ln, 2)))))
        return (ln + self.k - 1) // self.k

    def describe(self) -> dict:
        """Engine-selection report."""
        dt = self._dtype.name
        return {"strategy": self.strategy, "k": self.k, "dtype": dt,
                "states": int(self.compiled.num_states),
                "classes": self.num_classes,
                "depth_at_max_len": self.depth(),
                "byte_table_bytes": int(self.compiled.table.nbytes),
                "resident_bytes": self._packed_bytes,
                "on_accel": self.on_accel,
                "tag": f"{self.strategy}{self.k}-{dt}-C{self.num_classes}"}
