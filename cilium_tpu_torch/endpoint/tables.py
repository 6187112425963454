"""Device-resident stacked policy tables with incremental row updates.

Port of ``cilium_tpu/endpoint/tables.py``: the analog of the reference's
per-endpoint pinned BPF policy maps (pkg/maps/policymap) and their
incremental sync (pkg/endpoint/bpf.go:607 syncPolicyMap).  Every
endpoint's verdict table is one row of stacked [E, S] device tensors;
syncing one endpoint rewrites its row in place (``tensor[slot] = row``),
not the stack.  Growth (more endpoints, bigger tables) rebuilds the
stack from the host mirror at the new geometry, a new generation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..compiler.hashtab import HashTable, _next_pow2, build_hash_table
from ..compiler.policy_tables import pack_key
from ..device import DeviceLike, resolve_device
from ..policy.mapstate import PolicyMapState

MIN_SLOTS = 64


class _NeedsGrow(Exception):
    def __init__(self, slots_needed: int):
        super().__init__(slots_needed)
        self.slots_needed = slots_needed


def _build_endpoint_table(state: PolicyMapState, slots: Optional[int],
                          max_load: float = 0.5) -> HashTable:
    entries = {pack_key(k): v.proxy_port for k, v in state.items()}
    if slots is None:
        return build_hash_table(entries, min_slots=MIN_SLOTS,
                                max_load=max_load)
    t = build_hash_table(entries, min_slots=slots, max_load=1.0)
    if t.slots != slots:
        raise _NeedsGrow(t.slots)
    return t


class DeviceTableManager:
    """Owns the stacked device policy tensors and the endpoint rows.

    ``sync_endpoint`` is the hot path: one endpoint's new PolicyMapState
    becomes one row write on the device.  A host numpy mirror keeps the
    newest rows, so a rebuild never reads the device back."""

    def __init__(self, initial_endpoints: int = 8,
                 initial_slots: int = MIN_SLOTS, max_load: float = 0.5,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self.max_load = max_load
        # hash tables are always pow2-sized; normalize up front so row
        # rebuilds land on exactly self.slots
        initial_slots = _next_pow2(max(initial_slots, 8))
        self.slots = initial_slots
        self.capacity = initial_endpoints
        self.generation = 0           # bumps on every rebuild
        self.revision = 0             # policy revision last synced
        self.max_probe = 1
        self._row_probe: Dict[int, int] = {}
        # rows written since the last drain: the engine writes exactly
        # these into its own tensors on refresh_policy's fast path
        self._dirty_slots: set = set()
        self._free: List[int] = list(range(initial_endpoints))
        self._slot_of: Dict[int, int] = {}   # endpoint id -> row
        self._state_of: Dict[int, PolicyMapState] = {}
        self._h_key_id = np.zeros((initial_endpoints, initial_slots),
                                  np.int32)
        self._h_key_meta = np.zeros_like(self._h_key_id)
        self._h_value = np.zeros_like(self._h_key_id)
        self._upload()

    def _upload(self) -> None:
        put = lambda x: torch.as_tensor(x, device=self.device)  # noqa
        self.key_id = put(self._h_key_id.copy())
        self.key_meta = put(self._h_key_meta.copy())
        self.value = put(self._h_value.copy())

    # ------------------------------------------------------------- slots

    def attach(self, endpoint_id: int) -> int:
        """Assign a table row to an endpoint (the stack grows 2x when
        full)."""
        with self._lock:
            if endpoint_id in self._slot_of:
                return self._slot_of[endpoint_id]
            if not self._free:
                self._grow(capacity=self.capacity * 2)
            slot = self._free.pop(0)
            self._slot_of[endpoint_id] = slot
            self._state_of[endpoint_id] = PolicyMapState()
            return slot

    def detach(self, endpoint_id: int) -> None:
        """Release an endpoint's row and zero it on the device."""
        with self._lock:
            slot = self._slot_of.pop(endpoint_id, None)
            if slot is None:
                return
            self._state_of.pop(endpoint_id, None)
            self._row_probe.pop(slot, None)
            self._free.append(slot)
            zero = np.zeros(self.slots, np.int32)
            self._write_row(slot, zero, zero, zero, probe=1)

    def slot_of(self, endpoint_id: int) -> Optional[int]:
        with self._lock:
            return self._slot_of.get(endpoint_id)

    # -------------------------------------------------------------- sync

    def sync_endpoint(self, endpoint_id: int, state: PolicyMapState,
                      revision: int) -> Dict:
        """Realize ``state`` for the endpoint on the device.  Returns
        {"full_swap", "slots", "entries", "generation", "max_probe"};
        raises KeyError for an unattached endpoint."""
        with self._lock:
            slot = self._slot_of[endpoint_id]
            full_swap = False
            try:
                table = _build_endpoint_table(state, self.slots,
                                              self.max_load)
                # guard against load creeping past the bound in place
                if table.load > self.max_load:
                    raise _NeedsGrow(self.slots * 2)
            except _NeedsGrow as g:
                self._state_of[endpoint_id] = PolicyMapState(state)
                self._grow(slots=max(g.slots_needed, self.slots * 2))
                full_swap = True
            if not full_swap:
                self._state_of[endpoint_id] = PolicyMapState(state)
                self._write_row(slot, table.key_a, table.key_b,
                                table.value, probe=table.max_probe)
            self.revision = max(self.revision, revision)
            return {"full_swap": full_swap, "slots": self.slots,
                    "entries": len(state), "generation": self.generation,
                    "max_probe": self.max_probe}

    def _write_row(self, slot: int, key_a: np.ndarray, key_b: np.ndarray,
                   value: np.ndarray, probe: int) -> None:
        self._h_key_id[slot] = key_a
        self._h_key_meta[slot] = key_b
        self._h_value[slot] = value
        self._dirty_slots.add(slot)
        self._row_probe[slot] = probe
        for dst, row in ((self.key_id, key_a), (self.key_meta, key_b),
                         (self.value, value)):
            dst[slot] = torch.as_tensor(row, device=self.device)
        self.max_probe = max([1] + list(self._row_probe.values()))

    def _grow(self, capacity: Optional[int] = None,
              slots: Optional[int] = None) -> None:
        """Rebuild at a bigger geometry from the host states (a new
        generation)."""
        new_cap = capacity or self.capacity
        new_slots = _next_pow2(slots or self.slots)
        # some endpoint's state may need more slots than requested;
        # find the real bound before touching any manager state
        while True:
            try:
                rebuilt = {
                    ep_id: _build_endpoint_table(self._state_of[ep_id],
                                                 new_slots, max_load=1.0)
                    for ep_id in self._slot_of}
                break
            except _NeedsGrow as g:
                new_slots = _next_pow2(max(g.slots_needed, new_slots * 2))
        h_id = np.zeros((new_cap, new_slots), np.int32)
        h_meta = np.zeros_like(h_id)
        h_val = np.zeros_like(h_id)
        self._row_probe = {}
        for ep_id, slot in self._slot_of.items():
            table = rebuilt[ep_id]
            h_id[slot] = table.key_a
            h_meta[slot] = table.key_b
            h_val[slot] = table.value
            self._row_probe[slot] = table.max_probe
        used = set(self._slot_of.values())
        self._free = [i for i in range(new_cap) if i not in used]
        self.capacity, self.slots = new_cap, new_slots
        self._h_key_id, self._h_key_meta, self._h_value = h_id, h_meta, h_val
        self._upload()
        self.max_probe = max([1] + list(self._row_probe.values()))
        self.generation += 1

    # ------------------------------------------------------------- views

    def snapshot(self):
        """Atomic ((capacity, slots, max_probe, generation), (key_id,
        key_meta, value)) under one lock acquisition: a concurrent sync
        can lengthen a probe chain or regrow the stack between two
        separate reads."""
        with self._lock:
            return ((self.capacity, self.slots, self.max_probe,
                     self.generation),
                    (self.key_id, self.key_meta, self.value))

    def drain_dirty(self) -> Dict[int, Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
        """{slot: (key_id row, key_meta row, value row)} for every row
        written since the last drain, from the host mirror (always the
        newest content), clearing the dirty set.  Rows are idempotent
        to re-apply."""
        with self._lock:
            out = {}
            for slot in sorted(self._dirty_slots):
                if slot >= self._h_key_id.shape[0]:
                    continue
                out[slot] = (self._h_key_id[slot].copy(),
                             self._h_key_meta[slot].copy(),
                             self._h_value[slot].copy())
            self._dirty_slots.clear()
            return out

    def host_mirror(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._lock:
            return (self._h_key_id.copy(), self._h_key_meta.copy(),
                    self._h_value.copy())

    def states_by_slot(self) -> Dict[int, PolicyMapState]:
        """{table row slot: PolicyMapState copy}: the host-of-record the
        fail-static oracle (``datapath/supervisor.py``) enforces while the
        device lane is degraded, and the recovery gate replays."""
        with self._lock:
            return {slot: PolicyMapState(self._state_of[ep_id])
                    for ep_id, slot in self._slot_of.items()}

    def stats(self) -> Dict:
        with self._lock:
            return {"capacity": self.capacity, "slots": self.slots,
                    "endpoints": len(self._slot_of),
                    "generation": self.generation,
                    "max_probe": self.max_probe,
                    "revision": self.revision,
                    "nbytes": int(self._h_key_id.nbytes * 3)}
