"""The v4 datapath engine: host orchestrator over the device tables.

Port of the v4 surface of ``cilium_tpu/datapath/engine.py``: one
generation of every device table (policy, ipcache LPM, LB, prefilter,
tunnel map) plus the mutable conntrack table and counters, behind
``process`` (a ``FullPacketBatch``) and ``process_packed`` (one [10, B]
matrix).  Swap-on-regenerate: ``load_policy`` builds a new table
generation while conntrack and counters survive when the shapes allow
(the analog of pinned BPF maps surviving an agent restart).  The step
runs eagerly; nothing in it reads a device value on the host, so a call
returns while the card still works on it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.lpm import CompiledLPM, compile_lpm, ipv4_to_u32
from ..compiler.policy_tables import CompiledPolicy, compile_endpoints
from ..device import DeviceLike, resolve_device
from ..policy.mapstate import PolicyMapState
from .conntrack import ConntrackTable
from .lb import LoadBalancer
from .pipeline import (DatapathTables, FullPacketBatch, FullTables,
                       build_tables, full_datapath_step,
                       full_datapath_step_packed)
from .prefilter import PreFilter
from .verdict import Counters, Provenance


class Datapath:
    """One device-resident datapath generation + mutable flow state."""

    def __init__(self, ct_slots: int = 1 << 16, ct_probe: int = 8,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        # process, gc and the rebuilds all touch the CT and counters
        self._lock = threading.Lock()
        self.prefilter = PreFilter()
        self.lb = LoadBalancer(device=self.device)
        self.ct = ConntrackTable(slots=ct_slots, max_probe=ct_probe,
                                 device=self.device)
        # the v6 table stays empty until the v6 step is ported; it keeps
        # the (v4, v6) shape of the CT snapshot surface
        self.ct6 = ConntrackTable(slots=ct_slots, max_probe=ct_probe,
                                  device=self.device)
        self.compiled_policy: Optional[CompiledPolicy] = None
        self.compiled_ipcache: Optional[CompiledLPM] = None
        self.ipcache_prefixes: Dict[str, int] = {}
        # tunnel map: pod CIDR -> tunnel endpoint node IP (int32 bits)
        self.tunnel_prefixes: Dict[str, int] = {}
        self.compiled_tunnel: Optional[CompiledLPM] = None
        # endpoint slot -> the endpoint's own security identity
        self._ep_identity = np.zeros(8, np.int32)
        # per-entry counters, [2, E*S] int32 holding uint32 bits (row 0
        # packets, row 1 bytes); read through the ``counters`` property
        self._counters: Optional[torch.Tensor] = None
        self.revision = 0
        self._tables: Optional[FullTables] = None
        self._statics: Dict = {}
        # incremental mode: policy tensors owned by a DeviceTableManager
        self._table_mgr = None
        self._mgr_geometry = None  # (capacity, slots, max_probe, gen)
        self.provenance_enabled = False
        self.last_provenance: Optional[Provenance] = None
        # per-second device timestamp: steady-state batches reuse one
        # 0-d tensor instead of making a new one per batch
        self._ts_cache: Optional[Tuple[int, torch.Tensor]] = None

    @property
    def counters(self) -> Optional[Counters]:
        """Counters view over the [2, E*S] buffer (row views)."""
        c = self._counters
        if c is None:
            return None
        return Counters(packets=c[0], bytes=c[1])

    def enable_provenance(self) -> None:
        """Turn on per-packet verdict provenance: each step also yields
        (matched policymap slot, decision tier), kept as
        ``last_provenance``."""
        with self._lock:
            self.provenance_enabled = True

    def disable_provenance(self) -> None:
        with self._lock:
            self.provenance_enabled = False
            self.last_provenance = None

    # -- table generations ----------------------------------------------

    def load_policy(self, map_states: Sequence[PolicyMapState],
                    revision: int,
                    ipcache_prefixes: Optional[Dict[str, int]] = None
                    ) -> None:
        with self._lock:
            self._table_mgr = None
            self.compiled_policy = compile_endpoints(map_states,
                                                     revision=revision)
            if ipcache_prefixes is not None or \
                    self.compiled_ipcache is None:
                self.ipcache_prefixes = dict(ipcache_prefixes or {})
                self.compiled_ipcache = compile_lpm(ipcache_prefixes or {})
            self.revision = revision
            self._rebuild()

    def use_table_manager(self, mgr,
                          ipcache_prefixes: Optional[Dict[str, int]]
                          = None) -> None:
        """Take the policy tensors from a DeviceTableManager
        (incremental mode): endpoint syncs become row writes realized
        by ``refresh_policy``; only a geometry change rebuilds."""
        with self._lock:
            self._table_mgr = mgr
            if ipcache_prefixes is not None or \
                    self.compiled_ipcache is None:
                self.ipcache_prefixes = dict(ipcache_prefixes or {})
                self.compiled_ipcache = compile_lpm(ipcache_prefixes or {})
            self._rebuild()

    def refresh_policy(self, revision: Optional[int] = None,
                       force_rebuild: bool = False) -> bool:
        """Realize the table manager's current rows (the syncPolicyMap
        fast path).  With the geometry unchanged, the rows written since
        the last refresh are copied into the engine's own policy tensors
        (a row write each) and no table is rebuilt; otherwise, or with
        ``force_rebuild``, the generation is rebuilt.  Returns True when
        it rebuilt."""
        with self._lock:
            if self._table_mgr is None:
                raise RuntimeError("not in table-manager mode")
            if revision is not None:
                self.revision = max(self.revision, revision)
            geometry, tensors = self._table_mgr.snapshot()
            if force_rebuild or geometry != self._mgr_geometry \
                    or self._tables is None:
                self._rebuild(mgr_snapshot=(geometry, tensors))
                return True
            dirty = self._table_mgr.drain_dirty()
            if dirty:
                rows = torch.as_tensor(np.fromiter(dirty, np.int64,
                                                   count=len(dirty)),
                                       device=self.device)
                dp = self._tables.datapath
                for i, dst in enumerate((dp.key_id, dp.key_meta,
                                         dp.value)):
                    dst[rows] = torch.as_tensor(
                        np.stack([r[i] for r in dirty.values()]),
                        device=self.device)
            return False

    def load_ipcache(self, prefixes: Dict[str, int]) -> None:
        with self._lock:
            self.ipcache_prefixes = dict(prefixes)
            self.compiled_ipcache = compile_lpm(prefixes)
            self._rebuild()

    def load_tunnel(self, prefixes: Dict[str, int]) -> None:
        """Program the tunnel map: pod CIDR -> tunnel endpoint node IP
        (u32; pkg/maps/tunnel SetTunnelEndpoint)."""
        # node IPs above 2^31 are stored as their int32 bits
        normalized = {cidr: int(np.uint32(ip).view(np.int32))
                      for cidr, ip in prefixes.items()}
        with self._lock:
            if normalized == self.tunnel_prefixes:
                return
            self.tunnel_prefixes = normalized
            self.compiled_tunnel = compile_lpm(self.tunnel_prefixes) \
                if self.tunnel_prefixes else None
            self._rebuild()

    def set_endpoint_identity(self, slot: int, identity: int) -> None:
        """Record a local endpoint slot's own security identity (the
        per-endpoint SECLABEL), stamped into tunnel keys on encap."""
        with self._lock:
            if slot >= self._ep_identity.shape[0]:
                grown = np.zeros(max(slot + 1,
                                     2 * self._ep_identity.shape[0]),
                                 np.int32)
                grown[:self._ep_identity.shape[0]] = self._ep_identity
                self._ep_identity = grown
            self._ep_identity[slot] = identity
            if self._tables is not None:
                self._tables = self._tables._replace(
                    ep_identity=self._put(self._ep_identity))

    def reload_services(self) -> None:
        with self._lock:
            self._rebuild()

    def reload_prefilter(self) -> None:
        with self._lock:
            self._rebuild()

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr, np.int32),
                               device=self.device)

    def _rebuild(self, mgr_snapshot=None) -> None:
        """Build the next table generation from the host state (lock
        held).  Counters are kept when their size is unchanged."""
        if self._table_mgr is None and self.compiled_policy is None:
            return
        if self.lb.compiled is None:
            self.lb._recompile()
        if self.compiled_ipcache is None:
            self.compiled_ipcache = compile_lpm({})
        lpm = self.compiled_ipcache
        if self._table_mgr is not None:
            if mgr_snapshot is None:
                mgr_snapshot = self._table_mgr.snapshot()
            geometry, tensors = mgr_snapshot
            capacity, slots, max_probe, _gen = geometry
            # the engine's own copies: a manager row write shows only
            # after refresh_policy, as in the reference
            key_id, key_meta, value = (t.to(self.device, copy=True)
                                       for t in tensors)
            dp = DatapathTables(
                key_id=key_id, key_meta=key_meta, value=value,
                lpm_masks=self._put(lpm.masks),
                lpm_key_a=self._put(lpm.key_a),
                lpm_key_b=self._put(lpm.key_b),
                lpm_value=self._put(lpm.value),
                lpm_plens=self._put(lpm.prefix_lens))
            policy_probe = max(1, max_probe)
            n = max(1, capacity * slots)
            self._mgr_geometry = geometry
        else:
            dp = build_tables(self.compiled_policy, lpm, device=self.device)
            policy_probe = self.compiled_policy.max_probe
            n = max(1, self.compiled_policy.num_endpoints *
                    self.compiled_policy.slots)
        pf = self.prefilter.compiled
        if pf is None or pf.entry_count() == 0:
            pf = compile_lpm({})
        tun = self.compiled_tunnel
        tun_kwargs = {}
        tun_probe = 0
        if tun is not None and tun.entry_count() > 0:
            tun_probe = max(1, tun.max_probe)
            tun_kwargs = dict(
                tun_masks=self._put(tun.masks),
                tun_key_a=self._put(tun.key_a),
                tun_key_b=self._put(tun.key_b),
                tun_value=self._put(tun.value),
                tun_plens=self._put(tun.prefix_lens))
        self._tables = FullTables(
            datapath=dp, lb=self.lb.compiled.tables,
            pf_masks=self._put(pf.masks), pf_key_a=self._put(pf.key_a),
            pf_key_b=self._put(pf.key_b), pf_value=self._put(pf.value),
            pf_plens=self._put(pf.prefix_lens),
            ep_identity=self._put(self._ep_identity), **tun_kwargs)
        if self._counters is None or self._counters.shape[1] != n:
            self._counters = torch.zeros((2, n), dtype=torch.int32,
                                         device=self.device)
        self._statics = dict(
            policy_probe=policy_probe,
            lpm_probe=max(1, self.compiled_ipcache.max_probe),
            pf_probe=max(1, pf.max_probe),
            lb_probe=self.lb.compiled.max_probe,
            ct_slots=self.ct.slots, ct_probe=self.ct.max_probe,
            tun_probe=tun_probe)

    # -- the step ---------------------------------------------------------

    def _timestamp(self, now: Optional[int]) -> torch.Tensor:
        """0-d int32 device tensor of the batch time, cached per value;
        made by a fill on the device, not a copy from the host."""
        val = int(now if now is not None else time.time())
        cache = self._ts_cache
        if cache is not None and cache[0] == val:
            return cache[1]
        ts = torch.full((), val, dtype=torch.int32, device=self.device)
        self._ts_cache = (val, ts)
        return ts

    def _dispatch_locked(self, step, batch, ts):
        if self._tables is None:
            raise RuntimeError("no policy loaded")
        outs = step(self._tables, self.ct.state, self.counters, batch, ts,
                    with_provenance=self.provenance_enabled,
                    **self._statics)
        verdict, event, identity, nat = outs[:4]
        self.ct.state = outs[4]
        if self.provenance_enabled:
            self.last_provenance = Provenance(outs[6], outs[7])
        return verdict, event, identity, nat

    def process(self, pkt: FullPacketBatch, now: Optional[int] = None):
        """Classify a batch.  Returns (verdict, event, identity, nat),
        device tensors; nat carries the DNAT'd forward tuple and the
        rev-NAT'd reply tuple."""
        ts = self._timestamp(now)
        with self._lock:
            return self._dispatch_locked(full_datapath_step, pkt, ts)

    def process_packed(self, packed: torch.Tensor,
                       now: Optional[int] = None):
        """Classify a batch given as ONE [10, B] int32 field matrix on
        this engine's device (``pipeline.PACKED_FIELDS`` order): the
        serving path's entry, one host-to-device copy per batch.  Same
        outputs as ``process``."""
        ts = self._timestamp(now)
        with self._lock:
            return self._dispatch_locked(full_datapath_step_packed,
                                         packed, ts)

    # -- conntrack surface ------------------------------------------------

    def ct_entries(self) -> Tuple[int, int]:
        """(v4, v6) live CT entry counts."""
        with self._lock:
            return self.ct.entry_count(), self.ct6.entry_count()

    def snapshot_ct(self):
        """(v4, v6) CT snapshots in the reference's npz layout."""
        with self._lock:
            return self.ct.snapshot(), self.ct6.snapshot()

    def restore_ct_snapshots(self, v4, v6) -> int:
        """Validate and swap in both CT snapshots together (both are
        prepared before either is assigned); returns entries restored.
        Raises ValueError/KeyError on a bad snapshot."""
        with self._lock:
            st4 = self.ct.prepare_snapshot(v4)
            st6 = self.ct6.prepare_snapshot(v6)
            self.ct.state = st4
            self.ct6.state = st6
            return self.ct.entry_count() + self.ct6.entry_count()

    def gc(self, now: Optional[int] = None) -> int:
        with self._lock:
            ts = now if now is not None else int(time.time())
            return self.ct.gc(ts) + self.ct6.gc(ts)


def make_full_batch(endpoint, saddr, daddr, sport, dport, proto=None,
                    direction=None, tcp_flags=None, length=None,
                    is_fragment=None, from_overlay=None, tunnel_id=None,
                    mark_identity=None, device: DeviceLike = None
                    ) -> FullPacketBatch:
    """A FullPacketBatch on ``device`` from lists or numpy arrays;
    addresses may be dotted-quad strings or uint32 values.  Defaults:
    TCP, egress, SYN, 100 bytes, not a fragment."""
    dev = resolve_device(device)
    n = len(np.asarray(endpoint))

    def arr(x, default):
        a = np.asarray(x if x is not None else np.full(n, default))
        return torch.as_tensor(a.astype(np.int32), device=dev)

    def addr(x):
        a = np.asarray(x)
        if a.dtype.kind in ("U", "S", "O"):  # dotted-quad strings
            a = np.array([ipv4_to_u32(str(s)) for s in a.ravel()],
                         np.uint32).reshape(a.shape)
        if a.dtype != np.int32:
            a = a.astype(np.int64).astype(np.uint32).view(np.int32)
        return torch.as_tensor(a, device=dev)

    overlay_fields = {}
    if from_overlay is not None or tunnel_id is not None:
        overlay_fields = dict(from_overlay=arr(from_overlay, 0),
                              tunnel_id=arr(tunnel_id, 0))
    if mark_identity is not None:
        overlay_fields["mark_identity"] = arr(mark_identity, 0)
    return FullPacketBatch(
        endpoint=arr(endpoint, 0), saddr=addr(saddr), daddr=addr(daddr),
        sport=arr(sport, 0), dport=arr(dport, 0), proto=arr(proto, 6),
        direction=arr(direction, 1), tcp_flags=arr(tcp_flags, 0x02),
        length=arr(length, 100), is_fragment=arr(is_fragment, 0),
        **overlay_fields)
