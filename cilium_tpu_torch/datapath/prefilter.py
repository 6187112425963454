"""Prefilter: the earliest batch CIDR drop (the XDP analog), torch.

Port of ``cilium_tpu/datapath/prefilter.py`` (reference: bpf/bpf_xdp.c:158
check_filters and pkg/datapath/prefilter/prefilter.go:30-125, the manager
of the four CIDR maps, dyn/fixed x v4/v6).  Each family's deny set
compiles to an LPM evaluated as a [B] mask in front of its step: the v4
set to a one-word LPM, the v6 set to a four-word one.
"""

from __future__ import annotations

import ipaddress
import threading
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import torch

from ..compiler.lpm import (CompiledLPM, CompiledLPM6, compile_lpm,
                            compile_lpm6)
from ..ops.lpm_ops import lpm6_lookup, lpm_lookup


class PrefilterType(IntEnum):
    """Reference: prefilter.go preFilterMaps (dyn/fixed x v4/v6)."""

    PREFIX_DYN_V4 = 0
    PREFIX_FIX_V4 = 1
    PREFIX_DYN_V6 = 2
    PREFIX_FIX_V6 = 3


_V4_TYPES = (PrefilterType.PREFIX_DYN_V4, PrefilterType.PREFIX_FIX_V4)


class PreFilter:
    """Manager of deny-CIDR sets; each family's sets compile to one LPM
    (prefilter.go:30-44 four maps, :125 Insert/Delete/Dump).  The
    compiled LPMs stay on the host; callers put them on their device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cidrs: Dict[PrefilterType, set] = {
            t: set() for t in PrefilterType}
        self.revision = 1
        self.compiled: Optional[CompiledLPM] = None
        self.compiled6: Optional[CompiledLPM6] = None
        self._last_v4: Optional[Dict[str, int]] = None
        self._last_v6: Optional[Dict[str, int]] = None

    @staticmethod
    def _family_type(net, which: PrefilterType) -> PrefilterType:
        """Route a CIDR to the map of its family, keeping the dyn/fixed
        distinction of the requested type."""
        dyn = which in (PrefilterType.PREFIX_DYN_V4,
                        PrefilterType.PREFIX_DYN_V6)
        if net.version == 4:
            return PrefilterType.PREFIX_DYN_V4 if dyn \
                else PrefilterType.PREFIX_FIX_V4
        return PrefilterType.PREFIX_DYN_V6 if dyn \
            else PrefilterType.PREFIX_FIX_V6

    def insert(self, cidrs: List[str],
               which: PrefilterType = PrefilterType.PREFIX_DYN_V4) -> None:
        with self._lock:
            for c in cidrs:
                net = ipaddress.ip_network(c, strict=False)
                self._cidrs[self._family_type(net, which)].add(str(net))
            self.revision += 1
            self._recompile()

    def delete(self, cidrs: List[str],
               which: PrefilterType = PrefilterType.PREFIX_DYN_V4) -> None:
        with self._lock:
            nets = [ipaddress.ip_network(c, strict=False) for c in cidrs]
            for net in nets:
                if str(net) not in self._cidrs[self._family_type(net,
                                                                 which)]:
                    raise KeyError(f"CIDR {net} not in prefilter")
            for net in nets:
                self._cidrs[self._family_type(net, which)].discard(
                    str(net))
            self.revision += 1
            self._recompile()

    def dump(self) -> Tuple[List[str], int]:
        with self._lock:
            out: List[str] = []
            for s in self._cidrs.values():
                out.extend(sorted(s))
            return out, self.revision

    def _recompile(self) -> None:
        v4 = {c: 1 for t in _V4_TYPES for c in self._cidrs[t]}
        v6 = {c: 1 for t in PrefilterType if t not in _V4_TYPES
              for c in self._cidrs[t]}
        # only the family whose set changed recompiles
        if v4 != self._last_v4:
            self._last_v4 = v4
            self.compiled = compile_lpm(v4)
        if v6 != self._last_v6:
            self._last_v6 = v6
            self.compiled6 = compile_lpm6(v6)

    def drop_mask(self, src_addrs: torch.Tensor) -> torch.Tensor:
        """[B] bool: True where the v4 source address is denylisted."""
        c = self.compiled
        if c is None or c.entry_count() == 0:
            return torch.zeros(src_addrs.shape[0], dtype=torch.bool,
                               device=src_addrs.device)
        put = lambda x: torch.as_tensor(  # noqa: E731
            x, device=src_addrs.device)
        found, _ = lpm_lookup(put(c.masks), put(c.key_a), put(c.key_b),
                              put(c.value), put(c.prefix_lens), src_addrs,
                              c.max_probe)
        return found

    def drop_mask6(self, src_addrs: torch.Tensor) -> torch.Tensor:
        """[B] bool for [B, 4] v6 source address words."""
        c = self.compiled6
        if c is None or c.entry_count() == 0:
            return torch.zeros(src_addrs.shape[0], dtype=torch.bool,
                               device=src_addrs.device)
        put = lambda x: torch.as_tensor(  # noqa: E731
            x, device=src_addrs.device)
        found, _ = lpm6_lookup(put(c.masks), put(c.k0), put(c.k1),
                               put(c.k2), put(c.k3), put(c.kb),
                               put(c.value), put(c.prefix_lens),
                               src_addrs, c.max_probe)
        return found
