"""Fused config-1 step: ipcache LPM resolve + 3-stage policy verdict.

Port of the config-1 part of ``cilium_tpu/datapath/pipeline.py``: the
batched equivalent of the reference's per-packet path (bpf_lxc.c
handle_ipv4_from_lxc → ipcache lookup → policy_can_egress → counters).
Eager torch; the counters are added into in place.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..compiler.lpm import CompiledLPM
from ..compiler.policy_tables import CompiledPolicy
from ..device import DeviceLike, resolve_device
from ..ops.lpm_ops import lpm_lookup
from .codes import WORLD_IDENTITY
from .verdict import Counters, PacketBatch, verdict_step


class DatapathTables(NamedTuple):
    """All device-resident state for the fused step (one generation)."""

    key_id: torch.Tensor     # [E, S] policy tables
    key_meta: torch.Tensor
    value: torch.Tensor
    lpm_masks: torch.Tensor  # [P] ipcache LPM
    lpm_key_a: torch.Tensor  # [P, S2]
    lpm_key_b: torch.Tensor
    lpm_value: torch.Tensor
    lpm_plens: torch.Tensor


class RawPacketBatch(NamedTuple):
    """Pre-identity packet metadata: addresses instead of identities."""

    endpoint: torch.Tensor    # [B] int32 endpoint slot
    src_addr: torch.Tensor    # [B] int32 (uint32 IPv4)
    dport: torch.Tensor       # [B] int32
    proto: torch.Tensor       # [B] int32
    direction: torch.Tensor   # [B] int32
    length: torch.Tensor      # [B] int32
    is_fragment: torch.Tensor  # [B] int32


def datapath_step(tables: DatapathTables, counters: Counters,
                  pkt: RawPacketBatch, *, policy_probe: int,
                  lpm_probe: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, Counters]:
    """addr -> identity (LPM) -> verdict (3-stage) -> counters.

    Returns (verdict [B], identity [B], counters), the counters added
    into in place."""
    found, ident = lpm_lookup(tables.lpm_masks, tables.lpm_key_a,
                              tables.lpm_key_b, tables.lpm_value,
                              tables.lpm_plens, pkt.src_addr, lpm_probe)
    world = torch.full((), WORLD_IDENTITY, dtype=torch.int32,
                       device=ident.device)
    identity = torch.where(found, ident, world)
    vb = PacketBatch(endpoint=pkt.endpoint, identity=identity,
                     dport=pkt.dport, proto=pkt.proto,
                     direction=pkt.direction, length=pkt.length,
                     is_fragment=pkt.is_fragment)
    verdict, counters = verdict_step(tables.key_id, tables.key_meta,
                                     tables.value, counters, vb,
                                     policy_probe)
    return verdict, identity, counters


def build_tables(compiled_policy: CompiledPolicy,
                 compiled_lpm: CompiledLPM,
                 device: DeviceLike = None) -> DatapathTables:
    dev = resolve_device(device)
    put = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.int32), device=dev)
    return DatapathTables(
        key_id=put(compiled_policy.key_id),
        key_meta=put(compiled_policy.key_meta),
        value=put(compiled_policy.value),
        lpm_masks=put(compiled_lpm.masks),
        lpm_key_a=put(compiled_lpm.key_a),
        lpm_key_b=put(compiled_lpm.key_b),
        lpm_value=put(compiled_lpm.value),
        lpm_plens=put(compiled_lpm.prefix_lens))


def make_step(compiled_policy: CompiledPolicy, compiled_lpm: CompiledLPM,
              device: DeviceLike = None
              ) -> Tuple[Callable, DatapathTables, Counters]:
    """(step fn, tables, fresh counters)."""
    dev = resolve_device(device)
    tables = build_tables(compiled_policy, compiled_lpm, device=dev)
    n = max(1, compiled_policy.num_endpoints * compiled_policy.slots)
    counters = Counters(packets=torch.zeros(n, dtype=torch.int32,
                                            device=dev),
                        bytes=torch.zeros(n, dtype=torch.int32,
                                          device=dev))
    step = functools.partial(
        datapath_step, policy_probe=compiled_policy.max_probe,
        lpm_probe=compiled_lpm.max_probe)
    return step, tables, counters
