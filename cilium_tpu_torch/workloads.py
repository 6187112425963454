"""The config-1 workload: a CIDR+port policy and a packet stream.

The port's own copy of ``bench.py:build_config1`` and of the packet
generator of ``bench.py``'s config-1 run (BASELINE.json configs[0]): the
same seeds give the same map states, prefixes and packets.  ``Config1Run``
puts one such state on a device behind both engines.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .compiler.lpm import compile_lpm
from .compiler.policy_tables import compile_endpoints
from .datapath.pipeline import RawPacketBatch, make_step
from .device import DeviceLike, resolve_device
from .ops.dense_verdict import (compile_dense, compile_dense_lpm,
                                dense_datapath_step)
from .policy.mapstate import (EGRESS, PolicyKey, PolicyMapState,
                              PolicyMapStateEntry)


def build_config1(n_rules: int = 100, n_endpoints: int = 16, seed: int = 7
                  ) -> Tuple[List[PolicyMapState], Dict[str, int]]:
    """``n_rules`` CIDR+port allow rules -> map states + prefix table.
    Every fifth rule also allows its identity at L3."""
    rng = np.random.default_rng(seed)
    prefixes = {}
    states = [PolicyMapState() for _ in range(n_endpoints)]
    ident = 256
    for i in range(n_rules):
        plen = int(rng.choice([16, 24]))
        addr = f"{rng.integers(1, 224)}.{rng.integers(0, 256)}." + \
            (f"{rng.integers(0, 256)}.0" if plen == 24 else "0.0")
        prefixes[f"{addr}/{plen}"] = ident
        port = int(rng.integers(1, 65536))
        for st in states:
            st[PolicyKey(identity=ident, dest_port=port, nexthdr=6,
                         direction=EGRESS)] = PolicyMapStateEntry()
        if i % 5 == 0:
            for st in states:
                st[PolicyKey(identity=ident,
                             direction=EGRESS)] = PolicyMapStateEntry()
        ident += 1
    return states, prefixes


def config1_packets(batch: int, n_endpoints: int, seed: int = 1
                    ) -> Dict[str, np.ndarray]:
    """The config-1 packet stream: uniform endpoints, uniform source
    addresses over all of IPv4, uniform TCP destination ports, egress,
    512-byte packets.  All [batch] int32."""
    rng = np.random.default_rng(seed)
    return {
        "endpoint": rng.integers(0, n_endpoints, batch, dtype=np.int32),
        "src_addr": rng.integers(0, 2 ** 32, batch, dtype=np.uint32)
        .view(np.int32),
        "dport": rng.integers(1, 65536, batch, dtype=np.int32),
        "proto": np.full(batch, 6, np.int32),
        "direction": np.ones(batch, np.int32),
        "length": np.full(batch, 512, np.int32),
    }


class Config1Run:
    """One config-1 state on a device, ready to step through both
    engines: the hash step (ipcache LPM hash probes -> 3-stage hash
    verdict) and the dense step (dense LPM -> the dense verdict kernel),
    each with its own counters, on one packet batch."""

    def __init__(self, n_rules: int, batch: int, device: DeviceLike = None,
                 n_endpoints: int = 16):
        dev = resolve_device(device)
        self.states, self.prefixes = build_config1(n_rules, n_endpoints)
        self.compiled = compile_endpoints(self.states, revision=1)
        self.lpm = compile_lpm(self.prefixes)
        self.step, self.tables, self.counters = make_step(
            self.compiled, self.lpm, device=dev)
        self.dense = compile_dense(self.states, device=dev)
        self.dense_lpm = compile_dense_lpm(self.prefixes, device=dev)
        n = self.dense.ep.shape[0]
        self.dense_packets = torch.zeros(n, dtype=torch.int32, device=dev)
        self.dense_bytes = torch.zeros(n, dtype=torch.int32, device=dev)
        self.host = config1_packets(batch, n_endpoints)
        self.pkt = {k: torch.as_tensor(v, device=dev)
                    for k, v in self.host.items()}
        self.raw = RawPacketBatch(
            is_fragment=torch.zeros_like(self.pkt["endpoint"]), **self.pkt)

    def hash_step(self):
        """(verdict, identity, counters) of one hash-engine step."""
        return self.step(self.tables, self.counters, self.raw)

    def dense_step(self):
        """(verdict, identity, packets, bytes) of one dense-engine step."""
        p = self.pkt
        return dense_datapath_step(
            self.dense, self.dense_lpm, self.dense_packets,
            self.dense_bytes, p["endpoint"], p["src_addr"], p["dport"],
            p["proto"], p["direction"], p["length"])
