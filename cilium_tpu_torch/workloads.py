"""The config-1 workload: a CIDR+port policy and its packet streams.

The port's own copy of ``bench.py:build_config1`` and of the packet
generator of ``bench.py``'s config-1 run (BASELINE.json configs[0]): the
same seeds give the same map states, prefixes and packets.  A second
stream, ``config1_allow_heavy_packets``, sources its packets inside the
policy's prefixes so that a fifth of them or more are allowed.
``Config1Run`` puts one such state on a device behind both engines.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .compiler.lpm import compile_lpm, parse_prefixes
from .compiler.policy_tables import compile_endpoints
from .datapath.pipeline import RawPacketBatch, make_step
from .device import DeviceLike, resolve_device
from .ops.dense_verdict import (compile_dense, compile_dense_lpm,
                                dense_datapath_step, dense_segments)
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


def config1_allow_heavy_packets(batch: int, n_endpoints: int,
                                prefixes: Dict[str, int],
                                states: List[PolicyMapState], seed: int = 3
                                ) -> Dict[str, np.ndarray]:
    """The config-1 stream with its sources drawn inside the policy's
    prefixes (a prefix uniformly, then an address in it), 70% of the
    destination ports drawn from the rules' ports (those of
    ``states[0]``), the rest as in ``config1_packets``, and lengths
    uniform in [40, 1500).  All [batch] int32."""
    pk = config1_packets(batch, n_endpoints, seed=seed)
    rng = np.random.default_rng(seed)
    nets = parse_prefixes(prefixes)
    start = np.array([net[0] for net in nets], np.int64)
    span = np.array([1 << (32 - net[2]) for net in nets], np.int64)
    pick = rng.integers(0, len(nets), batch)
    src = start[pick] + rng.integers(0, span[pick])
    ports = np.array(sorted({k.dest_port for k in states[0]}), np.int32)
    pk["src_addr"] = src.astype(np.uint32).view(np.int32)
    pk["dport"] = np.where(rng.random(batch) < 0.7,
                           rng.choice(ports, batch),
                           pk["dport"]).astype(np.int32)
    pk["length"] = rng.integers(40, 1500, batch).astype(np.int32)
    return pk


TRAFFICS = ("uniform", "allow-heavy")


class Config1Run:
    """One config-1 state on a device, ready to step through both
    engines: the hash step (ipcache LPM hash probes -> 3-stage hash
    verdict) and the dense step (dense LPM -> the dense verdict kernel),
    each with its own counters, on one packet batch of one of
    ``TRAFFICS``: "uniform" (``config1_packets``) or "allow-heavy"
    (``config1_allow_heavy_packets``)."""

    def __init__(self, n_rules: int, batch: int, device: DeviceLike = None,
                 n_endpoints: int = 16):
        self.device = resolve_device(device)
        self.batch, self.n_endpoints = batch, n_endpoints
        self.states, self.prefixes = build_config1(n_rules, n_endpoints)
        self.compiled = compile_endpoints(self.states, revision=1)
        self.lpm = compile_lpm(self.prefixes)
        self.step, self.tables, self.counters = make_step(
            self.compiled, self.lpm, device=self.device)
        self.dense = compile_dense(self.states, device=self.device)
        self.segments = dense_segments(self.dense)
        self.dense_lpm = compile_dense_lpm(self.prefixes, device=self.device)
        n = self.dense.ep.shape[0]
        self.dense_packets = torch.zeros(n, dtype=torch.int32,
                                         device=self.device)
        self.dense_bytes = torch.zeros(n, dtype=torch.int32,
                                       device=self.device)
        self.set_traffic("uniform")

    def set_traffic(self, traffic: str) -> None:
        """Make this run's packet batch from the stream ``traffic`` and
        zero both engines' counters."""
        if traffic == "uniform":
            self.host = config1_packets(self.batch, self.n_endpoints)
        elif traffic == "allow-heavy":
            self.host = config1_allow_heavy_packets(
                self.batch, self.n_endpoints, self.prefixes, self.states)
        else:
            raise ValueError(f"traffic {traffic!r} is none of {TRAFFICS}")
        self.traffic = traffic
        for counter in (*self.counters, self.dense_packets,
                        self.dense_bytes):
            counter.zero_()
        self.pkt = {k: torch.as_tensor(v, device=self.device)
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
            p["proto"], p["direction"], p["length"], segments=self.segments)
