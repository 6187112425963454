"""Service load balancing (Cilium's ``lb4_local`` and ``lb4_rev_nat``).

A packet to a service's (VIP, port, proto) with backends goes to backend
``|h| mod count`` of the service, h the 5-tuple hash, and carries the
service's reverse-NAT index: its position in the service list, from 1.
A reply whose connection recorded an index gets the VIP and port back.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .hashing import hash_mix, u32

# (vip, port, proto, [(backend addr, backend port), ...]); addresses as
# uint32 integers
ServiceSpec = Tuple[int, int, int, Sequence[Tuple[int, int]]]


def _key(vip, port, proto):
    return (vip << 24) | ((port & 0xFFFF) << 8) | (proto & 0xFF)


def _i32(values) -> np.ndarray:
    return np.asarray(values, np.int64).astype(np.uint32).view(np.int32)


class ServiceTable:

    def __init__(self, services: List[ServiceSpec], device="cpu"):
        keys = np.array([_key(v & 0xFFFFFFFF, p, pr)
                         for v, p, pr, _ in services], np.int64)
        order = np.argsort(keys, kind="stable")
        self.keys = torch.as_tensor(keys[order], device=device)
        self.index = torch.as_tensor(order, device=device)
        count = [len(b) for *_, b in services]
        offset = np.concatenate([[0], np.cumsum(count)[:-1]]) \
            if services else np.zeros(0, np.int64)
        put = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=device)
        self.count = put(count)
        self.offset = put(offset)
        addr = [a for *_, b in services for a, _ in b] or [0]
        port = [p for *_, b in services for _, p in b] or [0]
        self.b_addr = torch.as_tensor(_i32(addr), device=device)
        self.b_port = put(port).to(torch.int32)
        # reverse NAT, indexed by the service's position + 1
        self.rev_vip = torch.as_tensor(
            _i32([0] + [v for v, *_ in services]), device=device)
        self.rev_port = torch.as_tensor(
            np.array([0] + [p for _, p, *_ in services], np.int32),
            device=device)

    def step(self, daddr, dport, proto, saddr, sport):
        """(daddr', dport', rev_nat) after DNAT; others pass unchanged
        with rev_nat 0."""
        q = _key(u32(daddr), dport.to(torch.int64), proto.to(torch.int64))
        i = torch.searchsorted(self.keys, q).clamp(max=self.keys.shape[0]
                                                   - 1)
        svc = self.index[i]
        count = self.count[svc]
        ok = (self.keys[i] == q) & (count > 0)
        h = hash_mix(hash_mix(saddr, daddr),
                     hash_mix(((sport & 0xFFFF) << 16) | (dport & 0xFFFF),
                              proto))
        # |h| of the int32 hash, where |-2^31| stays -2^31, and a
        # remainder that takes the divisor's sign
        a = torch.abs(h).to(torch.int64)
        slave = torch.remainder(a, count.clamp(min=1))
        b = (self.offset[svc] + slave).clamp(0, self.b_addr.shape[0] - 1)
        return (torch.where(ok, self.b_addr[b], daddr),
                torch.where(ok, self.b_port[b], dport),
                torch.where(ok, svc + 1, 0).to(torch.int32))

    def rev_nat(self, saddr, sport, rev_nat):
        """(saddr', sport') with the VIP and port of rev_nat > 0."""
        has = rev_nat > 0
        idx = torch.where(has, rev_nat, 0).to(torch.int64).clamp(
            0, self.rev_vip.shape[0] - 1)
        return (torch.where(has, self.rev_vip[idx], saddr),
                torch.where(has, self.rev_port[idx], sport))
