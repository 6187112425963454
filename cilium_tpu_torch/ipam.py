"""Host-scope IP address management.

Reference: pkg/ipam — per-node pod-CIDR allocator handing out endpoint
IPs, with reserved network/broadcast/router addresses and
allocate-specific support (restore path re-claims checkpointed IPs).

A whole copy of ``cilium_tpu/ipam.py``.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, List, Optional, Set


class IPAMError(RuntimeError):
    pass


class HostScopeIPAM:
    """Sequential allocator over one pod CIDR."""

    def __init__(self, pod_cidr: str, reserve_first: int = 2):
        self.network = ipaddress.ip_network(pod_cidr, strict=False)
        # network address + router IP(s) are never handed out
        self.reserve_first = reserve_first
        self._lock = threading.Lock()
        self._allocated: Dict[str, str] = {}  # ip -> owner
        self._next = reserve_first
        self._size = self.network.num_addresses

    def _at(self, offset: int) -> str:
        return str(self.network.network_address + offset)

    def router_ip(self) -> str:
        """The reserved router/gateway address (first host IP)."""
        return self._at(1)

    def allocate_next(self, owner: str = "") -> str:
        """Next free IP (ipam.AllocateNext)."""
        with self._lock:
            scanned = 0
            limit = self._size - (1 if self.network.version == 4 and
                                  self._size > 2 else 0)  # broadcast
            while scanned < limit - self.reserve_first:
                off = self._next
                self._next += 1
                if self._next >= limit:
                    self._next = self.reserve_first
                ip = self._at(off)
                if ip not in self._allocated:
                    self._allocated[ip] = owner
                    return ip
                scanned += 1
            raise IPAMError(f"pod CIDR {self.network} exhausted")

    def allocate_ip(self, ip: str, owner: str = "") -> str:
        """Claim a specific IP (the endpoint-restore path)."""
        addr = ipaddress.ip_address(ip)
        if addr not in self.network:
            raise IPAMError(f"{ip} outside pod CIDR {self.network}")
        with self._lock:
            if str(addr) in self._allocated:
                raise IPAMError(f"{ip} already allocated")
            self._allocated[str(addr)] = owner
            return str(addr)

    def release(self, ip: str) -> bool:
        with self._lock:
            return self._allocated.pop(str(ipaddress.ip_address(ip)),
                                       None) is not None

    def release_if_owner(self, ip: str, owner: str) -> bool:
        """Release only when `owner` still holds the address — lets
        the endpoint lifecycle free its own claims without stealing an
        address a different allocator client (e.g. the docker IPAM
        flow) is responsible for releasing."""
        key = str(ipaddress.ip_address(ip))
        with self._lock:
            if self._allocated.get(key) == owner:
                del self._allocated[key]
                return True
            return False

    def owner_of(self, ip: str) -> Optional[str]:
        with self._lock:
            return self._allocated.get(str(ipaddress.ip_address(ip)))

    def allocated(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._allocated)

    def __len__(self):
        with self._lock:
            return len(self._allocated)
