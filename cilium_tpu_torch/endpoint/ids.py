"""Stable numeric endpoint ids from runtime-assigned string keys.

A whole copy of ``cilium_tpu/endpoint/ids.py``.

Both container front ends derive the agent endpoint id by hashing the
runtime's identifier (reference: pkg/endpoint/id + the docker driver's
addressing.CiliumIPv6.EndpointID): the CNI plugin from the container
id, the docker libnetwork driver from docker's endpoint UUID.  One
definition here so the mapping cannot drift between them.

The per-caller bases keep typical ids visually distinct but the ranges
overlap (base + [0, 1M)); collisions — across or within front ends —
surface as a 409 from PUT /endpoint/{id}, exactly like a duplicate
create.
"""

from __future__ import annotations

import hashlib

CNI_ID_BASE = 10_000
DOCKER_ID_BASE = 20_000
_SPAN = 1_000_000


def stable_endpoint_id(key: str, base: int) -> int:
    h = hashlib.sha256(key.encode()).digest()
    return base + int.from_bytes(h[:4], "big") % _SPAN
