"""NAT46/64: stateless IPv4 <-> IPv6 address family translation.

Reference: bpf/lib/nat46.h — ipv4_to_ipv6 (:242) embeds the v4 address
under the configured NAT46 prefix (a /96, RFC 6052 shape: prefix words
+ the v4 address as the low 32 bits); ipv6_to_ipv4 (:337) extracts it
back.  The reference rewrites the packet in place and fixes checksums;
here the translation is a batched tensor op over address arrays — the
header rewrite is the caller's NAT result, and the checksum deltas
come from datapath.csum.

Port of ``cilium_tpu/datapath/nat46.py`` in plain torch: v4 addresses
are [B] int32, v6 addresses [B, 4] int32 words (the layouts of the v4
and v6 steps); the prefix words are computed once on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Default translation prefix (reference: NAT46_PREFIX config; RFC 6052
# well-known prefix 64:ff9b::/96).
WK_PREFIX = (0x0064FF9B, 0, 0, 0)


def _prefix_words(prefix) -> np.ndarray:
    w = np.asarray(prefix, np.uint32).view(np.int32)
    if w.shape != (4,):
        raise ValueError("NAT46 prefix is 4 u32 words (/96: w3 unused)")
    return w


def nat46_translate(v4_addrs: torch.Tensor,
                    prefix=WK_PREFIX) -> torch.Tensor:
    """[B] v4 -> [B, 4] v6 under the /96 prefix (ipv4_to_ipv6)."""
    w = torch.as_tensor(_prefix_words(prefix), device=v4_addrs.device)
    out = w[None, :].repeat(v4_addrs.shape[0], 1)
    out[:, 3] = v4_addrs.to(torch.int32)
    return out


def nat64_translate(v6_addrs: torch.Tensor,
                    prefix=WK_PREFIX
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 4] v6 -> ([B] v4, [B] ok) — ok False where the address is
    not under the translation prefix (ipv6_to_ipv4 drops those)."""
    w = [int(x) for x in _prefix_words(prefix)]
    ok = (v6_addrs[:, 0] == w[0]) & (v6_addrs[:, 1] == w[1]) & \
        (v6_addrs[:, 2] == w[2])
    return v6_addrs[:, 3].to(torch.int32), ok


def nat46_roundtrip_ok(v4_addrs: torch.Tensor,
                       prefix=WK_PREFIX) -> torch.Tensor:
    """Sanity helper: translate 4->6->4 and verify identity."""
    back, ok = nat64_translate(nat46_translate(v4_addrs, prefix), prefix)
    return ok & (back == v4_addrs.to(torch.int32))
