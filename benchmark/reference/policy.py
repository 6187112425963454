"""The policy verdict (Cilium's ``__policy_can_access``): per endpoint,

  1. exact       (identity, dport, proto, direction) -> its proxy port
  2. L3-only     (identity, 0, 0, direction)         -> allow
  3. L4-wildcard (0, dport, proto, direction)        -> its proxy port
  else drop; a fragment matches only the L3 stage and otherwise drops
  with the fragment code.

A verdict is -1 drop, -2 fragment drop, 0 allow or a proxy port.  The
entry that decided counts one packet and the packet's bytes (uint32).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import keys as K
from .hashing import u32

DROP = -1
DROP_FRAG = -2

Key = Tuple[int, int, int, int]   # identity, dport, proto, direction


def _pack(identity, dport, proto, direction):
    return (identity << 25) | ((dport & 0xFFFF) << 9) | \
        ((proto & 0xFF) << 1) | (direction & 1)


class PolicyTable:
    """Per-endpoint ``{Key: proxy_port}`` maps on a device.  Entries get
    global indices in endpoint order, then each map's order; ``keys`` is
    [n, 5] (endpoint, identity, dport, proto, direction) in that order."""

    def __init__(self, maps: List[Dict[Key, int]], device="cpu"):
        self.device = device
        rows = [np.array([(ep,) + k + (v,) for k, v in m.items()],
                         np.int64).reshape(-1, 6)
                for ep, m in enumerate(maps)]
        tab = np.concatenate(rows) if rows else np.zeros((0, 6), np.int64)
        self.keys = tab[:, :5]
        t = torch.as_tensor(tab, device=device)
        self.ep = t[:, 0]
        self.packed = _pack(t[:, 1] & 0xFFFFFFFF, t[:, 2], t[:, 3], t[:, 4])
        # one spare entry, so that an empty table can still be indexed
        self.proxy = torch.cat([t[:, 5], t.new_zeros(1)])
        self.n = tab.shape[0]

    def _find(self, ep, queries) -> List[torch.Tensor]:
        """Global entry index of each packed query in its endpoint's map,
        -1 where absent, for each [B] query tensor."""
        b = ep.shape[0]
        ids = K.group_ids(
            torch.cat([self.ep] + [ep.to(torch.int64)] * len(queries)),
            torch.cat([self.packed] + list(queries)))
        found = K.owners(ids, self.n)[ids[self.n:]]
        return [found[i * b:(i + 1) * b] for i in range(len(queries))]

    def verdict(self, endpoint, identity, dport, proto, direction,
                is_fragment):
        """(verdict [B] int32, entry [B] int64, -1 = none)."""
        ident = u32(identity)
        dp = dport.to(torch.int64)
        pr = proto.to(torch.int64)
        di = direction.to(torch.int64)
        frag = is_fragment != 0
        zero = torch.zeros_like(dp)
        e1, e2, e3 = self._find(endpoint, (_pack(ident, dp, pr, di),
                                           _pack(ident, zero, zero, di),
                                           _pack(zero, dp, pr, di)))
        e1 = torch.where(frag, -1, e1)
        e3 = torch.where(frag, -1, e3)
        entry = torch.where(e1 >= 0, e1, torch.where(e2 >= 0, e2, e3))
        proxy = self.proxy[entry.clamp(min=0)]
        verdict = torch.where(
            e1 >= 0, proxy,
            torch.where(e2 >= 0, 0,
                        torch.where(e3 >= 0, proxy,
                                    torch.where(frag, DROP_FRAG, DROP))))
        return verdict.to(torch.int32), entry

    def count(self, entry, length) -> torch.Tensor:
        """[n, 2] int64 (packets, bytes) the decided entries add."""
        hit = entry >= 0
        idx = torch.where(hit, entry, self.n)
        packets = torch.bincount(idx, minlength=self.n + 1)
        nbytes = torch.bincount(idx, weights=u32(length).to(torch.float64),
                                minlength=self.n + 1)
        return torch.stack([packets, nbytes.to(torch.int64)], 1)[:self.n]
