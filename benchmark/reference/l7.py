"""The L7 fast verdict, decided with Python's ``re``.

A row whose policy verdict redirects to a proxy port that has a
first-bytes-decidable program, and whose payload is present (its first
position is not -1) and not truncated (no -2 anywhere), is decided
inline: allowed when one of the program's patterns matches the whole
payload string, denied otherwise.  Every other row keeps its verdict.

The payload lane is [B, W] int32: the match string's bytes, padded with
-1.  An HTTP string is ``method NUL path NUL host``, a DNS string the
lowercased name without its root dot.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ANY_FIELD = "[^\\x00]*"


def http_pattern(rule: Dict) -> str:
    """One rule (``method``, ``path``, ``host`` regexes; a missing one
    matches any field) as a pattern over the HTTP match string."""
    parts = [rule.get(f) or ANY_FIELD for f in ("method", "path", "host")]
    return "\\x00".join(f"(?:{p})" for p in parts)


def dns_pattern(selector: Dict) -> str:
    """An FQDN selector (``match_pattern`` with ``*`` wildcards, or
    ``match_name``) as a pattern over lowercased names."""
    src = (selector.get("match_pattern") or selector["match_name"])
    out = []
    for ch in src.lower().rstrip("."):
        if ch == "*":
            out.append("[-a-z0-9_]*")
        elif ch in ".+()[]{}^$|\\?":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def encode(strings: Sequence, window: int) -> np.ndarray:
    """Match strings -> [n, window] int32 rows: bytes padded with -1, a
    string longer than the window all -2, None all -1."""
    out = np.full((len(strings), window), -1, np.int32)
    for i, s in enumerate(strings):
        if s is None:
            continue
        raw = s.encode()
        if len(raw) > window:
            out[i] = -2
        else:
            out[i, :len(raw)] = np.frombuffer(raw, np.uint8)
    return out


class FastVerdicts:
    """``{proxy port: [patterns]}``: the redirects decided inline."""

    def __init__(self, programs: Dict[int, List[str]]):
        self.ports = sorted(programs)
        self.patterns = [[re.compile(p) for p in programs[port]]
                         for port in self.ports]

    def decide(self, payload: torch.Tensor, verdict: torch.Tensor,
               proxy_port: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fast_allow [B], fast_deny [B]) of rows whose ``verdict``
        redirects through an entry with ``proxy_port``."""
        dev = payload.device
        ports = torch.as_tensor(self.ports, dtype=torch.int64, device=dev)
        prog = torch.searchsorted(ports, proxy_port.to(torch.int64))
        prog = prog.clamp(max=len(self.ports) - 1)
        has_prog = ports[prog] == proxy_port
        fast = (verdict > 0) & has_prog & (payload[:, 0] >= 0) & \
            ~(payload == -2).any(dim=1)
        rows = torch.nonzero(fast).flatten()
        allow = torch.zeros(payload.shape[0], dtype=torch.bool, device=dev)
        if rows.numel():
            # the distinct (payload, program) pairs, matched once each
            uniq, inv = torch.unique(payload[rows], dim=0,
                                     return_inverse=True)
            pair = inv * len(self.ports) + prog[rows]
            pairs, pinv = torch.unique(pair, return_inverse=True)
            texts = uniq.cpu().numpy()
            hit = []
            for p in pairs.tolist():
                row, k = divmod(p, len(self.ports))
                text = bytes(int(v) for v in texts[row] if v >= 0) \
                    .decode("latin-1")
                hit.append(any(r.fullmatch(text) for r in
                               self.patterns[k]))
            allow[rows] = torch.as_tensor(hit, dtype=torch.bool,
                                          device=dev)[pinv]
        return fast & allow, fast & ~allow
