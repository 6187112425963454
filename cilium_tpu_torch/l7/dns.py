"""DNS / FQDN policy: batched "is this observed name allowed?" matching.

Port of the engine half of ``cilium_tpu/l7/dns.py`` (reference:
pkg/fqdn).  Every FQDN selector compiles into one DFA table, and names
are matched in batch on the engine's device.  The TTL cache, the poller
and the rule injection of the reference are host control plane and not
part of the port yet; single lookups (``allowed_one``) go through the
batched engine.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..compiler.regexc import compile_regex_set
from ..device import DeviceLike, resolve_device
from ..ops.dfa_engine import DFAEngine
from ..ops.dfa_ops import bucket_cols, bucket_rows, encode_strings
from ..policy.api import FQDNSelector

MAX_NAME_LEN = 255


def _canon(name: str) -> str:
    return name.lower().rstrip(".")


def _any_hit(hits: np.ndarray) -> np.ndarray:
    return hits.any(axis=1) if hits.shape[1] else \
        np.zeros(hits.shape[0], bool)


class DNSPolicyEngine:
    """Batched name matcher over all FQDN selectors (the DNS-proxy
    enforcement point) on one device.  ``on_accel`` fixes the DFA
    engine's selection (see ``ops.dfa_engine``); by default it follows
    the device."""

    def __init__(self, selectors: Sequence[FQDNSelector],
                 batch_hint: int = 2048, device: DeviceLike = None,
                 on_accel: Optional[bool] = None):
        self.device = resolve_device(device)
        self.selectors = list(selectors)
        self._compiled = compile_regex_set(
            [s.to_regex() for s in self.selectors]) if self.selectors \
            else None
        if self._compiled is not None:
            self._engine = DFAEngine(self._compiled, MAX_NAME_LEN,
                                     batch_hint=batch_hint,
                                     on_accel=on_accel, device=self.device)

    def encode(self, names: Sequence[str]) -> Optional[np.ndarray]:
        """Host encode: names -> padded byte block (numpy); None when no
        selectors are configured."""
        if self._compiled is None:
            return None
        return bucket_rows(bucket_cols(encode_strings(
            [_canon(n) for n in names], MAX_NAME_LEN)))

    def encode_packed(self, names: Sequence[str]):
        """Host encode including the engine's class-map/stride packing;
        None when no selectors."""
        data = self.encode(names)
        return None if data is None else self._engine.encode(data)

    def match_device(self, data) -> torch.Tensor:
        """[B', R] selector hits on the device over a byte block (from
        ``encode``) or a PackedBatch (from ``encode_packed``), on the
        host or already on the device.  Reads nothing back to the host.
        A selectorless engine has no device program."""
        if self._compiled is None:
            raise ValueError("selectorless DNS engine has no device match")
        return self._engine.match(data)

    def match_encoded(self, data, n: int) -> np.ndarray:
        """[n, R] selector hits over a pre-encoded block."""
        if self._compiled is None:
            return np.zeros((n, 0), bool)
        return self.match_device(data)[:n].cpu().numpy()

    def match(self, names: Sequence[str]) -> np.ndarray:
        """[B, R] selector hits for a batch of names."""
        if self._compiled is None:
            return np.zeros((len(names), 0), bool)
        return self.match_encoded(self.encode_packed(names), len(names))

    def allowed_pipelined(self, batches: Sequence[Sequence[str]]
                          ) -> List[np.ndarray]:
        """Dispatch every batch (host encode of batch N+1 overlaps the
        device match of batch N), then read all back.  One [n] bool
        array per batch."""
        inflight = []
        for names in batches:
            n = len(names)
            if self._compiled is None:
                inflight.append((None, n))
                continue
            inflight.append(
                (self.match_device(self.encode_packed(names)), n))
        return [np.zeros(n, bool) if dev is None else
                _any_hit(dev[:n].cpu().numpy()) for dev, n in inflight]

    def dispatch_split(self):
        """(dispatch, finalize) pair: dispatch encodes and launches the
        selector match with no host read, finalize reads it back and
        reduces to per-name allows.  None when selectorless."""
        if self._compiled is None:
            return None

        def dispatch(names):
            return self.match_device(self.encode_packed(names)), \
                len(names)

        def finalize(handle, n):
            dev, real = handle
            return _any_hit(dev[:real].cpu().numpy())

        return dispatch, finalize

    def engine_report(self) -> Optional[dict]:
        """Engine-selection report."""
        return None if self._compiled is None \
            else self._engine.describe()

    def allowed(self, names: Sequence[str]) -> np.ndarray:
        """[B] bool: the name matches some selector."""
        return _any_hit(self.match(names))

    def allowed_one(self, name: str) -> bool:
        """One live lookup, through the batched engine."""
        if self._compiled is None:
            return False
        return bool(self.allowed([name])[0])
