"""HTTP L7 policy: batched request matching via compiled DFAs.

Port of ``cilium_tpu/l7/http.py``.  A request is allowed iff ANY rule of
the set matches; a rule matches iff its method/path/host regexes all
match (anchored) and all its required headers are present (with the
value, when one is given).  Reference: pkg/policy/api/http.go:28 and
envoy/cilium_network_policy.h:90-111.

Method, path and host collapse into ONE regex per rule over the combined
string ``method \\x00 path \\x00 host``, so the rule set is R DFAs walked
together; headers compile to one DFA per requirement over a canonical
``\\x01name: value\\x01...`` block, AND-combined per rule on the device.

Two tiers, as in the reference: batches walk the tables on the engine's
device; a single live request (``check_one``) walks the same compiled
tables on the host in C++ (``native.ScalarDFA``, the
envoy/cilium_l7policy.cc analog), with no device round trip.  The
reference falls back to the batched tier when its native build fails;
here a failed build raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.regexc import compile_regex_set
from ..device import DeviceLike, resolve_device
from ..ops.dfa_engine import DFAEngine
from ..ops.dfa_ops import bucket_cols, bucket_rows, encode_strings
from ..policy.api import PortRuleHTTP

MAX_REQUEST_LINE = 512
MAX_HEADER_BLOCK = 1024


def parse_status_line(line: bytes) -> Optional[int]:
    """``HTTP/1.x NNN Reason`` -> NNN, else None."""
    if not line.startswith(b"HTTP/"):
        return None
    parts = line.split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        return None
    code = int(parts[1])
    return code if 100 <= code <= 599 else None


def rule_to_combined_regex(rule: PortRuleHTTP) -> str:
    """One anchored regex over ``request_line`` for a rule's method, path
    and host (an empty field matches anything but the separator)."""
    m = rule.method if rule.method else "[^\\x00]*"
    p = rule.path if rule.path else "[^\\x00]*"
    h = rule.host if rule.host else "[^\\x00]*"
    return f"(?:{m})\\x00(?:{p})\\x00(?:{h})"


def _header_regex(header: str) -> str:
    name, sep, want = header.partition(" ")
    name_re = "".join(
        f"[{c.lower()}{c.upper()}]" if c.isalpha() else
        ("\\" + c if c in ".+*?()[]{}^$|\\" else c)
        for c in name)
    if sep and want:
        esc = "".join("\\" + c if c in ".+*?()[]{}^$|\\" else c
                      for c in want)
        return f".*\\x01{name_re}: {esc}\\x01.*"
    return f".*\\x01{name_re}: [^\\x01]*\\x01.*"


def _combine_headers(rule_hit: torch.Tensor, hdr_hit: torch.Tensor,
                    hmap: torch.Tensor) -> torch.Tensor:
    """allow[b] = any rule whose regex hit AND whose every header
    requirement hit.  The misses of each header pattern add into its
    rule's column (the reference's ``segment_sum``), so rules with no
    header requirement keep a zero miss count and pass through."""
    miss = (~hdr_hit).to(torch.int32)                       # [B, H]
    per_rule_miss = torch.zeros(rule_hit.shape, dtype=torch.int32,
                                device=rule_hit.device)
    per_rule_miss.index_add_(1, hmap, miss)                 # [B, R]
    return (rule_hit & (per_rule_miss == 0)).any(dim=1)


@dataclass
class HTTPRequest:
    method: str
    path: str
    host: str = ""
    headers: Optional[Dict[str, str]] = None


def request_line(r: HTTPRequest) -> str:
    """The combined match string of a request."""
    return f"{r.method}\x00{r.path}\x00{(r.host or '').lower()}"


def _header_block(r: HTTPRequest) -> str:
    hdrs = r.headers or {}
    canon = "\x01".join(f"{k.lower()}: {v}"
                        for k, v in sorted(hdrs.items()))
    return "\x01" + canon + "\x01"


class HTTPPolicyEngine:
    """One compiled HTTP rule set (one proxy redirect's policy) on one
    device.  ``on_accel`` fixes the DFA engines' selection (see
    ``ops.dfa_engine``); by default it follows the device."""

    def __init__(self, rules: Sequence[PortRuleHTTP],
                 batch_hint: int = 2048, device: DeviceLike = None,
                 on_accel: Optional[bool] = None):
        self.device = resolve_device(device)
        self.rules = list(rules)
        if not self.rules:
            # empty rule set == L7 allow-all (wildcarded redirect)
            self._combined = None
            self._headers = None
            return
        self._combined = compile_regex_set(
            [rule_to_combined_regex(r) for r in self.rules])
        self._eng_c = DFAEngine(self._combined, MAX_REQUEST_LINE,
                                batch_hint=batch_hint, on_accel=on_accel,
                                device=self.device)
        header_patterns: List[str] = []
        self._header_slices: List[Tuple[int, int]] = []
        for r in self.rules:
            start = len(header_patterns)
            header_patterns.extend(_header_regex(h) for h in r.headers)
            self._header_slices.append((start, len(header_patterns)))
        self._headers = compile_regex_set(header_patterns) \
            if header_patterns else None
        if self._headers is not None:
            self._eng_h = DFAEngine(self._headers, MAX_HEADER_BLOCK,
                                    batch_hint=batch_hint,
                                    on_accel=on_accel, device=self.device)
            # header pattern -> owning rule, for the AND-combine
            hmap = np.zeros(len(header_patterns), np.int64)
            for ri, (s, e) in enumerate(self._header_slices):
                hmap[s:e] = ri
            self._hmap = torch.as_tensor(hmap, device=self.device)
        from ..native import ScalarDFA
        self._scalar = ScalarDFA(self._combined)
        self._h_scalar = ScalarDFA(self._headers) \
            if self._headers is not None else None

    def encode(self, requests: Sequence[HTTPRequest]):
        """Host encode: requests -> padded byte blocks (numpy), as
        (data, hdata); hdata is None when no rule carries header
        requirements, both are None for the allow-all engine."""
        if self._combined is None:
            return None, None
        data = bucket_rows(bucket_cols(encode_strings(
            [request_line(r) for r in requests], MAX_REQUEST_LINE)))
        hdata = None
        if self._headers is not None:
            hdata = bucket_rows(bucket_cols(encode_strings(
                [_header_block(r) for r in requests], MAX_HEADER_BLOCK)))
        return data, hdata

    def encode_packed(self, requests: Sequence[HTTPRequest]):
        """Host encode including the engines' class-map/stride packing
        (``DFAEngine.encode``): the PackedBatch pair that feeds
        ``match_device`` with the smallest device program."""
        data, hdata = self.encode(requests)
        if data is None:
            return None, None
        packed = self._eng_c.encode(data)
        hpacked = self._eng_h.encode(hdata) \
            if self._headers is not None else None
        return packed, hpacked

    def match_device(self, data, hdata) -> torch.Tensor:
        """[B'] bool verdicts on the device over pre-encoded blocks (byte
        blocks from ``encode`` or PackedBatches from ``encode_packed``,
        on the host or already on the device).  Reads nothing back to
        the host.  The allow-all engine has no device program."""
        if self._combined is None:
            raise ValueError("allow-all HTTP engine has no device match")
        rule_hit = self._eng_c.match(data)               # [B', R]
        if self._headers is None:
            return rule_hit.any(dim=1)
        hdr_hit = self._eng_h.match(hdata)               # [B', H]
        return _combine_headers(rule_hit, hdr_hit, self._hmap)

    def check_encoded(self, data, hdata, n: int) -> np.ndarray:
        """[:n] bool allows over pre-encoded blocks."""
        if self._combined is None:
            return np.ones(n, bool)
        return self.match_device(data, hdata)[:n].cpu().numpy()

    def check(self, requests: Sequence[HTTPRequest]) -> np.ndarray:
        """Batched verdicts: [B] bool (True == allow)."""
        if self._combined is None:
            return np.ones(len(requests), bool)
        data, hdata = self.encode_packed(requests)
        return self.check_encoded(data, hdata, len(requests))

    def check_pipelined(self, batches: Sequence[Sequence[HTTPRequest]]
                        ) -> List[np.ndarray]:
        """Dispatch every batch (host encode of batch N+1 overlaps the
        device match of batch N), then read all back.  One [n] bool
        array per input batch."""
        inflight: List[Tuple[Optional[torch.Tensor], int]] = []
        for reqs in batches:
            n = len(reqs)
            if self._combined is None:
                inflight.append((None, n))
                continue
            data, hdata = self.encode_packed(reqs)
            inflight.append((self.match_device(data, hdata), n))
        return [np.ones(n, bool) if dev is None else
                dev[:n].cpu().numpy() for dev, n in inflight]

    def dispatch_split(self):
        """(dispatch, finalize) pair: ``dispatch(requests)`` encodes and
        launches the device match with no host read; ``finalize(handle,
        n)`` reads the [n] bool verdicts back.  None for the allow-all
        engine."""
        if self._combined is None:
            return None

        def dispatch(requests):
            data, hdata = self.encode_packed(requests)
            return self.match_device(data, hdata), len(requests)

        def finalize(handle, n):
            dev, real = handle
            return dev[:real].cpu().numpy()

        return dispatch, finalize

    def engine_report(self) -> Optional[dict]:
        """Which strategy, k and dtype each compiled table runs with."""
        if self._combined is None:
            return None
        out = {"combined": self._eng_c.describe()}
        if self._headers is not None:
            out["headers"] = self._eng_h.describe()
        return out

    def check_one(self, request: HTTPRequest) -> bool:
        """One live request — the proxy's per-connection path, walked on
        the host (same verdict as ``check``)."""
        if self._combined is None:
            return True
        line = request_line(request).encode()
        if len(line) > MAX_REQUEST_LINE:
            return False  # overlong never matches (encode_strings -2)
        rule_hit = self._scalar.match(line)                # [R]
        if self._h_scalar is not None and rule_hit.any():
            block = _header_block(request).encode()
            if len(block) > MAX_HEADER_BLOCK:
                # an overlong block poisons the header patterns only
                # (the -2 row): rules with header requirements fail,
                # header-less rules still stand, as in the batched tier
                hdr_hit = np.zeros(self._h_scalar.num_regex, bool)
            else:
                hdr_hit = self._h_scalar.match(block)      # [H]
            for ri, (s, e) in enumerate(self._header_slices):
                if e > s:
                    rule_hit[ri] &= hdr_hit[s:e].all()
        return bool(rule_hit.any())
