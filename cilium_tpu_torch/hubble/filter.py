"""Hubble flow filter grammar.

Reference: pkg/hubble/filters — the observer applies a conjunction of
predicate filters (identity, verdict, drop reason, port, protocol, L7
method/path, time) to every flow.  Here one FlowFilter is the AND of
its set fields; each field accepts the forms the CLI and the REST
query string produce.  ``from_query``/``to_query`` round-trip through
a flat string map so the relay can fan the exact filter out to peers.

A whole copy of ``cilium_tpu/hubble/filter.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional

from ..datapath.events import DROP_NAMES, TIER_NAMES
from .flow import FlowRecord, PROTO_NAMES

_PROTO_NUMBERS = {v.lower(): k for k, v in PROTO_NAMES.items()}


def parse_proto(value) -> int:
    """"tcp" | "UDP" | "6" | 6 -> protocol number."""
    if isinstance(value, int):
        return value
    s = str(value).strip().lower()
    if s in _PROTO_NUMBERS:
        return _PROTO_NUMBERS[s]
    return int(s)


def parse_verdict(value: str) -> str:
    v = str(value).strip().upper()
    if v not in ("FORWARDED", "DROPPED", "REDIRECTED"):
        raise ValueError(f"unknown verdict {value!r} "
                         "(FORWARDED|DROPPED|REDIRECTED)")
    return v


def parse_tier(value) -> str:
    """Decision-tier name (case-insensitive) or numeric tier code."""
    s = str(value).strip()
    try:
        code = int(s)
    except ValueError:
        lowered = s.lower()
        if lowered in TIER_NAMES.values():
            return lowered
        raise ValueError(
            f"unknown decision tier {value!r} "
            f"({'|'.join(sorted(set(TIER_NAMES.values())))})") from None
    if code not in TIER_NAMES:
        raise ValueError(f"unknown tier code {code}")
    return TIER_NAMES[code]


def parse_drop_reason(value) -> str:
    """Reason name (exact, case-insensitive) or numeric drop code."""
    s = str(value).strip()
    try:
        code = int(s)
    except ValueError:
        lowered = s.lower()
        for name in DROP_NAMES.values():
            if name.lower() == lowered:
                return name
        raise ValueError(f"unknown drop reason {value!r}") from None
    if code not in DROP_NAMES:
        raise ValueError(f"unknown drop code {code}")
    return DROP_NAMES[code]


@dataclass
class FlowFilter:
    """Conjunction of predicates; every None field matches anything."""

    identity: Optional[int] = None       # src OR dst
    src_identity: Optional[int] = None
    dst_identity: Optional[int] = None
    endpoint: Optional[int] = None
    verdict: Optional[str] = None        # FORWARDED|DROPPED|REDIRECTED
    drop_reason: Optional[str] = None    # DROP_NAMES value
    tier: Optional[str] = None           # TIER_NAMES value (provenance)
    dport: Optional[int] = None
    proto: Optional[int] = None
    l7_protocol: Optional[str] = None
    l7_method: Optional[str] = None
    l7_path: Optional[str] = None        # prefix match
    l7_status: Optional[int] = None
    node: Optional[str] = None
    since: int = 0                       # seq cursor (exclusive)

    def matches(self, f: FlowRecord) -> bool:
        if self.since and f.seq <= self.since:
            return False
        if self.identity is not None and \
                self.identity not in (f.src_identity, f.dst_identity):
            return False
        if self.src_identity is not None and \
                f.src_identity != self.src_identity:
            return False
        if self.dst_identity is not None and \
                f.dst_identity != self.dst_identity:
            return False
        if self.endpoint is not None and f.endpoint != self.endpoint:
            return False
        if self.verdict is not None and f.verdict != self.verdict:
            return False
        if self.drop_reason is not None and \
                f.drop_reason != self.drop_reason:
            return False
        if self.tier is not None and f.tier != self.tier:
            return False
        if self.dport is not None and f.dport != self.dport:
            return False
        if self.proto is not None and f.proto != self.proto:
            return False
        if self.l7_protocol is not None and \
                f.l7_protocol != self.l7_protocol:
            return False
        if self.l7_method is not None and f.l7_method != self.l7_method:
            return False
        if self.l7_path is not None and \
                not f.l7_path.startswith(self.l7_path):
            return False
        if self.l7_status is not None and f.l7_status != self.l7_status:
            return False
        if self.node is not None and f.node != self.node:
            return False
        return True

    # ------------------------------------------------- wire round-trip

    _INT_FIELDS = ("identity", "src_identity", "dst_identity",
                   "endpoint", "dport", "l7_status", "since")
    _STR_FIELDS = ("l7_protocol", "l7_method", "l7_path", "node")

    @classmethod
    def from_query(cls, qs: Dict) -> "FlowFilter":
        """Build from a parse_qs-style map ({key: [value, ...]}) or a
        flat {key: value} map.  Raises ValueError on a malformed
        predicate (the REST layer 400s)."""
        def first(key):
            v = qs.get(key)
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
            return v

        flt = cls()
        for name in cls._INT_FIELDS:
            v = first(name)
            if v is not None and str(v) != "":
                setattr(flt, name, int(v))
        for name in cls._STR_FIELDS:
            v = first(name)
            if v is not None and str(v) != "":
                setattr(flt, name, str(v))
        v = first("verdict")
        if v:
            flt.verdict = parse_verdict(v)
        v = first("drop_reason")
        if v:
            flt.drop_reason = parse_drop_reason(v)
        v = first("tier")
        if v:
            flt.tier = parse_tier(v)
        v = first("proto")
        if v:
            flt.proto = parse_proto(v)
        return flt

    def to_query(self) -> Dict[str, str]:
        """Flat string map for fan-out to a peer's /flows (the inverse
        of from_query, minus ``since``/``node`` — cursors and node
        scoping are per-store, never forwarded)."""
        out: Dict[str, str] = {}
        for fld in fields(self):
            if fld.name in ("since", "node"):
                continue
            v = getattr(self, fld.name)
            if v is not None:
                out[fld.name] = str(v)
        return out
