"""Flow records + the bounded host flow ring.

Reference: pkg/hubble/container/ring.go — Hubble keeps a bounded ring
of decoded ``flow.Flow`` protobufs with monotonically increasing
indices that the observer server pages through.  Here a FlowRecord is
built from either a sampled datapath event (monitor.MonitorEvent) or an
L7 access-log record (proxy.AccessLogEntry), and the store hands out
monotonic sequence numbers so followers resume from a cursor instead of
deduping.

A whole copy of ``cilium_tpu/hubble/flow.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List

from ..datapath.events import DROP_NAMES, TRACE_NAMES

VERDICT_FORWARDED = "FORWARDED"
VERDICT_DROPPED = "DROPPED"
VERDICT_REDIRECTED = "REDIRECTED"

PROTO_NAMES = {1: "ICMP", 6: "TCP", 17: "UDP", 58: "ICMPv6"}


def verdict_of_event(code: int) -> str:
    """Datapath event code -> Hubble verdict string."""
    from ..datapath.events import TRACE_TO_PROXY
    if code < 0:
        return VERDICT_DROPPED
    if code == TRACE_TO_PROXY:
        return VERDICT_REDIRECTED
    return VERDICT_FORWARDED


@dataclass(frozen=True)
class FlowRecord:
    """One observable flow sample (flow.Flow analog, flattened)."""

    seq: int                 # store-assigned monotonic cursor
    timestamp: float
    node: str
    verdict: str             # FORWARDED | DROPPED | REDIRECTED
    src_identity: int = 0
    dst_identity: int = 0
    endpoint: int = 0
    dport: int = 0
    proto: int = 0
    length: int = 0
    event: int = 0           # raw datapath event code (0 for L7)
    drop_reason: str = ""    # DROP_NAMES entry when verdict == DROPPED
    # verdict provenance ("" when disabled): decision-tier name
    # (events.TIER_NAMES value) and the compiled rule key that
    # decided — matched policymap entry, or the denied query key
    tier: str = ""
    matched_rule: str = ""
    # owning dataplane shard on a sharded daemon (-1 = unsharded /
    # unknown); stamped by the federated observer so a mesh-wide
    # answer attributes every flow to its fault domain
    shard: int = -1
    l7_protocol: str = ""    # "http" | "dns" | "kafka" | parser name
    l7_method: str = ""      # HTTP method / kafka api / dns qtype
    l7_path: str = ""        # HTTP path / kafka topic / dns name
    l7_status: int = 0       # HTTP response code / DNS rcode
    summary: str = ""

    def to_dict(self) -> Dict:
        # manual field walk: dataclasses.asdict deep-copies per field,
        # which is measurable at federation drain rates (every ringed
        # record passes through here on its way into the store)
        return {f: getattr(self, f)
                for f in self.__dataclass_fields__}

    def describe(self) -> str:
        if self.summary:
            return self.summary
        proto = PROTO_NAMES.get(self.proto, str(self.proto))
        base = (f"{self.verdict:<11} identity {self.src_identity}"
                f"->{self.dst_identity} dport={self.dport} {proto}")
        if self.drop_reason:
            base += f" ({self.drop_reason})"
        if self.tier:
            base += f" tier={self.tier}"
        if self.matched_rule:
            base += f" rule={self.matched_rule}"
        if self.l7_protocol:
            base += (f" {self.l7_protocol}"
                     f" {self.l7_method} {self.l7_path}").rstrip()
        return base


def flow_from_dict(d: Dict) -> FlowRecord:
    """Rebuild a record from its wire dict (relay ingestion)."""
    fields = {f.name for f in FlowRecord.__dataclass_fields__.values()}
    return FlowRecord(**{k: v for k, v in d.items() if k in fields})


def flow_from_event(ev, node: str, seq: int = 0,
                    shard: int = -1) -> FlowRecord:
    """Sampled datapath event (monitor.MonitorEvent, kind "") -> flow."""
    from ..datapath.events import TIER_NAMES
    tier = getattr(ev, "tier", 0)
    return FlowRecord(
        seq=seq, timestamp=ev.timestamp, node=node,
        verdict=verdict_of_event(ev.code),
        src_identity=ev.identity, dst_identity=0,
        endpoint=ev.endpoint, dport=ev.dport, proto=ev.proto,
        length=ev.length, event=ev.code,
        drop_reason=DROP_NAMES.get(ev.code, "") if ev.code < 0 else "",
        tier=TIER_NAMES.get(tier, str(tier)) if tier else "",
        matched_rule=getattr(ev, "matched_rule", ""),
        shard=shard, summary="")


def flow_from_access_log(entry, node: str, seq: int = 0,
                         shard: int = -1) -> FlowRecord:
    """Proxy access-log record (proxy.AccessLogEntry) -> L7 flow."""
    info = entry.info or {}
    status = info.get("status", info.get("rcode", 0))
    try:
        status = int(status)
    except (TypeError, ValueError):
        status = 0
    method = str(info.get("method", info.get("api_key",
                                             info.get("qtype", ""))))
    path = str(info.get("path", info.get("query",
                                         info.get("topics", ""))))
    return FlowRecord(
        seq=seq, timestamp=entry.timestamp, node=node,
        verdict=VERDICT_DROPPED if entry.verdict == "denied"
        else VERDICT_FORWARDED,
        src_identity=entry.src_identity,
        dst_identity=entry.dst_identity,
        l7_protocol=entry.l7_protocol, l7_method=method,
        l7_path=path, l7_status=status, shard=shard, summary="")


class FlowStore:
    """Bounded ring of FlowRecords with monotonic sequence numbers
    (pkg/hubble/container ring analog).  Thread-safe; eviction is
    oldest-first and accounted (``evicted``) so a reader can tell a
    quiet stream from an overrun one."""

    def __init__(self, capacity: int = 8192, seq_source=None):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: List[FlowRecord] = []
        self._next_seq = 1
        # optional shared cursor (hubble/federation.py): per-shard
        # stores of one federated observer draw from ONE monotonic
        # sequence, so a merged answer pages with a single cursor
        self._seq_source = seq_source
        self.evicted = 0

    def add(self, record: FlowRecord) -> FlowRecord:
        """Assign the next sequence number and ring the record;
        returns the stamped record."""
        with self._lock:
            seq = self._seq_source() if self._seq_source is not None \
                else self._next_seq
            self._next_seq = max(self._next_seq, seq) + 1
            stamped = FlowRecord(**{**record.to_dict(), "seq": seq})
            self._ring.append(stamped)
            if len(self._ring) > self.capacity:
                drop = len(self._ring) - self.capacity
                self._ring = self._ring[drop:]
                self.evicted += drop
        return stamped

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._next_seq - 1

    def get(self, flt=None, since: int = 0,
            limit: int = 100) -> List[FlowRecord]:
        """Matching flows, oldest first, at most ``limit``.  Without
        ``since``: the newest matches (the "recent flows" view).  With
        ``since``: the OLDEST matches after the cursor — forward
        paging, so a follower drains a burst page by page instead of
        skipping its middle."""
        with self._lock:
            ring = list(self._ring)
        out = [f for f in ring
               if f.seq > since and (flt is None or flt.matches(f))]
        if limit:
            return out[:limit] if since else out[-limit:]
        return out

    def stats(self) -> Dict:
        with self._lock:
            return {"capacity": self.capacity, "ringed": len(self._ring),
                    "seq": self._next_seq - 1, "evicted": self.evicted}
