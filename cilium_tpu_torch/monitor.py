"""Monitor: datapath event aggregation + subscriber fan-out.

Reference: monitor/ + pkg/monitor — BPF programs emit DropNotify/
TraceNotify into a perf ring; cilium-node-monitor consumes it and fans
out to subscribers over unix sockets (monitor/main.go:81-119), with
decoders in pkg/monitor/datapath_{drop,trace}.go. Here the batched
datapath returns one event code per packet; the hub aggregates counts
(metricsmap analog), keeps a bounded sample ring, and fans decoded
samples out to in-process subscribers (the CLI's ``monitor`` command).

A copy of ``cilium_tpu/monitor.py``.  ``ingest_batch`` also takes the
engine's torch tensors (read to the host once per call).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .datapath.events import (DROP_NAMES, TIER_L7_FAST_ALLOW,
                              TIER_L7_FAST_DENY, TIER_NAMES,
                              TRACE_NAMES, format_denied_key)
from .utils.metrics import (DROP_COUNT, FORWARD_COUNT,
                            L7_FAST_VERDICTS, POLICY_RULE_DROPS,
                            POLICY_VERDICT_TIERS, THREAT_SCORES,
                            THREAT_VERDICTS)
from .kvstore.server import recv_frame, send_frame

# label-cardinality guard: at most this many DISTINCT denied keys are
# admitted into the per-rule drop counter per ingested batch (the
# biggest offenders win; the rest still count under drop_count_total)
MAX_RULE_KEYS_PER_BATCH = 32


def _host(a) -> np.ndarray:
    """A [B] lane as a host numpy array (torch tensors are read once)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


@dataclass(frozen=True)
class MonitorEvent:
    """One decoded sample.

    kind "" = datapath DropNotify/TraceNotify analog (code/endpoint/
    packet fields populated); kind "agent" = AgentNotify analog
    (pkg/monitor/agent events: policy updates, endpoint lifecycle);
    kind "l7" = LogRecordNotify analog (proxy access-log records in
    the monitor stream) — the same three families `cilium monitor`
    prints in the reference."""

    timestamp: float
    code: int            # trace point (>=0) or drop reason (<0)
    endpoint: int
    identity: int
    dport: int
    proto: int
    length: int
    kind: str = ""       # "" | "agent" | "l7"
    note: str = ""
    # hub-assigned monotonic sequence number (perf-ring cursor analog):
    # pollers resume from ?since=<seq> instead of deduping replays
    seq: int = 0
    # verdict provenance (0/"" when provenance is disabled): the
    # decision-tier code (events.TIER_*) and the compiled rule key
    # that decided — the matched policymap entry, or for drops the
    # denied query key (events.format_denied_key)
    tier: int = 0
    matched_rule: str = ""

    @property
    def is_drop(self) -> bool:
        return self.kind == "" and self.code < 0

    def describe(self) -> str:
        if self.kind == "agent":
            return f"AGENT {self.note}"
        if self.kind == "l7":
            return f"L7 {self.note}"
        name = DROP_NAMES.get(self.code) or TRACE_NAMES.get(self.code) or \
            f"code {self.code}"
        kind = "DROP" if self.is_drop else "TRACE"
        prov = ""
        if self.tier:
            prov = f" tier={TIER_NAMES.get(self.tier, self.tier)}"
            if self.matched_rule:
                prov += f" rule={self.matched_rule}"
        return (f"{kind} ep={self.endpoint} identity={self.identity} "
                f"dport={self.dport} proto={self.proto} "
                f"len={self.length}: {name}{prov}")


class MonitorHub:
    """Aggregate + sample + fan out datapath events."""

    def __init__(self, ring_capacity: int = 4096,
                 samples_per_batch: int = 16):
        self.ring_capacity = ring_capacity
        self.samples_per_batch = samples_per_batch
        self._lock = threading.Lock()
        self._ring: List[MonitorEvent] = []
        self._counts: Dict[int, int] = {}
        self._bytes: Dict[int, int] = {}
        self._subscribers: List[Callable[[MonitorEvent], None]] = []
        self.lost = 0  # samples not ringed (perf-ring lost-events analog)
        # AgentNotify / LogRecordNotify counters, keyed by event name
        self._notify_counts: Dict[str, int] = {}
        # monotonic event cursor; 0 is the "from the beginning" sentinel
        self._next_seq = 1
        # provenance: cumulative drops per denied/matched rule key
        # (the "top-dropped rules" surface; fed only when the caller
        # passes tiers/match_slots from an enable_provenance engine)
        self._rule_drops: Dict[str, int] = {}

    # ------------------------------------------------------------ ingest

    def ingest_batch(self, event_codes, endpoints, identities, dports,
                     protos, lengths, tiers=None, match_slots=None,
                     rule_of=None, l7_proto_of=None,
                     threat_out=None) -> None:
        """Aggregate one datapath batch (all args array-like [B]).

        ``tiers``/``match_slots`` are the engine's per-packet
        provenance outputs (Datapath.last_provenance) and ``rule_of``
        its slot->string decoder (Datapath.provenance_rule_of): when
        present, samples carry the decision tier + decided rule,
        verdicts count by tier, and drops aggregate per denied key.
        ``l7_proto_of`` (Datapath.l7_fast_protocol_of) maps a match
        slot to its fast program's protocol tag so rows decided by the
        on-device L7 fast-verdict stage feed
        ``l7_fast_verdicts_total{protocol,outcome}``.

        ``threat_out`` is the engine's packed per-packet threat lane
        (Datapath.last_threat: score | band<<8 | fired): feeds
        ``threat_verdicts_total{outcome}`` and the score histogram."""
        codes = _host(event_codes)
        eps = _host(endpoints)
        ids = _host(identities)
        dps = _host(dports)
        prs = _host(protos)
        lns = _host(lengths)
        trs = None if tiers is None else _host(tiers)
        slots = None if match_slots is None else _host(match_slots)
        now = time.time()

        uniq, cnt = np.unique(codes, return_counts=True)
        drop_bytes: Dict[int, int] = {}
        for code, n in zip(uniq.tolist(), cnt.tolist()):
            drop_bytes[code] = int(lns[codes == code].sum())
            if code < 0:
                DROP_COUNT.inc(n, labels={
                    "reason": DROP_NAMES.get(code, str(code))})
            else:
                FORWARD_COUNT.inc(n)

        if trs is not None:
            for tier, n in zip(*map(np.ndarray.tolist,
                                    np.unique(trs, return_counts=True))):
                POLICY_VERDICT_TIERS.inc(n, labels={
                    "tier": TIER_NAMES.get(tier, str(tier))})
            self._count_l7_fast(trs, slots, l7_proto_of)
        if threat_out is not None:
            self._count_threat(_host(threat_out))
        rule_drops = self._aggregate_rule_drops(codes, ids, dps, prs,
                                                slots, rule_of) \
            if trs is not None else {}

        def _rule(i: int) -> str:
            if trs is None:
                return ""
            if slots is not None and int(slots[i]) >= 0 and \
                    rule_of is not None:
                return rule_of(int(slots[i]))
            if int(codes[i]) < 0:
                return format_denied_key(int(ids[i]), int(dps[i]),
                                         int(prs[i]))
            return ""

        # bounded sampling: first K drops + first K traces per batch
        samples: List[MonitorEvent] = []
        for want_drop in (True, False):
            mask = codes < 0 if want_drop else codes >= 0
            idx = np.flatnonzero(mask)[:self.samples_per_batch]
            for i in idx.tolist():
                samples.append(MonitorEvent(
                    timestamp=now, code=int(codes[i]), endpoint=int(eps[i]),
                    identity=int(ids[i]), dport=int(dps[i]),
                    proto=int(prs[i]), length=int(lns[i]),
                    tier=0 if trs is None else int(trs[i]),
                    matched_rule=_rule(i)))
        with self._lock:
            for code, n in zip(uniq.tolist(), cnt.tolist()):
                self._counts[code] = self._counts.get(code, 0) + int(n)
                self._bytes[code] = self._bytes.get(code, 0) + \
                    drop_bytes[code]
            for rule, n in rule_drops.items():
                self._rule_drops[rule] = \
                    self._rule_drops.get(rule, 0) + n
            # stamp the monotonic cursor under the lock (the seq order
            # IS the ring order — pollers resume from it)
            from dataclasses import replace as _replace
            samples = [_replace(ev, seq=self._next_seq + i)
                       for i, ev in enumerate(samples)]
            self._next_seq += len(samples)
            self._ring.extend(samples)
            if len(self._ring) > self.ring_capacity:
                self._ring = self._ring[-self.ring_capacity:]
            self.lost += max(0, int(codes.shape[0]) - len(samples))
            subs = list(self._subscribers)
        for fn in subs:
            for ev in samples:
                fn(ev)

    @staticmethod
    def _count_l7_fast(trs, slots, l7_proto_of) -> None:
        """Count rows the on-device L7 fast-verdict stage decided into
        l7_fast_verdicts_total{protocol,outcome}.  Protocol resolves
        per distinct match slot (one decode covers the whole group) —
        the fast tiers always carry the decided redirect entry's
        slot."""
        for tier, outcome in ((TIER_L7_FAST_ALLOW, "allow"),
                              (TIER_L7_FAST_DENY, "deny")):
            mask = trs == tier
            total = int(mask.sum())
            if not total:
                continue
            if slots is None or l7_proto_of is None:
                L7_FAST_VERDICTS.inc(total, labels={
                    "protocol": "unknown", "outcome": outcome})
                continue
            uniq, cnt = np.unique(slots[mask], return_counts=True)
            for slot, n in zip(uniq.tolist(), cnt.tolist()):
                proto = l7_proto_of(int(slot)) or "unknown"
                L7_FAST_VERDICTS.inc(int(n), labels={
                    "protocol": proto, "outcome": outcome})

    @staticmethod
    def _count_threat(out: np.ndarray) -> None:
        """Decode one batch's packed threat lane into outcome counts
        + the score histogram (grouped by distinct score so a big
        batch costs at most 256 histogram touches)."""
        from .threat.stage import unpack_threat_out
        score, band, fired = unpack_threat_out(out)
        outcome = np.where(
            fired & (band == 3), 3,
            np.where(fired & (band == 1), 1,
                     np.where(fired & (band == 2), 2, 0)))
        names = {0: "scored", 1: "rate-limited", 2: "redirected",
                 3: "dropped"}
        for code, n in zip(*map(np.ndarray.tolist,
                                np.unique(outcome,
                                          return_counts=True))):
            THREAT_VERDICTS.inc(n, labels={"outcome": names[code]})
        for val, n in zip(*map(np.ndarray.tolist,
                               np.unique(score, return_counts=True))):
            THREAT_SCORES.observe_many(float(val), n)

    @staticmethod
    def _aggregate_rule_drops(codes, ids, dps, prs, slots,
                              rule_of) -> Dict[str, int]:
        """Per-rule-key drop totals for one batch: dropped rows group
        by (identity, dport, proto) — for provenance tiers a drop
        means NO compiled entry matched, so the denied query key IS
        the attribution operators need ("who is being denied what").
        Capped at MAX_RULE_KEYS_PER_BATCH distinct keys (biggest
        first) so one scan can't explode metric cardinality."""
        drop_idx = np.flatnonzero(codes < 0)
        if drop_idx.size == 0:
            return {}
        keyed = np.stack([ids[drop_idx].astype(np.int64),
                          dps[drop_idx].astype(np.int64),
                          prs[drop_idx].astype(np.int64)], axis=1)
        uniq, cnt = np.unique(keyed, axis=0, return_counts=True)
        order = np.argsort(cnt)[::-1][:MAX_RULE_KEYS_PER_BATCH]
        out: Dict[str, int] = {}
        for j in order.tolist():
            rule = format_denied_key(int(uniq[j, 0]), int(uniq[j, 1]),
                                     int(uniq[j, 2]))
            out[rule] = int(cnt[j])
            POLICY_RULE_DROPS.inc(int(cnt[j]), labels={"rule": rule})
        return out

    def top_dropped_rules(self, n: int = 10) -> List[Dict]:
        """The denied rule keys dropping the most packets (cumulative
        since start/reset), largest first."""
        with self._lock:
            items = sorted(self._rule_drops.items(),
                           key=lambda kv: -kv[1])[:n]
        return [{"rule": rule, "packets": count}
                for rule, count in items]

    def _push(self, ev: MonitorEvent, counter: str) -> None:
        from dataclasses import replace as _replace
        with self._lock:
            self._notify_counts[counter] = \
                self._notify_counts.get(counter, 0) + 1
            ev = _replace(ev, seq=self._next_seq)
            self._next_seq += 1
            self._ring.append(ev)
            if len(self._ring) > self.ring_capacity:
                self._ring = self._ring[-self.ring_capacity:]
            subs = list(self._subscribers)
        for fn in subs:
            fn(ev)

    def notify_agent(self, event: str, note: str = "") -> None:
        """AgentNotify analog (pkg/monitor agent events: policy
        updated/deleted, endpoint lifecycle, agent start)."""
        self._push(MonitorEvent(
            timestamp=time.time(), code=0, endpoint=0, identity=0,
            dport=0, proto=0, length=0, kind="agent",
            note=f"{event} {note}".strip()), f"agent:{event}")

    def notify_l7(self, entry) -> None:
        """LogRecordNotify analog: a proxy access-log record enters
        the monitor stream (pkg/proxy/logger -> monitor)."""
        info = " ".join(f"{k}={v}" for k, v in
                        sorted((entry.info or {}).items()))
        self._push(MonitorEvent(
            timestamp=entry.timestamp, code=0, endpoint=0,
            identity=entry.src_identity, dport=0, proto=0, length=0,
            kind="l7",
            note=f"{entry.l7_protocol} {entry.verdict} "
                 f"src={entry.src_identity} dst={entry.dst_identity} "
                 f"{info}".strip()),
            f"l7:{entry.l7_protocol}:{entry.verdict}")

    # --------------------------------------------------------- consumers

    def subscribe(self, fn: Callable[[MonitorEvent], None]) -> Callable:
        """Register a subscriber; returns an unsubscribe closure
        (monitor/main.go fan-out analog)."""
        with self._lock:
            self._subscribers.append(fn)

        def unsubscribe():
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)
        return unsubscribe

    def tail(self, n: int = 100, drops_only: bool = False,
             kind: Optional[str] = None,
             since: int = 0) -> List[MonitorEvent]:
        """Matching samples.  Without ``since``: the last ``n`` (the
        "show me recent events" view).  With ``since``: the OLDEST
        ``n`` with seq > since — forward paging, so a follower that
        fell behind a burst drains it page by page instead of having
        the middle silently capped away (nothing is lost unless it
        fell off the ring, which ``last_seq`` vs the first returned
        seq reveals)."""
        with self._lock:
            ring = list(self._ring)
        if since:
            ring = [e for e in ring if e.seq > since]
        if drops_only:
            ring = [e for e in ring if e.is_drop]
        if kind is not None:
            ring = [e for e in ring if e.kind == kind]
        return ring[:n] if since else ring[-n:]

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._next_seq - 1

    def stats(self) -> Dict[str, Dict]:
        """metricsmap-style dump: per-code packet/byte totals, plus
        agent/l7 notification counts."""
        with self._lock:
            out = {}
            for code, n in sorted(self._counts.items()):
                name = DROP_NAMES.get(code) or TRACE_NAMES.get(code) or \
                    str(code)
                out[name] = {"code": code, "packets": n,
                             "bytes": self._bytes.get(code, 0)}
            for name, n in sorted(self._notify_counts.items()):
                out[name] = {"events": n}
            return out

    def reset(self) -> None:
        with self._lock:
            self._ring = []
            self._counts = {}
            self._bytes = {}
            self._notify_counts = {}
            self._rule_drops = {}
            self.lost = 0


# ---------------------------------------------------------------------------
# Cross-process fan-out (monitor/main.go:81-119)
# ---------------------------------------------------------------------------
#
# The reference's cilium-node-monitor serves decoded events to N
# subscriber processes over a unix socket; slow subscribers get a lossy
# bounded queue, not backpressure into the datapath.  Here the hub is
# served over TCP with the kvstore framing: one writer thread + bounded
# queue per subscriber, overflow counted and dropped.


def _monitor_event_dict(ev: MonitorEvent) -> Dict:
    return {"seq": ev.seq, "timestamp": ev.timestamp, "code": ev.code,
            "endpoint": ev.endpoint, "identity": ev.identity,
            "dport": ev.dport, "proto": ev.proto, "length": ev.length,
            "kind": ev.kind, "note": ev.note, "tier": ev.tier,
            "matched_rule": ev.matched_rule,
            "message": ev.describe()}


class MonitorServer:
    """Serve a MonitorHub's event stream to subscriber processes."""

    def __init__(self, hub: MonitorHub, host: str = "127.0.0.1",
                 port: int = 0, queue_depth: int = 1024):
        import socketserver
        self.hub = hub
        self.queue_depth = queue_depth
        outer = self

        class _Conn(socketserver.BaseRequestHandler):
            def setup(self):
                import queue as _q
                self.q: "_q.Queue" = _q.Queue(maxsize=outer.queue_depth)
                self.dropped = 0
                self.unsub = None

            def handle(self):
                import queue as _q
                # replay the ring, then follow live events
                req = recv_frame(self.request)
                if not req or req.get("op") != "follow":
                    return
                n = int(req.get("replay", 0))
                drops_only = bool(req.get("drops", False))

                def on_event(ev: MonitorEvent) -> None:
                    if drops_only and not ev.is_drop:
                        return
                    try:
                        self.q.put_nowait(ev)
                    except _q.Full:
                        self.dropped += 1  # lossy, never backpressures

                # subscribe BEFORE snapshotting the ring: events
                # ingested while the replay is on the wire land in the
                # queue instead of vanishing in the gap; the queue is
                # then deduped against what the replay already sent
                # (ring and queue share the same event objects)
                self.unsub = outer.hub.subscribe(on_event)
                # filter-before-truncate: replay=N means the last N
                # *matching* samples (hub.tail owns that semantics)
                replay = outer.hub.tail(n, drops_only=drops_only) \
                    if n else []
                replayed_ids = {id(ev) for ev in replay}
                for ev in replay:
                    try:
                        send_frame(self.request,
                                   _monitor_event_dict(ev))
                    except OSError:
                        return
                last_send = time.time()
                while not outer._stop.is_set():
                    try:
                        ev = self.q.get(timeout=0.5)
                    except _q.Empty:
                        # idle ping: the only way to notice a client
                        # that vanished while no events flow — without
                        # it the handler thread + hub subscription
                        # leak forever
                        if time.time() - last_send > 2.0:
                            try:
                                send_frame(self.request, {"ping": 1})
                                last_send = time.time()
                            except OSError:
                                return
                        continue
                    if id(ev) in replayed_ids:
                        replayed_ids.discard(id(ev))
                        continue  # already sent in the replay
                    try:
                        send_frame(self.request,
                                   _monitor_event_dict(ev))
                        last_send = time.time()
                    except OSError:
                        return

            def finish(self):
                if self.unsub is not None:
                    self.unsub()

        class _TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._stop = threading.Event()
        self._tcp = _TCP((host, port), _Conn)
        self.host, self.port = self._tcp.server_address
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True,
                                        name="monitor-server")

    def start(self) -> "MonitorServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()  # handler loops drain within their poll tick
        self._tcp.shutdown()
        self._tcp.server_close()


def monitor_follow(port: int, host: str = "127.0.0.1",
                   replay: int = 0, drops_only: bool = False):
    """Generator of event dicts from a MonitorServer — the subscriber
    half (cilium monitor following from a separate process)."""
    import socket as _socket
    sock = _socket.create_connection((host, port), timeout=10)
    # clear the connect timeout: a quiet stream must block, not
    # silently end after 10 idle seconds (recv timeout would surface
    # as OSError -> recv_frame None -> clean-close ambiguity)
    sock.settimeout(None)
    try:
        send_frame(sock, {"op": "follow", "replay": replay,
                          "drops": drops_only})
        while True:
            msg = recv_frame(sock)
            if msg is None:
                return
            if "ping" in msg:
                continue  # server liveness probe, not an event
            yield msg
    finally:
        sock.close()
