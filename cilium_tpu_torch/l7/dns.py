"""DNS / FQDN policy: TTL cache, poller, rule injection, batched matching.

Port of ``cilium_tpu/l7/dns.py`` (reference: pkg/fqdn).  ``ToFQDNs``
egress rules are realized by resolving matchNames on an interval
(``DNSPoller``), caching responses with TTL awareness (``DNSCache``) and
rewriting the rules with generated ``ToCIDRSet`` entries
(``inject_to_cidr_set``) that re-enter the policy import path; those
three are host copies.  Every FQDN selector compiles into one DFA table,
and names are matched in batch on the engine's device; a single lookup
(``allowed_one``) walks the same table on the host in C++
(``native.ScalarDFA``), whose failed build raises.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..compiler.regexc import compile_regex_set
from ..device import DeviceLike, resolve_device
from ..ops.dfa_engine import DFAEngine
from ..ops.dfa_ops import bucket_cols, bucket_rows, encode_strings
from ..policy.api import CIDRRule, FQDNSelector, Rule

DNS_POLLER_INTERVAL = 5.0  # reference: dnspoller.go:50 (5s)
MAX_NAME_LEN = 255

# DNS response-code names (RFC 1035 RCODE; the Hubble DNS metric label)
RCODE_NOERROR = 0
RCODE_NXDOMAIN = 3
RCODE_NAMES = {0: "NoError", 1: "FormErr", 2: "ServFail",
               3: "NXDomain", 4: "NotImp", 5: "Refused"}


def _canon(name: str) -> str:
    return name.lower().rstrip(".")


def _any_hit(hits: np.ndarray) -> np.ndarray:
    return hits.any(axis=1) if hits.shape[1] else \
        np.zeros(hits.shape[0], bool)


class DNSCache:
    """TTL-aware name -> IPs cache (reference: pkg/fqdn/cache.go:91)."""

    def __init__(self, min_ttl: int = 0):
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, float]] = {}  # name -> ip -> exp
        self.min_ttl = min_ttl

    def update(self, name: str, ips: Sequence[str], ttl: int,
               now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        exp = now + max(ttl, self.min_ttl)
        with self._lock:
            m = self._entries.setdefault(_canon(name), {})
            for ip in ips:
                m[ip] = max(m.get(ip, 0), exp)

    def lookup(self, name: str, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        with self._lock:
            m = self._entries.get(_canon(name), {})
            return sorted(ip for ip, exp in m.items() if exp > now)

    def gc(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        removed = 0
        with self._lock:
            for name in list(self._entries):
                m = self._entries[name]
                for ip in list(m):
                    if m[ip] <= now:
                        del m[ip]
                        removed += 1
                if not m:
                    del self._entries[name]
        return removed

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)


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
            from ..native import ScalarDFA
            self._scalar = ScalarDFA(self._compiled)

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
        """One live lookup, walked on the host (same answer as
        ``allowed``)."""
        if self._compiled is None:
            return False
        data = _canon(name).encode()
        if len(data) > MAX_NAME_LEN:
            return False
        return bool(self._scalar.match(data).any())


def inject_to_cidr_set(rule: Rule, cache: DNSCache,
                       now: Optional[float] = None) -> bool:
    """Rewrite a rule's ToFQDNs egress into generated ToCIDRSet entries
    from cached resolutions (reference: pkg/fqdn/helpers.go:45
    injectToCIDRSetRules). Returns True if any CIDR was injected."""
    changed = False
    for eg in rule.egress:
        if not eg.to_fqdns:
            continue
        cidrs: List[CIDRRule] = []
        for sel in eg.to_fqdns:
            if sel.match_name:
                for ip in cache.lookup(sel.match_name, now):
                    suffix = "/32" if ":" not in ip else "/128"
                    cidrs.append(CIDRRule(cidr=ip + suffix, generated=True))
            elif sel.match_pattern:
                for name in cache.names():
                    if sel.matches(name):
                        for ip in cache.lookup(name, now):
                            suffix = "/32" if ":" not in ip else "/128"
                            cidrs.append(CIDRRule(cidr=ip + suffix,
                                                  generated=True))
        eg.to_cidr_set = cidrs
        changed = changed or bool(cidrs)
    return changed


class DNSPoller:
    """Periodic matchName resolution driving rule re-injection
    (reference: pkg/fqdn/dnspoller.go — StartDNSPoller loop + config
    LookupDNSNames hook)."""

    def __init__(self, cache: DNSCache,
                 lookup: Callable[[List[str]], Dict[str, Tuple[List[str], int]]],
                 on_change: Optional[Callable[[Set[str]], None]] = None,
                 interval: float = DNS_POLLER_INTERVAL,
                 access_log=None):
        self.cache = cache
        self.lookup = lookup       # names -> {name: (ips, ttl)}
        self.on_change = on_change
        self.interval = interval
        # DNS resolutions enter the L7 access log (and through it the
        # Hubble flow stream + rcode metrics): one record per polled
        # name, rcode NoError/NXDomain from the resolver's answer
        self.access_log = access_log
        self._names: Set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _log_answers(self, results: Dict[str, Tuple[List[str], int]]
                     ) -> None:
        if self.access_log is None:
            return
        from ..proxy import AccessLogEntry  # lazy: avoids module cycle
        for name, (ips, _ttl) in sorted(results.items()):
            rcode = RCODE_NOERROR if ips else RCODE_NXDOMAIN
            self.access_log.log(AccessLogEntry(
                timestamp=time.time(), proxy_id="dns-poller",
                l7_protocol="dns", verdict="forwarded",
                src_identity=0, dst_identity=0,
                info={"query": name, "rcode": rcode,
                      "rcode-name": RCODE_NAMES[rcode],
                      "ips": list(ips)}))

    def register_rule(self, rule: Rule) -> None:
        with self._lock:
            for eg in rule.egress:
                for sel in eg.to_fqdns:
                    if sel.match_name:
                        self._names.add(_canon(sel.match_name))

    def poll_once(self, now: Optional[float] = None) -> Set[str]:
        """One poll cycle; returns names whose IP set changed."""
        with self._lock:
            names = sorted(self._names)
        if not names:
            return set()
        before = {n: tuple(self.cache.lookup(n, now)) for n in names}
        results = self.lookup(names)
        self._log_answers(results)
        for name, (ips, ttl) in results.items():
            self.cache.update(name, ips, ttl, now)
        changed = {n for n in names
                   if tuple(self.cache.lookup(n, now)) != before[n]}
        if changed and self.on_change:
            self.on_change(changed)
        return changed

    def start(self) -> None:
        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.poll_once()
                except Exception:   # resolver failures must not kill the loop
                    pass
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
