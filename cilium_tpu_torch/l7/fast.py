"""L7 fast-verdict program compiler: which L7 rules are decidable from
the first bytes of a connection, lowered into ONE fused DFA table set
the serving steps walk inline.

Host copy of ``cilium_tpu/l7/fast.py``, numpy only.

- **Eligibility**: an HTTP redirect whose every rule is method / path /
  host regex only (no header requirements: headers may span packets) is
  first-bytes-decidable; a DNS redirect's qname selectors always are.
  Kafka, body-inspection and custom parsers keep the proxy, and so does
  an empty (allow-all) rule set, which exists for visibility.
- **Fusion**: every eligible program's patterns compile into a single
  stacked DFA (``compiler/regexc.compile_regex_set``) with byte
  equivalence classes and a host-precomposed k-stride table (the
  ``ops/dfa_engine`` stride strategy), so the step walks all programs'
  regexes together in ceil(W/k) dependent gathers and reduces per
  packet with a per-program regex mask.

Payload lane ([B, W] int32): the protocol match string (``method\\x00
path\\x00host`` for HTTP, the lowercased qname for DNS) padded with -1;
a row whose string exceeds the window is poisoned with -2
(``ops/dfa_ops.encode_strings``).  Absent (all -1) and poisoned rows are
not decidable and keep redirect-to-proxy: fail to redirect, never open.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.policy_tables import compile_l7_classification
from ..compiler.regexc import compile_regex_set
from ..ops.dfa_ops import encode_strings
from .http import rule_to_combined_regex

# protocol tags
FAST_HTTP = "http"
FAST_DNS = "dns"

# stride-table bounds of the fused walk (tighter than the standalone
# DFAEngine's: the table rides with every serving step)
MAX_FAST_COLS = 1 << 15
FAST_STRIDE_BUDGET = 8 << 20
MAX_FAST_STRIDE = 4
# default payload window W
DEFAULT_WINDOW = 64


def classify_http(rules) -> Optional[List[str]]:
    """Combined method/path/host patterns when the HTTP rule set is
    first-bytes-decidable, else None (redirect to the proxy): empty rule
    sets and rules with header requirements are not."""
    rules = list(rules or [])
    if not rules:
        return None
    patterns = []
    for r in rules:
        if getattr(r, "headers", None):
            return None
        patterns.append(rule_to_combined_regex(r))
    return patterns


def classify_dns(selectors) -> Optional[List[str]]:
    """qname patterns of a DNS selector set, else None when empty."""
    selectors = list(selectors or [])
    if not selectors:
        return None
    return [s.to_regex() for s in selectors]


def classify(parser_type: str, rules) -> Optional[Tuple[str, List[str]]]:
    """(protocol tag, patterns) when ``parser_type``'s rule set is
    first-bytes-decidable, else None (Kafka and other parsers always
    redirect)."""
    if parser_type == "http":
        pats = classify_http(rules)
        return None if pats is None else (FAST_HTTP, pats)
    if parser_type == "dns":
        pats = classify_dns(rules)
        return None if pats is None else (FAST_DNS, pats)
    return None


@dataclass(frozen=True)
class FastProgramSpec:
    """One eligible redirect: the proxy port its policy entries carry,
    its protocol tag and its anchored patterns."""

    port: int
    protocol: str
    patterns: Tuple[str, ...]


@dataclass
class L7FastPrograms:
    """The fused table set of every first-bytes-decidable program: one
    stacked class-compressed k-stride DFA and the per-program regex
    masks.  Host numpy, int32 throughout; the engine uploads them with
    its table generation."""

    flat: np.ndarray       # [S * c1**k] precomposed stride table
    cmap: np.ndarray       # [258] byte+2 -> class (identity class last)
    accept: np.ndarray     # [S] 0/1 per-state accept
    starts: np.ndarray     # [R] per-regex start state
    pmask: np.ndarray      # [P, R] program -> its regex rows
    k: int                 # stride (bytes a dependent gather)
    c1: int                # classes + 1 (identity)
    window: int            # payload window W
    port_to_prog: Dict[int, int]
    protocols: Tuple[str, ...] = ()   # [P] protocol tag per program
    states: int = 0
    specs: Tuple[FastProgramSpec, ...] = ()

    def protocol_of_port(self, port: int) -> str:
        p = self.port_to_prog.get(int(port))
        return self.protocols[p] if p is not None else ""

    def progs_for_values(self, values: np.ndarray) -> np.ndarray:
        """Per-slot program ids of a policy value array
        (``compile_l7_classification``)."""
        return compile_l7_classification(values, self.port_to_prog)

    def nbytes(self) -> int:
        return int(self.flat.nbytes + self.cmap.nbytes +
                   self.accept.nbytes + self.starts.nbytes +
                   self.pmask.nbytes)

    def describe(self) -> Dict:
        return {"programs": len(self.protocols),
                "regexes": int(self.starts.shape[0]),
                "states": self.states, "k": self.k,
                "classes": self.c1 - 1, "window": self.window,
                "resident_bytes": self.nbytes(),
                "protocols": {p: self.protocols.count(p)
                              for p in set(self.protocols)}}


def build_fast_programs(specs: Sequence[FastProgramSpec],
                        window: int = DEFAULT_WINDOW) -> L7FastPrograms:
    """Lower every eligible program into the fused table set: all
    patterns in ONE stacked DFA, program p owning a contiguous range of
    regex rows (its ``pmask`` row)."""
    specs = tuple(specs)
    if not specs:
        raise ValueError("no fast-eligible L7 programs to build")
    patterns: List[str] = []
    ranges: List[Tuple[int, int]] = []
    for spec in specs:
        start = len(patterns)
        patterns.extend(spec.patterns)
        ranges.append((start, len(patterns)))
    compiled = compile_regex_set(patterns)
    s = int(compiled.num_states)
    class_of, class_tab = compiled.byte_classes()
    num_classes = int(class_tab.shape[1])
    c1 = num_classes + 1
    # the largest stride whose precomposed table stays in the budget
    k = 1
    while (k < MAX_FAST_STRIDE and c1 ** (k + 1) <= MAX_FAST_COLS
           and s * c1 ** (k + 1) * 4 <= FAST_STRIDE_BUDGET):
        k += 1
    # identity class as the last column: negative bytes (pad, poison)
    # compose as the identity function
    tab_c = np.concatenate(
        [class_tab, np.arange(s, dtype=np.int32)[:, None]], axis=1)
    t = tab_c
    for _ in range(k - 1):
        t = tab_c[t].reshape(s, -1)
    flat = np.ascontiguousarray(t.astype(np.int32)).reshape(-1)
    map258 = np.full(258, num_classes, np.int32)
    map258[2:] = class_of
    r = len(patterns)
    pmask = np.zeros((len(specs), r), np.int32)
    for p, (a, b) in enumerate(ranges):
        pmask[p, a:b] = 1
    return L7FastPrograms(
        flat=flat, cmap=map258,
        accept=compiled.accept.astype(np.int32),
        starts=compiled.starts.astype(np.int32),
        pmask=pmask, k=k, c1=c1, window=int(window),
        port_to_prog={int(sp.port): i for i, sp in enumerate(specs)},
        protocols=tuple(sp.protocol for sp in specs),
        states=s, specs=specs)


def programs_from_redirects(redirects, window: int = DEFAULT_WINDOW,
                            dns_selectors: Optional[Dict] = None
                            ) -> Optional[L7FastPrograms]:
    """Classify a ``ProxyManager`` redirect list (``proxy.Redirect``,
    plus optional {proxy_port: FQDN selector list} DNS entries) and
    build the fused set from the eligible ones; None when nothing
    qualifies: every redirect keeps the proxy path."""
    specs: List[FastProgramSpec] = []
    for redir in redirects:
        flt = getattr(redir, "l7_filter", None)
        rules = None
        if flt is not None and getattr(flt, "l7_rules_per_ep", None) \
                is not None:
            resolved = flt.l7_rules_per_ep.get_relevant_rules(None)
            rules = resolved.http if resolved is not None else None
        got = classify(redir.parser_type, rules)
        if got is None:
            continue
        proto, pats = got
        specs.append(FastProgramSpec(port=int(redir.proxy_port),
                                     protocol=proto,
                                     patterns=tuple(pats)))
    for port, sels in (dns_selectors or {}).items():
        pats = classify_dns(sels)
        if pats is not None:
            specs.append(FastProgramSpec(port=int(port),
                                         protocol=FAST_DNS,
                                         patterns=tuple(pats)))
    if not specs:
        return None
    return build_fast_programs(specs, window=window)


# ---------------------------------------------------------------------------
# Payload encoding (the host half of the payload lane)
# ---------------------------------------------------------------------------

def http_match_string(method: str, path: str, host: str = "") -> str:
    """The HTTP match string, framed as the proxy-side engine frames it
    (``l7/http.request_line``)."""
    return f"{method}\x00{path}\x00{(host or '').lower()}"


def dns_match_string(name: str) -> str:
    """Canonical qname: lowercased, root dot stripped."""
    return name.lower().rstrip(".")


def encode_payloads(strings: Sequence[Optional[str]],
                    window: int) -> np.ndarray:
    """Match strings -> the [B, W] int32 payload lane: -1 padding, -2
    poison for rows longer than the window, all -1 for None (absent)."""
    out = encode_strings([s or "" for s in strings], window)
    for i, s in enumerate(strings):
        if s is None:
            out[i] = -1
    return out
