"""Regex -> dense DFA transition tables for batched byte-level matching.

Copy of ``cilium_tpu/compiler/regexc.py`` (host numpy).  Every regex of a
rule set compiles once into a dense DFA transition table, and requests
are matched in batch on the device as a gather walk over bytes (see
``cilium_tpu_torch.ops.dfa_ops`` and ``ops.dfa_engine``).

Pipeline: Python ``re._parser`` AST -> Thompson NFA (epsilon closure) ->
subset-construction DFA over the 256-byte alphabet -> stacked int32
table [S, 256].  Matching is anchored (fullmatch), as the Envoy regex
semantics the reference relies on.

State 0 is the shared dead state.  Several regexes stack into one table
with per-regex start states, so a whole rule set advances in a single
[B, R] gather per byte.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

# Python 3.11+ (the reference falls back to sre_parse on older ones)
import re._constants as sre_c
import re._parser as sre_parse

MAX_DFA_STATES = 4096  # per compile_regex_set call; bound on the tables

_ALL = frozenset(range(256))


class RegexCompileError(ValueError):
    pass


# --- Thompson NFA -----------------------------------------------------------

class _NFA:
    """NFA with epsilon transitions; states are ints."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[Dict[int, Set[int]]] = []  # byte -> states

    def new_state(self) -> int:
        self.eps.append(set())
        self.edges.append({})
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].add(b)

    def add_edge(self, a: int, bytes_: FrozenSet[int], b: int) -> None:
        for c in bytes_:
            self.edges[a].setdefault(c, set()).add(b)


def _category_bytes(cat) -> FrozenSet[int]:
    name = str(cat)
    if "DIGIT" in name:
        s = frozenset(range(0x30, 0x3A))
    elif "WORD" in name:
        s = frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) +
                      list(range(0x61, 0x7B)) + [0x5F])
    elif "SPACE" in name:
        s = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C])
    else:
        raise RegexCompileError(f"unsupported category {cat}")
    if "NOT" in name:
        return _ALL - s
    return s


def _in_bytes(items) -> FrozenSet[int]:
    out: Set[int] = set()
    negate = False
    for op, av in items:
        if op == sre_c.NEGATE:
            negate = True
        elif op == sre_c.LITERAL:
            if av < 256:
                out.add(av)
        elif op == sre_c.RANGE:
            lo, hi = av
            out.update(range(lo, min(hi, 255) + 1))
        elif op == sre_c.CATEGORY:
            out.update(_category_bytes(av))
        else:
            raise RegexCompileError(f"unsupported class item {op}")
    return frozenset(_ALL - out) if negate else frozenset(out)


def _build(nfa: _NFA, ast, start: int) -> int:
    """Append AST's NFA fragment after ``start``; returns accept state."""
    cur = start
    for op, av in ast:
        if op == sre_c.LITERAL:
            if av > 255:
                raise RegexCompileError("non-byte literal")
            nxt = nfa.new_state()
            nfa.add_edge(cur, frozenset([av]), nxt)
            cur = nxt
        elif op == sre_c.NOT_LITERAL:
            nxt = nfa.new_state()
            nfa.add_edge(cur, _ALL - frozenset([av]), nxt)
            cur = nxt
        elif op == sre_c.ANY:
            nxt = nfa.new_state()
            nfa.add_edge(cur, _ALL - frozenset([0x0A]), nxt)  # '.' != \n
            cur = nxt
        elif op == sre_c.IN:
            nxt = nfa.new_state()
            nfa.add_edge(cur, _in_bytes(av), nxt)
            cur = nxt
        elif op == sre_c.CATEGORY:
            nxt = nfa.new_state()
            nfa.add_edge(cur, _category_bytes(av), nxt)
            cur = nxt
        elif op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
            lo, hi, sub = av
            if hi is sre_c.MAXREPEAT or hi >= 2 ** 16:
                hi = None
            # mandatory copies
            for _ in range(lo):
                cur = _build(nfa, sub, cur)
            if hi is None:
                # loop: cur -> frag -> back to cur; skippable
                loop_start = nfa.new_state()
                nfa.add_eps(cur, loop_start)
                frag_end = _build(nfa, sub, loop_start)
                nfa.add_eps(frag_end, loop_start)
                out = nfa.new_state()
                nfa.add_eps(loop_start, out)
                cur = out
            else:
                for _ in range(hi - lo):
                    nxt = _build(nfa, sub, cur)
                    skip = nfa.new_state()
                    nfa.add_eps(cur, skip)
                    nfa.add_eps(nxt, skip)
                    cur = skip
        elif op == sre_c.SUBPATTERN:
            sub = av[3] if isinstance(av, tuple) else av[1]
            cur = _build(nfa, sub, cur)
        elif op == sre_c.BRANCH:
            _, branches = av
            join = nfa.new_state()
            for b in branches:
                b_start = nfa.new_state()
                nfa.add_eps(cur, b_start)
                b_end = _build(nfa, b, b_start)
                nfa.add_eps(b_end, join)
            cur = join
        elif op == sre_c.AT:
            # anchors are no-ops under fullmatch semantics
            continue
        elif op == sre_c.ASSERT or op == sre_c.ASSERT_NOT:
            raise RegexCompileError("lookaround not supported")
        elif op == sre_c.GROUPREF:
            raise RegexCompileError("backreferences not supported")
        else:
            raise RegexCompileError(f"unsupported regex op {op}")
    return cur


def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def byte_equivalence_classes(table: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Alphabet compression: bytes whose transition columns are
    identical across every state collapse into one equivalence class.

    Policy regex sets (HTTP methods/paths, FQDN patterns) distinguish
    few byte groups — typically 10-30 classes out of 256 — so the
    class-indexed table is ~10x smaller than the byte-indexed one and
    k-byte stride tables (ops/dfa_engine) stay small enough for fast
    memory.

    Returns ``(class_of, class_table)``: ``class_of`` [256] int32 maps
    a byte to its class; ``class_table`` [S, C] is the transition table
    reindexed by class, with ``class_table[s, class_of[b]] ==
    table[s, b]`` for every byte b.
    """
    cols = np.ascontiguousarray(table.T)          # [256, S]
    uniq, inv = np.unique(cols, axis=0, return_inverse=True)
    return (inv.reshape(-1).astype(np.int32),
            np.ascontiguousarray(uniq.T.astype(np.int32)))


@dataclass
class CompiledRegexSet:
    """R regexes in one stacked DFA table.

    table: [S, 256] int32 next-state (0 = dead); accept: [S] bool;
    starts: [R] int32 start state per regex.
    """

    table: np.ndarray
    accept: np.ndarray
    starts: np.ndarray
    num_states: int
    patterns: Tuple[str, ...]

    def nbytes(self) -> int:
        return self.table.nbytes

    def byte_classes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Cached (class_of, class_table) — see
        :func:`byte_equivalence_classes`."""
        cached = getattr(self, "_byte_classes", None)
        if cached is None:
            cached = byte_equivalence_classes(self.table)
            object.__setattr__(self, "_byte_classes", cached)
        return cached


def compile_regex_set(patterns: Sequence[str],
                      max_states: int = MAX_DFA_STATES) -> CompiledRegexSet:
    """Compile regexes to one stacked DFA table (anchored/fullmatch)."""
    tables: List[np.ndarray] = []
    accepts: List[np.ndarray] = []
    starts: List[int] = []
    offset = 1  # state 0 = global dead state
    for pat in patterns:
        try:
            ast = sre_parse.parse(pat)
        except re.error as e:
            raise RegexCompileError(f"bad regex {pat!r}: {e}") from e
        nfa = _NFA()
        s0 = nfa.new_state()
        acc = _build(nfa, ast, s0)

        # subset construction
        start_set = _eps_closure(nfa, frozenset([s0]))
        dfa_states: Dict[FrozenSet[int], int] = {start_set: 0}
        order: List[FrozenSet[int]] = [start_set]
        trans: List[List[int]] = []
        i = 0
        while i < len(order):
            cur = order[i]
            row = [-1] * 256
            # collect outgoing bytes
            by_byte: Dict[int, Set[int]] = {}
            for s in cur:
                for c, dsts in nfa.edges[s].items():
                    by_byte.setdefault(c, set()).update(dsts)
            for c, dsts in by_byte.items():
                tgt = _eps_closure(nfa, frozenset(dsts))
                if tgt not in dfa_states:
                    dfa_states[tgt] = len(order)
                    order.append(tgt)
                    if offset + len(order) > max_states:
                        raise RegexCompileError(
                            f"regex {pat!r} exceeds DFA state budget "
                            f"({max_states})")
                row[c] = dfa_states[tgt]
            trans.append(row)
            i += 1

        n = len(order)
        tab = np.zeros((n, 256), np.int32)
        for si, row in enumerate(trans):
            for c, t in enumerate(row):
                tab[si, c] = (t + offset) if t >= 0 else 0
        acc_arr = np.array([acc in st for st in order], bool)
        tables.append(tab)
        accepts.append(acc_arr)
        starts.append(offset)
        offset += n

    total = offset
    table = np.zeros((total, 256), np.int32)
    accept = np.zeros(total, bool)
    for tab, acc_arr, st in zip(tables, accepts, starts):
        table[st:st + tab.shape[0]] = tab
        accept[st:st + tab.shape[0]] = acc_arr
    return CompiledRegexSet(table=table, accept=accept,
                            starts=np.asarray(starts, np.int32),
                            num_states=total, patterns=tuple(patterns))


def oracle_match(pattern: str, text: bytes) -> bool:
    """Host oracle: anchored match like the DFA."""
    return re.fullmatch(pattern.encode() if isinstance(pattern, str)
                        else pattern, text) is not None
