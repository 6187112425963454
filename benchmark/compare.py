"""The comparison that decides ``correct``.

The program's outputs and state are judged against the reference
(``benchmark/reference``), which compiles the generated deployment
itself and steps the same batches at the same times:

- **start**: the reference runs from an empty node through set-up's
  warm-up batches, which went through the window's own path; every
  output of every one of them is compared, and then the conntrack
  map, the flow map and every policy entry's counters against the
  program's state at that point.
- **samples**: ``SAMPLES`` window batches drawn from the seed (a
  reservoir over every batch the window submits).  The reference takes
  the program's conntrack and flow entries as they stood before the
  batch, with the slot each sits in (it cannot replay the whole window
  in less time than the window took), steps the batch, runs the garbage
  collection where one was due, and compares the outputs, both maps
  after it and the counters the batch added.  The start check covers the
  stretch this skips.

The conntrack and flow tables are compared as maps, key by key: the
live conntrack entries (expiry, related bit, reverse-NAT index, proxy
port), every flow entry (packets, bytes, last seen) and the flow
table's lost and update counts; never slot by slot.  Every number
compared is a count of mismatches with the limit 0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import conntrack as ct_mod
from .reference import flows as flow_mod
from .reference import keys as K
from .reference.node import OUTPUTS, Node

LIMIT = 0
# window batches compared in every run
SAMPLES = 3


def _rows_mismatched(ref: Dict, prog: Sequence[torch.Tensor]
                     ) -> Tuple[int, int, int]:
    """(rows with any output differing, of those the rows the reference
    decided by the L7 fast verdict, fast rows)."""
    bad = torch.zeros_like(ref["fast"])
    for name, got in zip(OUTPUTS, prog):
        bad |= ref[name] != got.to(ref[name].device)
    fast = ref["fast"]
    return int(bad.sum()), int((bad & fast).sum()), int(fast.sum())


def _ct_mismatched(ref: K.Table, prog: K.Table, t: int) -> int:
    """Conntrack entries live after time ``t`` that differ, by key."""
    dev = ref["expires"].device
    prog = {k: v.to(dev) for k, v in prog.items()}
    ref = K.select(ref, ref["expires"] > t)
    prog = K.select(prog, prog["expires"] > t)
    return K.mismatched(ct_mod.table_words(ref), K.stack(ref, ct_mod.VALUES),
                        ct_mod.table_words(prog),
                        K.stack(prog, ct_mod.VALUES))


def _flows_mismatched(ref: K.Table, prog: K.Table) -> int:
    """Flow entries that differ, by key, and the lost and update counts
    that differ."""
    bad = K.mismatched(flow_mod.table_words(ref),
                       K.stack(ref, flow_mod.VALUES),
                       flow_mod.table_words(prog),
                       K.stack(prog, flow_mod.VALUES))
    for count in ("lost", "updates"):
        bad += int((int(ref[count]) & 0xFFFFFFFF) !=
                   (int(prog[count]) & 0xFFFFFFFF))
    return bad


def _u32(x: torch.Tensor) -> np.ndarray:
    return (x.to(torch.int64) & 0xFFFFFFFF).cpu().numpy()


class CounterMap:
    """Each program counter slot's policy entry, as the reference
    numbers the entries."""

    def __init__(self, node: Node, keys: Dict[str, np.ndarray]):
        ref = node.policy.keys
        prog = np.stack([np.asarray(keys[c], np.int64) for c in
                         ("endpoint", "identity", "dport", "proto",
                          "direction")], axis=1)

        def words(k):
            k = torch.as_tensor(k)
            return K.pair(k[:, 0], k[:, 1]), \
                (k[:, 2] << 9) | (k[:, 3] << 1) | k[:, 4]
        (r0, r1), (p0, p1) = words(ref), words(prog)
        ids = K.group_ids(torch.cat([r0, p0]), torch.cat([r1, p1]))
        ref_idx = K.owners(ids, ref.shape[0])[ids[ref.shape[0]:]].numpy()
        self.slot = keys["slot"]
        self.ref_idx = ref_idx
        self.n = node.policy.n
        # entries the program does not hold at all
        self.missing = self.n - np.unique(ref_idx[ref_idx >= 0]).shape[0]
        self.foreign = int((ref_idx < 0).sum())

    def mismatched(self, prog: torch.Tensor, ref: torch.Tensor) -> int:
        """Entries whose (packets, bytes) differ; ``prog`` [2, slots]
        (uint32 bits), ``ref`` [n, 2]."""
        p = _u32(prog)[:, self.slot].T                   # [slots, 2]
        r = _u32(ref)
        ok = self.ref_idx >= 0
        differ = (p[ok] != r[self.ref_idx[ok]]).any(axis=1)
        return int(differ.sum()) + self.missing + self.foreign


def judge(node_state, config: Dict, replay: List[Dict],
          start_state: Dict, samples: List[Dict],
          keys: Dict[str, np.ndarray], device, log=print,
          ref_factory=Node) -> List[Tuple[str, int, int]]:
    """The checks, [(name, mismatches, limit)].

    Each batch is a dict: ``packed`` [10, B] and ``payload`` (or None)
    as the system got them, ``now``, ``gc`` (the time of the garbage
    collection that followed it, or None) and the system's
    ``outputs``.  ``replay`` are the batches from the first;
    ``start_state`` the system's state after the last of them; a
    sample adds ``call`` (the step's number from the first) and the
    ``before`` and ``after`` states.  A state is the system's
    ``read_state``: the conntrack and flow maps and the counters."""
    ref = ref_factory(node_state, config["engine"], config.get("l7"),
                      device)
    counter_map = CounterMap(ref, keys)
    rows = l7_rows = fast_rows = 0
    n_rows = 0

    def step(b):
        nonlocal rows, l7_rows, fast_rows, n_rows
        packed = b["packed"].to(device)
        pl = None if b["payload"] is None else b["payload"].to(device)
        out = ref.step(packed, b["now"], pl)
        bad, bad_fast, n_fast = _rows_mismatched(out, b["outputs"])
        rows += bad
        l7_rows += bad_fast
        fast_rows += n_fast
        n_rows += packed.shape[1]
        if b["gc"] is not None:
            ref.gc(b["gc"])

    def settled(b):
        return b["now"] if b["gc"] is None else b["gc"]

    for b in replay:
        step(b)
    ct_bad = _ct_mismatched(ref.ct.entries(), start_state["ct"],
                            settled(replay[-1]))
    flow_bad = _flows_mismatched(ref.flows.entries(), start_state["flows"])
    cnt_bad = counter_map.mismatched(start_state["counters"],
                                     ref.counters)
    log(f"compare: start {len(replay)} batches from empty, ct {ct_bad}, "
        f"flows {flow_bad}, counters {cnt_bad} mismatched")

    for s in samples:
        before, after = s["before"], s["after"]
        ref.load(before)
        ref.calls = s["call"]
        step(s)
        ct_bad += _ct_mismatched(ref.ct.entries(), after["ct"], settled(s))
        flow_bad += _flows_mismatched(ref.flows.entries(), after["flows"])
        added = after["counters"].to(torch.int64) - \
            before["counters"].to(torch.int64)
        cnt_bad += counter_map.mismatched(added, ref.counters)
    log(f"compare: {len(replay) + len(samples)} batches, {n_rows} rows, "
        f"{fast_rows} decided by the L7 fast verdict; samples at steps "
        f"{[s['call'] for s in samples]}")
    checks = [("rows_mismatched", rows, LIMIT),
              ("ct_entries_mismatched", ct_bad, LIMIT),
              ("flow_entries_mismatched", flow_bad, LIMIT),
              ("counters_mismatched", cnt_bad, LIMIT)]
    if config.get("l7"):
        checks.append(("l7_rows_mismatched", l7_rows, LIMIT))
    return checks
