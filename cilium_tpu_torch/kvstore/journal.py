"""Bounded write journal for kvstore mutations attempted while degraded.

A whole copy of ``cilium_tpu/kvstore/journal.py``.

Reference: the agent's obligation during a control-plane outage is the
inverse of the dataplane's — keep accepting local mutations (endpoint
creates publish ipcache entries, releases delete slave keys) and make
them durable enough to replay once the kvstore returns
(pkg/kvstore/store's local-key re-synchronisation on reconnect).  The
journal records each mutation with a monotonic sequence number,
coalesces per key (a set followed by a delete of the same key replays
as just the delete, in the delete's position), and bounds its depth so
a very long outage degrades to dropped-oldest accounting instead of
unbounded memory — the reconcile pass repairs anything a dropped entry
would have written via the local-key re-assert.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# journalable mutation kinds (everything else fails fast while degraded)
OP_SET = "set"
OP_DELETE = "delete"
OP_DELETE_PREFIX = "delete_prefix"
OP_CREATE_ONLY = "create_only"
OP_CREATE_IF_EXISTS = "create_if_exists"


@dataclass
class JournalEntry:
    """One journaled mutation, replayed in ``seq`` order."""

    seq: int
    op: str
    key: str
    value: bytes = b""
    lease: bool = False
    cond_key: str = ""           # create_if_exists condition key
    at: float = field(default_factory=time.time)


class WriteJournal:
    """Per-key-coalescing, depth-bounded mutation journal.

    ``record`` appends (coalescing away an older mutation of the same
    key — last-writer-wins keeps the journal depth bounded by the
    distinct touched key set, not the mutation rate); ``snapshot``
    returns the pending entries in sequence order for replay, and
    ``discard`` removes an entry once it has been applied, so a replay
    aborted mid-way by a re-failing backend simply leaves the tail
    queued for the next reconnect.
    """

    def __init__(self, max_entries: int = 8192):
        self.max_entries = max_entries
        self._mu = threading.Lock()
        # coalesce key -> entry; replay order is by entry.seq
        self._entries: Dict[Tuple[str, str], JournalEntry] = {}
        self._seq = 0
        self.appended = 0
        self.coalesced = 0
        self.dropped = 0       # overflow: oldest entries evicted

    # ------------------------------------------------------- recording

    def record(self, op: str, key: str, value: bytes = b"",
               lease: bool = False, cond_key: str = "") -> JournalEntry:
        with self._mu:
            self._seq += 1
            entry = JournalEntry(seq=self._seq, op=op, key=key,
                                 value=value, lease=lease,
                                 cond_key=cond_key)
            # one pending mutation per key: set/delete/create forms
            # coalesce with each other (the LAST one is what the store
            # must end up with)
            ck = (OP_DELETE_PREFIX, key) if op == OP_DELETE_PREFIX \
                else ("k", key)
            if ck in self._entries:
                del self._entries[ck]
                self.coalesced += 1
            if op == OP_DELETE_PREFIX:
                # the prefix delete subsumes every pending mutation of
                # a key under it that was recorded BEFORE it
                doomed = [k for k in self._entries
                          if k[0] == "k" and k[1].startswith(key)]
                for k in doomed:
                    del self._entries[k]
                self.coalesced += len(doomed)
            self._entries[ck] = entry
            self.appended += 1
            while len(self._entries) > self.max_entries:
                oldest = min(self._entries,
                             key=lambda k: self._entries[k].seq)
                del self._entries[oldest]
                self.dropped += 1
            return entry

    # --------------------------------------------------------- replay

    def snapshot(self) -> List[JournalEntry]:
        """Pending entries in replay (sequence) order."""
        with self._mu:
            return sorted(self._entries.values(), key=lambda e: e.seq)

    def discard(self, entry: JournalEntry) -> None:
        """Drop one applied entry (no-op if it was coalesced away by a
        newer mutation while the replay was in flight)."""
        with self._mu:
            for ck, e in list(self._entries.items()):
                if e is entry:
                    del self._entries[ck]
                    return

    def discard_key(self, key: str) -> None:
        """Drop any pending mutation of ``key`` — a successful live
        write supersedes it."""
        with self._mu:
            self._entries.pop(("k", key), None)

    def depth(self) -> int:
        with self._mu:
            return len(self._entries)

    def oldest_age(self) -> Optional[float]:
        with self._mu:
            if not self._entries:
                return None
            return time.time() - min(e.at for e in self._entries.values())

    def stats(self) -> Dict:
        with self._mu:
            return {"depth": len(self._entries),
                    "appended": self.appended,
                    "coalesced": self.coalesced,
                    "dropped": self.dropped}
