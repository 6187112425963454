"""Connection tracking as a map from a connection's key to its entry,
stated entry by entry (Cilium's ``bpf/lib/conntrack.h``: lifetimes, the
reverse lookup first, RST and FIN closing).

A key is (source, destination, source port, destination port, protocol,
direction); an entry holds its expiry, its related bit, a reverse-NAT
index and a proxy port.  One batch of rows at time ``now`` is one step:

1. Every row looks the table up as it stood before the batch, its
   reverse key first (addresses and ports swapped, the other
   direction).  A live entry (expiring after ``now``) under the reverse
   key makes the row a reply (related where the entry or the row is);
   else one under its own key makes it established; else it is new.
2. A row that found an entry, and that the update mask admits, renews
   it: the entry expires at ``now`` plus the row's lifetime (10 s for a
   TCP row with FIN or RST, 60 s for a bare SYN and for non-TCP, 21,600
   s for other TCP).  Of several rows on one entry, the last row's
   lifetime holds.
3. A new row that both masks admit proposes an entry under its own key:
   expiry ``now`` plus its lifetime (FIN and RST do not shorten it), its
   related bit, reverse-NAT index and proxy port.  Of several rows
   proposing one key, the last row's entry is the one proposed.
4. Capacity: the table has ``slots`` places, and a key may sit only in
   the ``max_probe`` places from its hash onward (wrapping), the hash
   being ``hash_mix(hash_mix(saddr, daddr), hash_mix(ports, proto and
   direction))`` over the key's packed 32-bit words.  A proposed key
   takes the first place of its window that no live entry holds; where
   keys pick one place, the key whose last row comes later takes it and
   the others try once more against the places then held.  A key that
   finds no place is not created.
5. A row's outputs: its state, the reverse-NAT index of the entry it
   found (the reverse one first; 0 where none), and the proxy port of
   the entry under its own key (0 where none).

The garbage collection at time t forgets every entry that expires at or
before t.  The per-direction TCP flags Cilium accumulates in an entry
are not kept: nothing in the step reads them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import keys as K
from .hashing import hash_mix, i32

CT_LIFETIME_TCP = 21600
CT_LIFETIME_NONTCP = 60
CT_SYN_TIMEOUT = 60
CT_CLOSE_TIMEOUT = 10

CT_NEW, CT_ESTABLISHED, CT_REPLY, CT_RELATED = 0, 1, 2, 3

TCP_FIN, TCP_SYN, TCP_RST, TCP_ACK = 0x01, 0x02, 0x04, 0x10

KEY = ("saddr", "daddr", "sport", "dport", "proto", "direction")
VALUES = ("expires", "related", "rev_nat", "proxy_port")
COLUMNS = KEY + VALUES + ("place",)


def words(saddr, daddr, sport, dport, proto, direction):
    """A key's two int64 words."""
    ports = ((sport.to(torch.int64) & 0xFFFF) << 16) | \
        (dport.to(torch.int64) & 0xFFFF)
    rest = ((proto.to(torch.int64) & 0xFF) << 1) | \
        (direction.to(torch.int64) & 1)
    return K.pair(saddr, daddr), (ports << 9) | rest


def table_words(t: K.Table):
    return words(*(t[k] for k in KEY))


def window_start(saddr, daddr, sport, dport, proto, direction,
                 slots: int) -> torch.Tensor:
    """The first place of each key's window, int64."""
    k2 = ((sport.to(torch.int64) & 0xFFFF) << 16) | \
        (dport.to(torch.int64) & 0xFFFF)
    k3 = ((proto.to(torch.int64) & 0xFF) << 8) | \
        ((direction.to(torch.int64) & 1) << 1) | 1
    h = hash_mix(hash_mix(i32(saddr.to(torch.int64)),
                          i32(daddr.to(torch.int64))),
                 hash_mix(i32(k2), i32(k3)))
    return h.to(torch.int64) & (slots - 1)


def lifetime(proto, tcp_flags, closing: bool) -> torch.Tensor:
    """Seconds a row keeps its entry alive; ``closing``: FIN and RST
    shorten it to CT_CLOSE_TIMEOUT."""
    tcp = proto == 6
    syn_only = (tcp_flags & (TCP_SYN | TCP_ACK)) == TCP_SYN
    life = torch.where(
        tcp, torch.where(syn_only, CT_SYN_TIMEOUT, CT_LIFETIME_TCP),
        CT_LIFETIME_NONTCP)
    if closing:
        ends = tcp & ((tcp_flags & (TCP_FIN | TCP_RST)) != 0)
        life = torch.where(ends, CT_CLOSE_TIMEOUT, life)
    return life.to(torch.int64)


def place(starts: torch.Tensor, order: torch.Tensor, held: torch.Tensor,
          max_probe: int) -> torch.Tensor:
    """Places for new keys, in place of ``held`` ([slots] bool): each key
    (window start ``starts``, precedence ``order``, higher first) takes
    the first place of its window not held; where keys pick one place,
    the highest ``order`` takes it, and the others try once more.
    Returns each key's place, -1 where it found none."""
    slots = held.shape[0]
    dev = starts.device
    win = (starts[:, None] +
           torch.arange(max_probe, device=dev)[None, :]) & (slots - 1)
    at = torch.full_like(starts, -1)
    for _ in range(2):
        free = ~held[win]
        todo = (at < 0) & free.any(dim=1)
        cand = win.gather(1, free.to(torch.int8).argmax(dim=1,
                                                        keepdim=True))[:, 0]
        top = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        top.scatter_reduce_(0, cand[todo], order[todo], "amax")
        won = todo & (top[cand] == order)
        at = torch.where(won, cand, at)
        held[cand[won]] = True
    return at


class ConnTable:
    """The map, as columns (``COLUMNS``: the key, the values and each
    entry's place)."""

    def __init__(self, slots: int, max_probe: int, device="cpu"):
        self.slots, self.max_probe, self.device = slots, max_probe, device
        self.clear()

    def clear(self) -> None:
        self.t = {k: torch.zeros(0, dtype=torch.int64, device=self.device)
                  for k in COLUMNS}

    def load(self, table: K.Table) -> None:
        self.t = {k: table[k].to(self.device, torch.int64).clone()
                  for k in COLUMNS}

    def entries(self) -> K.Table:
        return {k: v.clone() for k, v in self.t.items()}

    def forget(self, now: int) -> None:
        """Drop the entries that expire at or before ``now``."""
        self.t = K.select(self.t, self.t["expires"] > now)

    def step(self, saddr, daddr, sport, dport, proto, direction,
             tcp_flags, related, now: int, create, update, rev_nat_in,
             proxy_port_in) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """One batch ([B] tensors; ``create`` and ``update`` bool).
        Returns (state, rev_nat, proxy_port), each [B] int64."""
        self.forget(now)
        t = self.t
        m, b = t["expires"].shape[0], saddr.shape[0]
        dev = saddr.device
        fwd = words(saddr, daddr, sport, dport, proto, direction)
        rev = words(daddr, saddr, dport, sport, proto, 1 - direction)
        have = table_words(t)
        ids = K.group_ids(torch.cat([have[0], fwd[0], rev[0]]),
                          torch.cat([have[1], fwd[1], rev[1]]))
        own = K.owners(ids, m)
        e_fwd, e_rev = own[ids[m:m + b]], own[ids[m + b:]]
        f_found, r_found = e_fwd >= 0, e_rev >= 0
        found = f_found | r_found
        e = torch.where(r_found, e_rev, e_fwd).clamp(min=0)

        def of(col, idx):
            return t[col][idx] if m else torch.zeros_like(idx)
        rel = r_found & ((of("related", e_rev.clamp(min=0)) != 0) |
                         (related != 0))
        state = torch.where(
            r_found, torch.where(rel, CT_RELATED, CT_REPLY),
            torch.where(f_found, CT_ESTABLISHED, CT_NEW))
        rev_nat = torch.where(found, of("rev_nat", e), 0)
        proxy = torch.where(f_found, of("proxy_port", e_fwd.clamp(min=0)),
                            0)

        rows = torch.arange(b, device=dev)
        renew = found & update
        last = torch.full((max(m, 1),), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, e[renew], rows[renew], "amax")
        last = last[:m]
        hit = last >= 0
        life = lifetime(proto, tcp_flags, closing=True)
        t["expires"] = torch.where(hit, now + life[last.clamp(min=0)],
                                   t["expires"])

        new = ~found & create & update
        key_id = ids[m:m + b]
        top = torch.full((m + 2 * b,), -1, dtype=torch.int64, device=dev)
        top.scatter_reduce_(0, key_id[new], rows[new], "amax")
        prop = top[top >= 0]                       # each key's last row
        held = torch.zeros(self.slots, dtype=torch.bool, device=dev)
        held[t["place"]] = True
        at = place(window_start(saddr[prop], daddr[prop], sport[prop],
                                dport[prop], proto[prop],
                                direction[prop], self.slots),
                   prop, held, self.max_probe)
        r = prop[at >= 0]
        add = {"saddr": K.u32(saddr[r]), "daddr": K.u32(daddr[r]),
               "sport": sport[r].to(torch.int64) & 0xFFFF,
               "dport": dport[r].to(torch.int64) & 0xFFFF,
               "proto": proto[r].to(torch.int64) & 0xFF,
               "direction": direction[r].to(torch.int64) & 1,
               "expires": now + lifetime(proto[r], tcp_flags[r],
                                         closing=False),
               "related": (related[r] != 0).to(torch.int64),
               "rev_nat": rev_nat_in[r].to(torch.int64),
               "proxy_port": proxy_port_in[r].to(torch.int64),
               "place": at[at >= 0]}
        self.t = K.concat(t, add)
        return state, rev_nat, proxy
