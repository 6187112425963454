"""Host-side decode of the device analytics buffer: top-K extraction,
merge of several buffers, and the talkers / scanners / spreaders views.

Host copy of ``cilium_tpu/analytics/decode.py``: pure numpy over arrays
handed in by callers (``Datapath.analytics_snapshot``); nothing here
touches a device tensor.

The decode protocol: read the QUIESCED epoch section — the one the
control cell does NOT name — so extraction races nothing; the serving
lane keeps folding batches into the other section.  Mesh-wide answers
merge per-shard sections first (sketch counts add, key tables and
cardinality registers max — both order-free, so shard arrival order
is irrelevant), then decode the merged section once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .stage import (CTRL_COL, KS_IDENTITY, KS_PORT, KS_PREFIX,
                    MET_BYTES, MET_DROPS, MET_PACKETS, N_KEYSPACES,
                    N_METRICS, REG_SALT, ctrl_row, epoch_rows,
                    keytab_row, reg_row, sketch_row, sketch_salt)
from .oracle import _mix

METRICS = {"bytes": MET_BYTES, "packets": MET_PACKETS,
           "drops": MET_DROPS}
VIEWS = ("talkers", "scanners", "spreaders")

# the register value space: lane hashes are uniform over [0, 2^31)
_REG_SPACE = float(1 << 31)


def write_epoch(state: np.ndarray, depth: int, lanes: int) -> int:
    return int(state[ctrl_row(depth, lanes), CTRL_COL])


def epoch_section(state: np.ndarray, epoch: int, depth: int,
                  lanes: int) -> np.ndarray:
    er = epoch_rows(depth, lanes)
    return state[epoch * er:(epoch + 1) * er, :]


def quiesced_section(state: np.ndarray, depth: int,
                     lanes: int) -> np.ndarray:
    """The epoch section host decodes may read race-free."""
    return epoch_section(state, 1 - write_epoch(state, depth, lanes),
                         depth, lanes)


def merge_sections(sections: Sequence[np.ndarray], depth: int,
                   lanes: int) -> np.ndarray:
    """Mesh-wide merge of per-shard epoch sections: sketch counts are
    elementwise adds (int64 — the merged view must not wrap), key
    tables and registers elementwise max."""
    n_sketch = N_KEYSPACES * N_METRICS * depth
    out = np.zeros(sections[0].shape, np.int64)
    for sec in sections:
        sec = np.array(sec, np.int64)
        out[:n_sketch] += sec[:n_sketch]
        np.maximum(out[n_sketch:], sec[n_sketch:],
                   out=out[n_sketch:])
    return out


def cm_query(section: np.ndarray, keyspace: int, metric: int,
             keys: np.ndarray, depth: int) -> np.ndarray:
    """Count-min point query: min over the D hash rows at each key's
    hashed columns (an upper bound on the true count)."""
    keys = np.array(keys, np.int64)
    width = section.shape[1]
    est = None
    for d in range(depth):
        cols = _mix(keys, np.full(keys.shape[0],
                                  sketch_salt(keyspace, d),
                                  np.int64)) & (width - 1)
        row = section[sketch_row(keyspace, metric, d, depth)]
        est = row[cols] if est is None else np.minimum(est, row[cols])
    return np.array(est, np.int64)


def candidate_keys(section: np.ndarray, keyspace: int,
                   depth: int) -> np.ndarray:
    """The device-maintained candidate key ring for a keyspace: the
    non-zero slots of its key-table row (each slot keeps the largest
    key that hashed into it — any persistent heavy hitter holds its
    slot, so top-K extraction never scans the full key domain)."""
    row = section[keytab_row(keyspace, depth)]
    return np.unique(row[row > 0]).astype(np.int64)


def decode_port_key(key: int):
    """(identity, dport) of a KS_PORT key (stage.flow_hash_keys)."""
    return (int(key) >> 16) & 0x7FFF, int(key) & 0xFFFF


def cardinality_estimate(maxima: np.ndarray) -> int:
    """Distinct-flow estimate from the per-lane hash maxima: each lane
    keeps max of n uniform draws over [0, 2^31), whose expectation is
    2^31 * n/(n+1) — invert per lane and average.  Host-side float
    math only; the device/oracle state stays integer and bit-exact."""
    m = np.array(maxima, np.float64)
    live = m > 0
    if not live.any():
        return 0
    est = m[live] / np.maximum(_REG_SPACE - m[live], 1.0)
    return int(round(float(est.mean())))


def top_talkers(section: np.ndarray, depth: int, k: int = 10,
                metric: str = "bytes") -> List[Dict]:
    """Top-K src identities by sketch count of ``metric``."""
    m = METRICS[metric]
    keys = candidate_keys(section, KS_IDENTITY, depth)
    if keys.shape[0] == 0:
        return []
    counts = cm_query(section, KS_IDENTITY, m, keys, depth)
    order = np.argsort(-counts, kind="stable")[:k]
    return [{"identity": int(keys[i]), "metric": metric,
             "count": int(counts[i])} for i in order
            if counts[i] > 0]


def top_scanners(section: np.ndarray, depth: int, k: int = 10,
                 min_dports: int = 16) -> List[Dict]:
    """Scan view: identities ranked by distinct dports touched (from
    the (identity, dport) candidate keys), with the sketch packet
    count summed over their candidate pairs.  ``suspect`` fires at
    ``min_dports`` distinct ports — the dport-span scan signal."""
    keys = candidate_keys(section, KS_PORT, depth)
    if keys.shape[0] == 0:
        return []
    counts = cm_query(section, KS_PORT, MET_PACKETS, keys, depth)
    by_id: Dict[int, Dict] = {}
    for key, cnt in zip(keys.tolist(), counts.tolist()):
        ident, dp = decode_port_key(key)
        ent = by_id.setdefault(ident, {"identity": ident, "dports": 0,
                                       "packets": 0})
        ent["dports"] += 1
        ent["packets"] += int(cnt)
    out = sorted(by_id.values(),
                 key=lambda e: (-e["dports"], -e["packets"]))[:k]
    for ent in out:
        ent["suspect"] = ent["dports"] >= min_dports
    return out


def top_spreaders(section: np.ndarray, depth: int, lanes: int,
                  k: int = 10) -> List[Dict]:
    """Cardinality view: identities ranked by estimated distinct
    flows (their register bucket's lane maxima)."""
    keys = candidate_keys(section, KS_IDENTITY, depth)
    if keys.shape[0] == 0:
        return []
    width = section.shape[1]
    cols = _mix(keys, np.full(keys.shape[0], REG_SALT,
                              np.int64)) & (width - 1)
    regs = np.stack([section[reg_row(lane, depth)][cols]
                     for lane in range(lanes)], axis=1)  # [K, L]
    ests = [cardinality_estimate(regs[i]) for i in range(keys.shape[0])]
    order = np.argsort(-np.array(ests, np.int64),
                       kind="stable")[:k]
    return [{"identity": int(keys[i]), "flows": int(ests[i])}
            for i in order if ests[i] > 0]


def top_prefixes(section: np.ndarray, depth: int, k: int = 10,
                 metric: str = "bytes") -> List[Dict]:
    """Top-K dst /24 prefixes by sketch count of ``metric``."""
    m = METRICS[metric]
    keys = candidate_keys(section, KS_PREFIX, depth)
    if keys.shape[0] == 0:
        return []
    counts = cm_query(section, KS_PREFIX, m, keys, depth)
    order = np.argsort(-counts, kind="stable")[:k]
    return [{"prefix": int(keys[i]), "metric": metric,
             "count": int(counts[i])} for i in order
            if counts[i] > 0]


def decode_view(section: np.ndarray, view: str, depth: int,
                lanes: int, k: int = 10,
                metric: str = "bytes") -> List[Dict]:
    """One named view over a (possibly merged) epoch section."""
    if view == "talkers":
        return top_talkers(section, depth, k=k, metric=metric)
    if view == "scanners":
        return top_scanners(section, depth, k=k)
    if view == "spreaders":
        return top_spreaders(section, depth, lanes, k=k)
    raise KeyError(view)
