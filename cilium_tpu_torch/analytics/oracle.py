"""Numpy twin of the fused traffic-analytics stage: the bit-exact
parity reference the port's steps are replayed against.

Host copy of ``cilium_tpu/analytics/oracle.py``.

Mirrors ``stage.analytics_stage`` operation for operation, INCLUDING
its batched-scatter semantics: sketch updates accumulate (np.add.at
with the value-0 no-op for non-drop rows of the drops metric), key
tables and cardinality registers use order-free max scatters
(np.maximum.at), and the update slice stripes by the same
now-derived phase.  All arithmetic is int32/uint32 wrap — the same
dtypes the device stage runs.
"""

from __future__ import annotations

import numpy as np

from ..compiler.hashtab import hash_mix
from .stage import (CTRL_COL, N_KEYSPACES, N_METRICS, REG_SALT,
                    ctrl_row, epoch_rows, keytab_row, keytab_salt,
                    lane_salt, reg_row, sketch_row, sketch_salt)


def _u32(x):
    return np.array(x, np.int64).astype(np.uint32)


def _mix(a, b) -> np.ndarray:
    """hash_mix over uint32 views of int arrays -> int64 lane."""
    with np.errstate(over="ignore"):
        return hash_mix(_u32(a), _u32(b)).astype(np.int64)


def flow_hash_keys_np(identity, dport, daddr_key):
    """stage.flow_hash_keys twin over int64 arrays."""
    identity = np.array(identity, np.int64)
    dport = np.array(dport, np.int64)
    daddr_key = np.array(daddr_key, np.int64).astype(np.int32)
    k_id = identity & 0x7FFFFFFF
    k_port = ((identity & 0x7FFF) << 16) | (dport & 0xFFFF)
    # int32 arithmetic shift + mask, exactly like the device lane
    k_pref = (daddr_key >> 8) & np.int32(0x00FFFFFF)
    return (k_id.astype(np.int64), k_port.astype(np.int64),
            k_pref.astype(np.int64))


def oracle_analytics_step(state: np.ndarray, *, identity, dport,
                          proto, sport, length, verdict, saddr_key,
                          daddr_key, now: int, depth: int, lanes: int,
                          stripe: int = 16) -> None:
    """One oracle pass over [B] int arrays.  ``state`` is the host
    mirror of the AnalyticsState buffer ([R, W] int32, mutated in
    place)."""
    identity = np.array(identity, np.int64)
    dport = np.array(dport, np.int64)
    proto = np.array(proto, np.int64)
    sport = np.array(sport, np.int64)
    length = np.array(length, np.int64)
    verdict = np.array(verdict, np.int64)
    b = identity.shape[0]
    width = state.shape[1]
    cmask = width - 1
    er = epoch_rows(depth, lanes)
    now = int(now)

    base = int(state[ctrl_row(depth, lanes), CTRL_COL]) * er

    st_n = max(1, min(int(stripe), b))
    w = b // st_n if b % st_n == 0 else b
    if w == b:
        sl = slice(0, b)
    else:
        phase = now % st_n
        sl = slice(phase * w, phase * w + w)

    ids = identity[sl]
    dps = dport[sl]
    prs = proto[sl]
    sps = sport[sl]
    lns = length[sl]
    vds = verdict[sl]
    sas = np.array(saddr_key, np.int64)[sl]
    das = np.array(daddr_key, np.int64)[sl]

    keys = flow_hash_keys_np(ids, dps, das)

    one = np.ones(w, np.int64)
    vals = np.stack([lns, one, np.where(vds < 0, 1, 0)],
                    axis=1).astype(np.int32)              # [w, M]
    for k in range(N_KEYSPACES):
        cols = np.stack([
            _mix(keys[k], np.full(w, sketch_salt(k, d), np.int64))
            & cmask for d in range(depth)], axis=1)       # [w, D]
        rows = base + np.array(
            [[sketch_row(k, m, d, depth) for d in range(depth)]
             for m in range(N_METRICS)], np.int64)        # [M, D]
        r = np.broadcast_to(rows[None, :, :],
                            (w, N_METRICS, depth)).reshape(-1)
        c = np.broadcast_to(cols[:, None, :],
                            (w, N_METRICS, depth)).reshape(-1)
        v = np.broadcast_to(vals[:, :, None],
                            (w, N_METRICS, depth)).reshape(-1)
        with np.errstate(over="ignore"):
            np.add.at(state, (r, c), v)

    word = ((sps & 0xFFFF) << 16) | (dps & 0xFFFF)
    fh = _mix(_mix(sas, das), _mix(word, prs))
    reg_col = _mix(ids, np.full(w, REG_SALT, np.int64)) & cmask
    mx_rows, mx_cols, mx_vals = [], [], []
    for k in range(N_KEYSPACES):
        mx_rows.append(np.full(w, base + keytab_row(k, depth),
                               np.int64))
        mx_cols.append(_mix(keys[k], np.full(w, keytab_salt(k),
                                             np.int64)) & cmask)
        mx_vals.append(keys[k])
    for lane in range(lanes):
        mx_rows.append(np.full(w, base + reg_row(lane, depth),
                               np.int64))
        mx_cols.append(reg_col)
        mx_vals.append(_mix(fh, np.full(w, lane_salt(lane), np.int64))
                       & 0x7FFFFFFF)
    np.maximum.at(state, (np.concatenate(mx_rows),
                          np.concatenate(mx_cols)),
                  np.concatenate(mx_vals).astype(np.int32))


def oracle_swap_epoch(state: np.ndarray, depth: int,
                      lanes: int) -> int:
    """Host mirror of engine.swap_analytics_epoch: zero the section
    about to be written and flip the control cell.  Returns the newly
    quiesced epoch index."""
    er = epoch_rows(depth, lanes)
    cur = int(state[ctrl_row(depth, lanes), CTRL_COL])
    nxt = 1 - cur
    state[nxt * er:(nxt + 1) * er, :] = 0
    state[ctrl_row(depth, lanes), CTRL_COL] = nxt
    return cur
