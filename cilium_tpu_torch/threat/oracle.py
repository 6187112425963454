"""Numpy twin of the fused threat-scoring stage: the bit-exact parity
reference the port's steps are replayed against.

Host copy of ``cilium_tpu/threat/oracle.py``.

Mirrors ``stage.threat_stage`` operation for operation, INCLUDING its
batched-scatter semantics: window resets are same-value sets, counter
adds accumulate (np.add.at), dport span uses order-free min/max
scatters, and the token bucket is batch-granular (every same-batch row
of a bucket sees the same pre-batch token view; consumption lands as
one accumulated debit).  All arithmetic is int32/uint32 wrap — the
same dtypes the device stage runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..compiler.hashtab import hash_mix
from ..datapath.codes import VERDICT_DROP_THREAT
from .model import (CFG_BURST, CFG_DROP, CFG_ENFORCE, CFG_RATE_Q8,
                    CFG_RATELIMIT, CFG_REDIRECT, CFG_REDIRECT_PORT,
                    SCORE_MAX, WEIGHT_Q, ThreatModel)
from .stage import (ARM_DROP, ARM_NONE, ARM_RATELIMIT, ARM_REDIRECT,
                    BUCKET_SALT, COL_DPORT_MAX, COL_DPORT_MIN,
                    COL_TB_TS, COL_TOKENS, COL_WIN_NEW, COL_WIN_TS,
                    LOG_CLAMP, OUT_ARM_SHIFT, OUT_FIRED_BIT)


def log_bucket_np(x: np.ndarray) -> np.ndarray:
    """stage.log_bucket twin: float32 exponent of the clamped value —
    exact over the clamped range, so numpy and torch agree bit for
    bit."""
    xc = np.clip(np.array(x, np.int64), 0, LOG_CLAMP)
    _m, e = np.frexp(xc.astype(np.float32))
    return np.minimum(np.where(xc > 0, e, 0), 16).astype(np.int32)


def flow_snapshot_index(snapshot) -> Dict[Tuple[int, int, int, int, int],
                                          Tuple[int, int, int]]:
    """FlowTable.snapshot() rows -> {(src, dst, dport, proto, event):
    (packets, bytes, last-seen)} for the oracle's probe lookups."""
    return {(f["src-identity"], f["dst-identity"], f["dport"],
             f["proto"], f["event"]):
            (f["packets"], f["bytes"], f["last-seen"]) for f in snapshot}


def _i32(x):
    return np.array(x, np.int64).astype(np.uint32).astype(np.int64)


def oracle_threat_step(state: np.ndarray, model: ThreatModel, verdict,
                       *, identity, dport, proto, tcp_flags, length,
                       is_fragment, established, saddr_w, daddr_w,
                       sport, flow_src, flow_dst, now: int,
                       window_s: int,
                       flow_index: Optional[Dict] = None,
                       stripe: int = 4, exempt=None):
    """One oracle pass over [B] int arrays.  ``state`` is the host
    mirror of the ThreatState buffer ([T+1, STATE_COLS] int32,
    mutated in place); ``flow_index`` is flow_snapshot_index() over
    the PRE-step device flow table (None = flows disabled).

    Returns (verdict' [B], threat_out [B], scores [B], band [B],
    thr_drop [B], thr_redir [B], rl_drop [B])."""
    t = state.shape[0] - 1
    identity = np.array(identity, np.int64)
    dport = np.array(dport, np.int64)
    proto = np.array(proto, np.int64)
    sport = np.array(sport, np.int64)
    length = np.array(length, np.int64)
    verdict = np.array(verdict, np.int32).copy()
    established = np.array(established, bool)
    b = identity.shape[0]
    cfg = model.config.encode()
    now = int(now)

    bucket = (hash_mix(np.uint32(identity & 0xFFFFFFFF),
                       np.full(b, BUCKET_SALT, np.uint32))
              & np.uint32(t - 1)).astype(np.int64)

    # window: striped update slice (stage semantics: one rotating
    # contiguous 1/stripe block contributes per batch), reset expired
    # buckets (same-value sets), accumulate
    st_n = max(1, min(int(stripe), b))
    width = b // st_n if b % st_n == 0 else b
    if width == b:
        sl = slice(0, b)
    else:
        phase = now % st_n
        sl = slice(phase * width, phase * width + width)
    bucket_s = bucket[sl]
    win_ts = state[bucket_s, COL_WIN_TS].astype(np.int64)
    expired = (now - win_ts) >= window_s
    eb = bucket_s[expired]
    state[eb, COL_WIN_TS] = now
    state[eb, COL_WIN_NEW] = 0
    state[eb, COL_DPORT_MIN] = 65535
    state[eb, COL_DPORT_MAX] = 0
    new_flow_s = ~established[sl]
    np.add.at(state[:, COL_WIN_NEW], bucket_s[new_flow_s], 1)
    np.minimum.at(state[:, COL_DPORT_MIN], bucket_s,
                  dport[sl].astype(np.int32))
    np.maximum.at(state[:, COL_DPORT_MAX], bucket_s,
                  dport[sl].astype(np.int32))
    post = state[bucket].astype(np.int64)
    win_new = post[:, COL_WIN_NEW]
    spread = np.maximum(post[:, COL_DPORT_MAX] -
                        post[:, COL_DPORT_MIN], 0)

    # flow probe (allowed-traffic key: event TRACE_TO_LXC == 0)
    found = np.zeros(b, bool)
    fl_pkts = np.zeros(b, np.int64)
    fl_bytes = np.zeros(b, np.int64)
    fl_last = np.zeros(b, np.int64)
    if flow_index is not None:
        fsrc = np.array(flow_src, np.int64)
        fdst = np.array(flow_dst, np.int64)
        for i in range(b):
            key = (int(fsrc[i]), int(fdst[i]), int(dport[i]) & 0xFFFF,
                   int(proto[i]) & 0xFF, 0)
            got = flow_index.get(key)
            if got is not None:
                found[i] = True
                # device reads the uint32 counters as int32 bits
                fl_pkts[i] = np.int32(np.uint32(got[0]))
                fl_bytes[i] = np.int32(np.uint32(got[1]))
                fl_last[i] = got[2]

    syn = (np.array(tcp_flags, np.int64) & 0x02) != 0
    is_tcp = proto == 6
    full = np.full(b, SCORE_MAX, np.int32)
    zero = np.zeros(b, np.int32)
    recency = np.where(found, np.clip(now - fl_last, 0, SCORE_MAX),
                       SCORE_MAX)
    feats = np.stack([
        15 * log_bucket_np(fl_pkts),
        15 * log_bucket_np(fl_bytes),
        recency.astype(np.int32),
        np.where(syn & is_tcp & ~established, full, zero),
        np.where(established, full, zero),
        15 * log_bucket_np(win_new),
        15 * log_bucket_np(spread),
        np.minimum(dport >> 8, SCORE_MAX).astype(np.int32),
        np.where(proto == 17, full, zero),
        15 * log_bucket_np(length),
        np.where(identity == 2, full, zero),
        np.where(np.array(is_fragment, np.int64) != 0, full, zero),
    ], axis=1)
    score = model.score(feats)

    enforce = bool(cfg[CFG_ENFORCE])
    eligible = verdict >= 0
    if exempt is not None:
        eligible = eligible & ~np.array(exempt, bool)
    drop_arm = eligible & (cfg[CFG_DROP] > 0) & (score >= cfg[CFG_DROP])
    redir_arm = eligible & ~drop_arm & (cfg[CFG_REDIRECT] > 0) & \
        (score >= cfg[CFG_REDIRECT])
    rl_arm = eligible & ~drop_arm & ~redir_arm & \
        (cfg[CFG_RATELIMIT] > 0) & (score >= cfg[CFG_RATELIMIT])

    want = rl_arm & enforce
    # token cols are untouched by the window scatters: the post-window
    # gather IS the pre-batch token view (stage.py reads the same)
    dt = np.clip(now - post[:, COL_TB_TS], 0, 3600)
    refilled = np.minimum(int(cfg[CFG_BURST]) << WEIGHT_Q,
                          post[:, COL_TOKENS]
                          + int(cfg[CFG_RATE_Q8]) * dt)
    has_token = refilled >= (1 << WEIGHT_Q)
    with np.errstate(over="ignore"):
        word = np.uint32((sport & 0xFFFF) << 16) | np.uint32(dport
                                                             & 0xFFFF)
        prand = (hash_mix(hash_mix(np.uint32(_i32(saddr_w)),
                                   np.uint32(_i32(daddr_w))),
                          hash_mix(word, np.full(b, np.uint32(
                              np.int64(now) & 0xFFFFFFFF))))
                 & np.uint32(0xFF)).astype(np.int64)
    denom = max(256 - int(cfg[CFG_RATELIMIT]), 1)
    p = np.clip((score.astype(np.int64) - int(cfg[CFG_RATELIMIT]) + 1)
                * 255 // denom, 0, 255)
    rl_drop = want & ~has_token & (prand < p)
    wb = bucket[want]
    state[wb, COL_TOKENS] = refilled[want].astype(np.int32)
    state[wb, COL_TB_TS] = now
    consumed = want & has_token
    np.add.at(state[:, COL_TOKENS], bucket[consumed],
              -(1 << WEIGHT_Q))

    thr_drop = (drop_arm & enforce) | rl_drop
    thr_redir = redir_arm & enforce & (verdict == 0)
    verdict = np.where(
        thr_drop, np.int32(VERDICT_DROP_THREAT),
        np.where(thr_redir, np.int32(cfg[CFG_REDIRECT_PORT]), verdict))

    band = np.where(drop_arm, ARM_DROP,
                    np.where(redir_arm, ARM_REDIRECT,
                             np.where(rl_arm, ARM_RATELIMIT, ARM_NONE))
                    ).astype(np.int32)
    fired = thr_drop | thr_redir
    threat_out = (score | (band << OUT_ARM_SHIFT) |
                  np.where(fired, OUT_FIRED_BIT, 0)).astype(np.int32)
    return (verdict.astype(np.int32), threat_out, score, band,
            thr_drop, thr_redir, rl_drop)
