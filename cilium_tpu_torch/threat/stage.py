"""The fused per-packet threat-scoring stage, in torch.

Port of ``cilium_tpu/threat/stage.py``.  It runs inside both family
steps behind the ``with_threat`` flag (``datapath/pipeline.py``), right
after the final verdict precedence: every packet gets a 0..255 anomaly
score from

  * the Hubble flow-table probe (per-flow packet/byte counters and
    last-seen, read from the table the flow tail updates afterwards),
  * the claim-window aggregates of the ThreatState buffer (per-identity
    new-flow rate and dport span, the port-scan signal),
  * the packet's own tuple (SYN without an established flow, dport,
    proto, length, WORLD peer, fragment),

and the score maps through the policy-controlled config (``tm_cfg``) to
a verdict arm: drop (VERDICT_DROP_THREAT), redirect to a proxy port, or
a token-bucket rate limit (a score-keyed probabilistic drop once the
identity's bucket runs dry).  In shadow mode (enforce 0) no verdict
changes and no token is spent.

The state is [T+1, 6] int32, one row per identity bucket and row T the
sentinel that takes masked writes and is zeroed after.  It is updated
in place, as the CT and flow tables are.  Every scatter is a set whose
rows on one bucket write equal values, an add, or a min / max, so the
result does not depend on the order of the rows (``oracle.py`` replays
it in numpy).  All arithmetic is int32.  Nothing here reads a device
value on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..datapath.codes import VERDICT_DROP_THREAT
from ..device import DeviceLike, resolve_device
from ..hubble.aggregation import (_LS, FlowState, _probe_idx,
                                  _window_lookup, pack_flow_meta)
from ..ops.hashtab_ops import hash_mix
from .model import (CFG_BURST, CFG_DROP, CFG_ENFORCE, CFG_RATE_Q8,
                    CFG_RATELIMIT, CFG_REDIRECT, CFG_REDIRECT_PORT,
                    SCORE_MAX, WEIGHT_Q)

# ThreatState columns ([T+1, STATE_COLS] int32; row T is the sentinel)
COL_TOKENS = 0      # token-bucket fill, Q8.8 (may run negative: debt)
COL_TB_TS = 1       # last refill timestamp
COL_WIN_TS = 2      # claim-window start timestamp
COL_WIN_NEW = 3     # new flows observed in the window
COL_DPORT_MIN = 4   # smallest dport in the window (65535 on reset)
COL_DPORT_MAX = 5   # largest dport in the window
STATE_COLS = 6

# identity -> bucket salt (shared with the oracle)
BUCKET_SALT = 0x7EA7

# threat_out lane: score | band << 8 | fired << 10
ARM_NONE, ARM_RATELIMIT, ARM_REDIRECT, ARM_DROP = 0, 1, 2, 3
OUT_ARM_SHIFT = 8
OUT_FIRED_BIT = 1 << 10

# log_bucket clamps its input here: float32 is exact far beyond it
LOG_CLAMP = 1 << 22


class ThreatState(NamedTuple):
    """The mutable threat-plane buffer: [T+1, 6] int32 (token buckets
    and claim-window aggregates), owned by the engine like the CT."""

    state: torch.Tensor


def make_threat_state(buckets: int, device: DeviceLike = None
                      ) -> ThreatState:
    if buckets <= 1 or buckets & (buckets - 1):
        raise ValueError(f"threat buckets must be a power of 2: {buckets}")
    return ThreatState(state=torch.zeros(
        (buckets + 1, STATE_COLS), dtype=torch.int32,
        device=resolve_device(device)))


def log_bucket(x: torch.Tensor) -> torch.Tensor:
    """0 for x <= 0, else min(16, floor(log2 x) + 1), from the float32
    exponent: ``torch.frexp`` gives the exponent ``jnp.frexp`` gives,
    exact over the clamped range."""
    xc = torch.clamp(x.to(torch.int32), 0, LOG_CLAMP)
    _m, e = torch.frexp(xc.to(torch.float32))
    return torch.clamp(torch.where(xc > 0, e, 0), max=16).to(torch.int32)


def _set_rows(state: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              values: torch.Tensor) -> None:
    """``state[rows[i], cols] = values[i]`` for every i.  Where several
    rows name one state row, the callers give them equal values (a set
    scatter with duplicates is then the same on every backend); rows
    that must not write name the sentinel, which is zeroed after."""
    state[rows[:, None], cols[None, :]] = values


def _flow_probe(flows: FlowState, src_id, dst_id, dport, proto, *,
                flow_slots: int, flow_probe: int):
    """Probe the flow table for each packet's flow under the allowed-
    traffic key (event TRACE_TO_LXC), read-only over the state before
    this step's flow update.  Returns (found, packets, bytes,
    last_seen)."""
    meta = pack_flow_meta(dport.to(torch.int32), proto.to(torch.int32),
                          torch.zeros_like(dport))
    k0 = src_id.to(torch.int32)
    k1 = dst_id.to(torch.int32)
    q = torch.stack([k0, k1, meta], dim=1)
    idx = _probe_idx(k0, k1, meta, flow_slots, flow_probe)
    _free, found, slot = _window_lookup(flows.keys, idx, q)
    slot = torch.where(found, slot, flow_slots).long()    # sentinel
    cnt = flows.counters[slot]                            # [B, 2]
    last = flows.keys[slot, _LS]
    return (found, torch.where(found, cnt[:, 0], 0),
            torch.where(found, cnt[:, 1], 0),
            torch.where(found, last, 0))


def threat_stage(tables, threat: ThreatState, flows, verdict, *,
                 identity, dport, proto, tcp_flags, length,
                 is_fragment, established, saddr_w, daddr_w, sport,
                 flow_src, flow_dst, now, window_s: int,
                 flow_slots: int = 0, flow_probe: int = 0,
                 stripe: int = 4, exempt=None):
    """One scoring pass; ``threat.state`` is updated in place.

    ``tables`` carries the tm_* model tensors; ``flows`` is the flow
    table before this step's update, or None; per-packet args are [B]
    int32 (v6 passes its CT address folds); ``now`` a 0-d int32 tensor.
    ``flow_src`` / ``flow_dst`` are the flow-key identities of the flow
    tail, so the probe finds the entries the flow plane keeps.
    ``stripe`` stripes the window-aggregate update: each batch folds in
    the rows of one rotating contiguous 1/stripe block (block ``now %
    stripe``); the feature reads stay per packet.  ``exempt`` rows (the
    v6 ICMPv6 responder's) are scored but never overridden.

    Returns (verdict', threat, threat_out [B], thr_drop [B] bool,
    thr_redir [B] bool, rl_drop [B] bool)."""
    state = threat.state
    flat = state.view(-1)
    t = state.shape[0] - 1
    b = identity.shape[0]
    dev = identity.device
    cfg = tables.tm_cfg
    now_i = now.to(torch.int32)
    sentinel = t
    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=dev)
    cols = torch.arange(STATE_COLS, device=dev)

    # -- claim-window aggregates (per-identity buckets) -----------------
    bucket = hash_mix(identity, i32(BUCKET_SALT)) & (t - 1)
    st_n = max(1, min(stripe, b))
    width = b // st_n if b % st_n == 0 else b
    if width == b:
        def _sl(x):
            return x
    else:
        # the block is picked by a phase on the device (index_select),
        # as the flow tail's striped last-seen: no host read of ``now``
        phase = torch.remainder(now_i, st_n).long().view(1)

        def _sl(x):
            return torch.index_select(x.view(st_n, width), 0,
                                      phase).view(width)

    bucket_s = _sl(bucket)
    bl = bucket_s.long()
    win_ts = state[bl, COL_WIN_TS]
    expired = (now_i - win_ts) >= window_s
    # the window reset: every row of an expired bucket writes the same
    # (now, 0, 65535, 0), so duplicates agree
    reset = torch.where(cols[COL_WIN_TS:] == COL_WIN_TS, now_i,
                        torch.where(cols[COL_WIN_TS:] == COL_DPORT_MIN,
                                    i32(65535), i32(0)))
    _set_rows(state, torch.where(expired, bl, sentinel),
              cols[COL_WIN_TS:], reset.expand(width, STATE_COLS -
                                              COL_WIN_TS))
    # adds of 0 where the reference adds 1 into the sentinel: the same
    # state once the sentinel is zeroed
    flat.index_add_(0, bl * STATE_COLS + COL_WIN_NEW,
                    _sl(~established).to(torch.int32))
    dport_s = _sl(dport).to(torch.int32)
    # the reference's .min / .max scatters: order-free amin / amax over
    # the current values (include_self)
    flat.scatter_reduce_(0, bl * STATE_COLS + COL_DPORT_MIN, dport_s,
                         "amin", include_self=True)
    flat.scatter_reduce_(0, bl * STATE_COLS + COL_DPORT_MAX, dport_s,
                         "amax", include_self=True)
    bucket_l = bucket.long()
    post = state[bucket_l]                                # [B, 6]
    win_new = post[:, COL_WIN_NEW]
    spread = torch.clamp(post[:, COL_DPORT_MAX] - post[:, COL_DPORT_MIN],
                         min=0)

    # -- flow-table probe (per-flow history) ----------------------------
    if flows is not None and flow_slots > 0:
        found, fl_pkts, fl_bytes, fl_last = _flow_probe(
            flows, flow_src, flow_dst, dport, proto,
            flow_slots=flow_slots, flow_probe=flow_probe)
    else:
        found = torch.zeros(b, dtype=torch.bool, device=dev)
        fl_pkts = fl_bytes = fl_last = torch.zeros(b, dtype=torch.int32,
                                                   device=dev)

    # -- feature lanes (model.FEATURES order, each 0..255) --------------
    full = i32(SCORE_MAX)
    zero = i32(0)
    syn = (tcp_flags & 0x02) != 0
    is_tcp = proto == 6
    recency = torch.where(found, torch.clamp(now_i - fl_last, 0,
                                             SCORE_MAX), full)
    feats = torch.stack([
        15 * log_bucket(fl_pkts),
        15 * log_bucket(fl_bytes),
        recency,
        torch.where(syn & is_tcp & ~established, full, zero),
        torch.where(established, full, zero),
        15 * log_bucket(win_new),
        15 * log_bucket(spread),
        torch.clamp(dport >> 8, max=SCORE_MAX),
        torch.where(proto == 17, full, zero),
        15 * log_bucket(length),
        torch.where(identity == 2, full, zero),           # WORLD
        torch.where(is_fragment != 0, full, zero),
    ], dim=1)                                             # [B, F]

    # -- the quantized scorer --------------------------------------------
    # The reference's broadcast product and int32 sum, not a matmul
    # (CUDA has no int32 matmul).  torch sums int32 into int64; the cast
    # back wraps mod 2**32 as the reference's int32 sum does.
    z1 = (feats[:, :, None] * tables.tm_w1[None, :, :]).sum(dim=1) \
        .to(torch.int32) >> WEIGHT_Q
    h = torch.clamp(z1 + tables.tm_b1[None, :], 0, SCORE_MAX)
    z2 = (h * tables.tm_w2[None, :]).sum(dim=1).to(torch.int32) >> WEIGHT_Q
    score = torch.clamp(z2 + tables.tm_b2[0], 0, SCORE_MAX)

    # -- verdict arms and token bucket -----------------------------------
    # The reference runs this half under lax.cond on "any threshold
    # armed", a device predicate; a Python ``if`` on it would read the
    # host.  So the armed branch always runs: with every threshold 0 its
    # masks are all False, its only writes land in the sentinel row,
    # which is zeroed, and it returns the verdict unchanged and band 0,
    # which is what the reference's score-only branch returns.
    enforce = cfg[CFG_ENFORCE] != 0
    eligible = verdict >= 0          # never overrides an existing drop
    if exempt is not None:
        eligible = eligible & ~exempt
    c_drop, c_redir, c_rl = cfg[CFG_DROP], cfg[CFG_REDIRECT], \
        cfg[CFG_RATELIMIT]
    drop_arm = eligible & (c_drop > 0) & (score >= c_drop)
    redir_arm = eligible & ~drop_arm & (c_redir > 0) & (score >= c_redir)
    rl_arm = eligible & ~drop_arm & ~redir_arm & (c_rl > 0) & \
        (score >= c_rl)
    # token bucket (rate-limit arm, enforce only; batch-granular: rows of
    # one bucket share the pre-batch token view and their consumption
    # lands as one accumulated debit).  Columns 0-1 are untouched by the
    # window scatters, so ``post`` holds the pre-batch tokens.
    want = rl_arm & enforce
    dt = torch.clamp(now_i - post[:, COL_TB_TS], 0, 3600)
    refilled = torch.minimum(cfg[CFG_BURST] << WEIGHT_Q,
                             post[:, COL_TOKENS] + cfg[CFG_RATE_Q8] * dt)
    has_token = refilled >= (1 << WEIGHT_Q)
    # the per-packet uniform of the dry-bucket drop: a tuple + time hash
    word = ((sport & 0xFFFF) << 16) | (dport & 0xFFFF)
    prand = hash_mix(hash_mix(saddr_w, daddr_w),
                     hash_mix(word, now_i)) & 0xFF
    denom = torch.clamp(256 - c_rl, min=1)
    # the numerator is negative below the threshold: floor division, as
    # the reference's ``//`` (never C's truncation)
    p = torch.clamp(torch.div((score - c_rl + 1) * 255, denom,
                              rounding_mode="floor"), 0, 255)
    rl_drop = want & ~has_token & (prand < p)
    # the refill: rows of one bucket compute it from the same pre-batch
    # row, so they write equal values
    _set_rows(state, torch.where(want, bucket_l, sentinel),
              cols[COL_TOKENS:COL_WIN_TS],
              torch.stack([refilled, now_i.expand(b)], dim=1))
    consumed = want & has_token
    flat.index_add_(0, bucket_l * STATE_COLS + COL_TOKENS,
                    consumed.to(torch.int32) * -(1 << WEIGHT_Q))
    state[sentinel] = 0
    # the verdict override (enforce only; shadow leaves it as it was)
    thr_drop = (drop_arm & enforce) | rl_drop
    thr_redir = redir_arm & enforce & (verdict == 0)
    verdict = torch.where(
        thr_drop, i32(VERDICT_DROP_THREAT),
        torch.where(thr_redir, cfg[CFG_REDIRECT_PORT], verdict))
    band = torch.where(
        drop_arm, i32(ARM_DROP),
        torch.where(redir_arm, i32(ARM_REDIRECT),
                    torch.where(rl_arm, i32(ARM_RATELIMIT),
                                i32(ARM_NONE))))
    fired = thr_drop | thr_redir
    threat_out = score | (band << OUT_ARM_SHIFT) | \
        torch.where(fired, i32(OUT_FIRED_BIT), zero)
    return verdict, threat, threat_out, thr_drop, thr_redir, rl_drop


def unpack_threat_out(out) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The packed [B] threat_out lane -> (score, band, fired) numpy
    arrays, on the host."""
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    arr = np.asarray(out, np.int32)
    return arr & 0xFF, (arr >> OUT_ARM_SHIFT) & 0x3, \
        (arr & OUT_FIRED_BIT) != 0
