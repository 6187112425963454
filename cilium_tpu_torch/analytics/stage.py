"""The fused device-resident traffic-analytics stage, in torch.

Port of ``cilium_tpu/analytics/stage.py``.  It runs inside both family
steps behind the ``with_analytics`` flag (``datapath/pipeline.py``),
after the final verdict: every batch folds its traffic into three
count-min sketches (bytes, packets and drops keyed by src identity, by
(identity, dport) and by dst /24 prefix), per-keyspace candidate key
tables the host decoder (``decode.py``) queries, and per-identity
distinct-flow cardinality registers (integer hash-max lanes).

The whole plane is ONE [R, W] int32 buffer, updated in place: one
``index_add_`` per keyspace for the sketches and one combined
``scatter_reduce_`` (amax) for the key tables and registers.  ``stripe``
samples the rows folded in (one rotating contiguous 1/stripe block a
batch, phase ``now % stripe``).

Epochs: the buffer holds two complete copies of every section (A/B) and
a control row whose cell 0 names the epoch being written.  The stage
reads that cell on the device, so an epoch swap is a write of one cell
and a zeroed section (``Datapath.swap_analytics_epoch``), and the host
decodes the other, quiesced section.  Adds commute and the max scatters
are order-free, so ``oracle.py`` replays the buffer bit for bit.
Nothing here reads a device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.hashtab_ops import hash_mix

# keyspaces (one count-min sketch + one candidate key table each)
KS_IDENTITY = 0     # talkers: src security identity
KS_PORT = 1         # scanners: (identity, dport) pairs
KS_PREFIX = 2       # dst /24 prefix heavy hitters
N_KEYSPACES = 3

# metrics tracked per sketch (the D hash rows repeat per metric)
MET_BYTES = 0
MET_PACKETS = 1
MET_DROPS = 2
N_METRICS = 3

# hash salts (shared with the oracle and the decoder)
SKETCH_SALT = 0x53C7
KEYTAB_SALT = 0x5EED
REG_SALT = 0x0CA8
LANE_SALT = 0x1A7E

# the epoch-selector cell: state[ctrl_row(...), CTRL_COL]
CTRL_COL = 0


def sketch_salt(k: int, d: int) -> int:
    """Per-(keyspace, hash-row) sketch column salt."""
    return (SKETCH_SALT + 0x101 * (k * 31 + d)) & 0x7FFFFFFF


def keytab_salt(k: int) -> int:
    """Per-keyspace candidate-key-table column salt."""
    return (KEYTAB_SALT + 0x101 * k) & 0x7FFFFFFF


def lane_salt(lane: int) -> int:
    """Per-lane cardinality-register value salt."""
    return (LANE_SALT + 0x101 * lane) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# Buffer geometry: one epoch section stacks, top to bottom,
#   [N_KEYSPACES * N_METRICS * depth]  count-min sketch rows
#   [N_KEYSPACES]                      candidate key tables (1 row each)
#   [lanes]                            cardinality hash-max registers
# and the full buffer is two epoch sections + the control row.
# ---------------------------------------------------------------------------

def epoch_rows(depth: int, lanes: int) -> int:
    return N_KEYSPACES * N_METRICS * depth + N_KEYSPACES + lanes


def sketch_row(k: int, m: int, d: int, depth: int) -> int:
    """Row (within an epoch section) of sketch hash-row ``d`` of metric
    ``m`` in keyspace ``k``."""
    return (k * N_METRICS + m) * depth + d


def keytab_row(k: int, depth: int) -> int:
    return N_KEYSPACES * N_METRICS * depth + k


def reg_row(lane: int, depth: int) -> int:
    return N_KEYSPACES * N_METRICS * depth + N_KEYSPACES + lane


def ctrl_row(depth: int, lanes: int) -> int:
    return 2 * epoch_rows(depth, lanes)


def total_rows(depth: int, lanes: int) -> int:
    return 2 * epoch_rows(depth, lanes) + 1


class AnalyticsState(NamedTuple):
    """The mutable analytics buffer: [R, W] int32 (both epoch sections
    and the control row), owned by the engine."""

    state: torch.Tensor


def make_analytics_state(width: int, depth: int = 2, lanes: int = 4,
                         device: DeviceLike = None) -> AnalyticsState:
    if width <= 1 or width & (width - 1):
        raise ValueError(f"analytics width must be a power of 2: {width}")
    return AnalyticsState(state=torch.zeros(
        (total_rows(depth, lanes), width), dtype=torch.int32,
        device=resolve_device(device)))


def flow_hash_keys(identity, dport, daddr_key):
    """The three non-negative int32 sketch / key-table keys of a row:
    src identity, the packed (identity, dport) pair and the dst /24
    prefix of the (DNAT'd) destination word."""
    k_id = identity & 0x7FFFFFFF
    k_port = ((identity & 0x7FFF) << 16) | (dport & 0xFFFF)
    k_pref = (daddr_key >> 8) & 0x00FFFFFF
    return k_id, k_port, k_pref


def analytics_stage(analytics: AnalyticsState, *, identity, dport,
                    proto, sport, length, verdict, saddr_key,
                    daddr_key, now, depth: int, lanes: int,
                    stripe: int = 16) -> AnalyticsState:
    """One analytics pass over [B] int32 lanes, in place.  ``saddr_key``
    / ``daddr_key`` are the address words of the flow hash (v4 passes
    the words, v6 its CT folds); ``verdict`` is the final one, so the
    drops metric counts every drop arm; ``now`` a 0-d int32 tensor."""
    state = analytics.state
    flat = state.view(-1)
    width = state.shape[1]
    cmask = width - 1
    er = epoch_rows(depth, lanes)
    b = identity.shape[0]
    dev = identity.device
    now_i = now.to(torch.int32)
    i32 = lambda x: torch.full((), x, dtype=torch.int32,  # noqa: E731
                               device=dev)

    # the write epoch, read on the device from the control cell: a swap
    # is a write of that cell, never a rebuild
    base = state[ctrl_row(depth, lanes), CTRL_COL].long() * er

    st_n = max(1, min(stripe, b))
    w = b // st_n if b % st_n == 0 else b
    if w == b:
        def _sl(x):
            return x
    else:
        # the striped block by a device phase (index_select): no host
        # read of ``now``
        phase = torch.remainder(now_i, st_n).long().view(1)

        def _sl(x):
            return torch.index_select(x.view(st_n, w), 0, phase).view(w)

    ids = _sl(identity)
    dps = _sl(dport)
    prs = _sl(proto)
    sps = _sl(sport)
    lns = _sl(length)
    vds = _sl(verdict)
    sas = _sl(saddr_key)
    das = _sl(daddr_key)

    keys = flow_hash_keys(ids, dps, das)

    # -- count-min sketches: one index_add_ per keyspace ----------------
    # metric values [w, M]: bytes, packets, drops (0 for allowed rows: a
    # value-0 add changes nothing)
    one = torch.ones_like(lns)
    vals = torch.stack([lns, one, (vds < 0).to(torch.int32)], dim=1)
    for k in range(N_KEYSPACES):
        cols = torch.stack([hash_mix(keys[k], i32(sketch_salt(k, d)))
                            & cmask for d in range(depth)], dim=1)
        # sketch_row(k, m, d) = (k * M + m) * D + d: an arange, made on
        # the device (no host-to-device copy inside the step)
        rows = sketch_row(k, 0, 0, depth) + torch.arange(
            N_METRICS * depth, device=dev).view(N_METRICS, depth)
        cell = (base + rows)[None] * width + cols[:, None, :].long()
        flat.index_add_(0, cell.reshape(-1),
                        vals[:, :, None].expand(w, N_METRICS, depth)
                        .reshape(-1))

    # -- candidate key tables + cardinality registers: one amax ---------
    # Key tables keep the largest key hashing into each column; registers
    # keep the per-lane max of the flow-tuple hash under the identity's
    # column, so duplicate packets of a flow change nothing.
    word = ((sps & 0xFFFF) << 16) | (dps & 0xFFFF)
    fh = hash_mix(hash_mix(sas, das), hash_mix(word, prs))
    reg_col = hash_mix(ids, i32(REG_SALT)) & cmask
    mx_cells, mx_vals = [], []
    for k in range(N_KEYSPACES):
        col = hash_mix(keys[k], i32(keytab_salt(k))) & cmask
        mx_cells.append((base + keytab_row(k, depth)) * width + col.long())
        mx_vals.append(keys[k])
    for lane in range(lanes):
        mx_cells.append((base + reg_row(lane, depth)) * width +
                        reg_col.long())
        mx_vals.append(hash_mix(fh, i32(lane_salt(lane))) & 0x7FFFFFFF)
    flat.scatter_reduce_(0, torch.cat(mx_cells), torch.cat(mx_vals),
                         "amax", include_self=True)
    return analytics
