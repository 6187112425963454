"""Sequence-parallel DFA evaluation: composition over bytes.

Port of ``cilium_tpu/ops/dfa_parallel.py``.
A DFA step on byte ``c`` is a function f_c: state -> state, the vector
``table[:, c]`` of shape [S]; matching a payload is the composition
f_{c_L} o ... o f_{c_1}.  Composition is associative and the states are
exact integers, so any grouping gives the same bits:

- ``dfa_parallel_scan`` composes the L functions of a row in a tree of
  log2(L) rounds (the reference's ``lax.associative_scan``, of which only
  the last prefix is read);
- ``dfa_scan_compose`` composes groups of k functions in k-1 parallel
  rounds, then walks the L/k group functions.

- ``dfa_scan_sharded`` splits the payload axis over a mesh axis's
  devices: each composes its chunk, then log2(N) hops of ``.to()``
  copies (the reference's ``lax.ppermute``) build the prefix of chunk
  compositions, and the last device's total is applied to the states.

Padding bytes (negative) compose as the identity function, so ragged
rows need no special casing.  All three materialise [B, L, S]
functions (the sharded scan [B, L/N, S] on each device).
"""

from __future__ import annotations

import torch

from .dfa_ops import overlong_rows, start_states


def transition_functions(table: torch.Tensor,
                         data: torch.Tensor) -> torch.Tensor:
    """Bytes -> per-position transition vectors.

    table: [S, 256]; data: [..., L] int32 bytes (negative == padding).
    Returns [..., L, S] in the table's dtype, where out[..., i, s] is the
    next state from s on byte i (the identity for padding)."""
    s = table.shape[0]
    ident = torch.arange(s, dtype=table.dtype, device=table.device)
    valid = data >= 0
    safe = torch.where(valid, data, 0).to(torch.int64)
    f = table.t()[safe]
    return torch.where(valid[..., None], f, ident)


def compose(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(g o f)[..., s] = g[..., f[..., s]]: apply f first, then g."""
    return torch.gather(g, -1, f.to(torch.int64))


def _compose_all(f: torch.Tensor) -> torch.Tensor:
    """[B, L, S] functions -> [B, S] composition f_{L-1} o ... o f_0, in
    ceil(log2 L) rounds of pairwise composition."""
    while f.shape[1] > 1:
        if f.shape[1] % 2:
            ident = torch.arange(f.shape[2], dtype=f.dtype, device=f.device)
            f = torch.cat([f, ident.expand(f.shape[0], 1, f.shape[2])],
                          dim=1)
        f = compose(f[:, 1::2], f[:, 0::2])    # later after earlier
    return f[:, 0]


def dfa_parallel_scan(table: torch.Tensor, states: torch.Tensor,
                      data: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel equivalent of ``dfa_ops.dfa_scan``.

    table: [S, 256]; states: [B, R]; data: [B, L].  Returns the final
    states [B, R] in the table's dtype."""
    total = _compose_all(transition_functions(table, data))   # [B, S]
    return torch.gather(total, -1, states.to(torch.int64))


def dfa_match_parallel(table: torch.Tensor, accept: torch.Tensor,
                       starts: torch.Tensor,
                       data: torch.Tensor) -> torch.Tensor:
    """Anchored match of every regex against every row (parallel
    composition); the ``dfa_ops.dfa_match`` contract."""
    final = dfa_parallel_scan(table, start_states(starts, data.shape[0]), data)
    ok = accept[final.to(torch.int64)]
    return ok & ~overlong_rows(data)[:, None]


def dfa_scan_compose(table: torch.Tensor, states: torch.Tensor,
                     data: torch.Tensor, k: int) -> torch.Tensor:
    """Serial-equivalent walk in ceil(L/k) dependent steps.

    The per-byte functions ([B, L, S]) are composed in groups of ``k``
    (k-1 rounds with no dependency between groups), then the carry walks
    the L/k group functions.  table: [S, 256]; states: [B, R] int32;
    data: [B, L].  Returns the final states [B, R] in ``states``'s
    dtype."""
    b, l = data.shape
    pad = (-l) % k
    if pad:
        data = torch.cat([data, data.new_full((b, pad), -1)], dim=1)
    f = transition_functions(table, data)
    f = f.reshape(b, -1, k, f.shape[-1])
    g = f[:, :, 0]
    for j in range(1, k):                          # position j after
        g = compose(f[:, :, j], g)                 # the earlier ones
    st = states
    for gcol in g.unbind(1):                       # gcol: [B, S]
        st = torch.gather(gcol, -1, st.to(torch.int64)).to(states.dtype)
    return st


def dfa_match_compose(table: torch.Tensor, accept: torch.Tensor,
                      starts: torch.Tensor, data: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Anchored match via the k-stride composition walk (the
    ``dfa_match`` contract, the -2 overlong poison included)."""
    final = dfa_scan_compose(table, start_states(starts, data.shape[0]), data,
                             k)
    ok = accept[final.to(torch.int64)]
    return ok & ~overlong_rows(data)[:, None]


def dfa_scan_sharded(table: torch.Tensor, states: torch.Tensor,
                     data: torch.Tensor, mesh, seq_axis: str) -> torch.Tensor:
    """Final DFA states with the payload axis split over the devices of
    ``seq_axis`` of ``mesh`` (``parallel/mesh.Mesh``; the axis's devices
    are the mesh's first row or column along it, and may repeat).

    Device i composes its [L/N] chunk into one transition vector
    (``_compose_all``); a Hillis-Steele inclusive prefix over the chunks
    then takes log2(N) hops, each a ``.to()`` copy of the partial
    compositions to the devices ``hop`` to their right (the reference's
    ``lax.ppermute``), after which device i holds f_i o ... o f_0.  The
    last device's total is applied to ``states``.

    table: [S, 256]; states: [B, R]; data: [B, L] with L divisible by
    the axis size.  Returns the final states [B, R] in the table's dtype
    on ``states``'s device."""
    axis = mesh.axis_names.index(seq_axis)
    devs = list(mesh.devices[:, 0] if axis == 0 else mesh.devices[0, :])
    n = len(devs)
    b, l = data.shape
    if l % n:
        raise ValueError(f"payload length {l} not divisible by the "
                         f"{seq_axis} axis size {n}")
    step = l // n
    acc = [_compose_all(transition_functions(
        table.to(dev), data[:, i * step:(i + 1) * step].to(dev)))
        for i, dev in enumerate(devs)]                   # [B, S] each
    hop = 1
    while hop < n:
        # devices with nothing ``hop`` to their left keep their value
        # (the reference composes them with the identity)
        acc = [a if i < hop else compose(a, acc[i - hop].to(devs[i]))
               for i, a in enumerate(acc)]               # earlier first
        hop <<= 1
    total = acc[-1]
    return torch.gather(total, -1, states.to(total.device, torch.int64)
                        ).to(states.device)
