"""The port's NAT checksum and NAT46 functions against the JAX package.

``cilium_tpu_torch/datapath/{csum,nat46}.py`` and their references run
on the same seeded int32 rows (4,096 a case), with the edges the
reference's semantics hinge on: checksums 0x0000 and 0xFFFF, the UDP
no-checksum rule, addresses and ports with the sign bit of their int32
lane set.  Tolerance 0 throughout: every output is an int32 word or a
boolean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import csum as ref_csum
from cilium_tpu.datapath import nat46 as ref_nat46

from cilium_tpu_torch.datapath import csum, nat46

ROWS = 4096


def _u32(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def _u16(rng, n):
    return rng.integers(0, 1 << 16, n).astype(np.int32)


def _edges(a, edge_values, rng):
    """Put each of ``edge_values`` on a tenth of the rows."""
    a = a.copy()
    for v in edge_values:
        a[rng.random(len(a)) < 0.1] = v
    return a


def _both(fn_ref, fn_port, *arrays, **kw):
    want = np.asarray(fn_ref(*[jnp.asarray(a) for a in arrays], **kw))
    got = fn_port(*[torch.as_tensor(a) for a in arrays], **kw).numpy()
    return want, got


def _case(seed):
    rng = np.random.default_rng(seed)
    c = _edges(_u16(rng, ROWS), (0, 0xFFFF), rng)
    old_a = _edges(_u32(rng, ROWS), (-1, -(1 << 31), 0), rng)
    new_a = _edges(_u32(rng, ROWS), (-1, -(1 << 31), 0), rng)
    old_p = _edges(_u16(rng, ROWS), (0, 0xFFFF, 0x8000), rng)
    new_p = _edges(_u16(rng, ROWS), (0, 0xFFFF, 0x8000), rng)
    return c, old_a, new_a, old_p, new_p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csum_updates_match_reference(seed):
    c, old_a, new_a, old_p, new_p = _case(seed)
    want, got = _both(ref_csum.csum_update_u16, csum.csum_update_u16,
                      c, old_p, new_p)
    assert got.dtype == np.int32 and np.array_equal(want, got)
    want, got = _both(ref_csum.csum_update_u32, csum.csum_update_u32,
                      c, old_a, new_a)
    assert got.dtype == np.int32 and np.array_equal(want, got)


@pytest.mark.parametrize("udp", [False, True])
def test_nat_csum_fix_matches_reference(udp):
    c, old_a, new_a, old_p, new_p = _case(10 + udp)
    want, got = _both(ref_csum.nat_csum_fix, csum.nat_csum_fix,
                      c, old_a, new_a, old_p, new_p, udp=udp)
    assert np.array_equal(want, got)
    if udp:
        # the no-checksum rule: an incoming 0 stays 0; a computed 0 is
        # sent as 0xFFFF
        assert (got[c == 0] == 0).all()
        assert not (got[c != 0] == 0).any()
        assert (c == 0).any() and (got == 0xFFFF).any()


def test_checksum16_matches_reference_and_the_incremental_fix():
    """A pseudo-header-like row of 10 u16 words: the fix after an
    address and port rewrite equals ``checksum16`` recomputed from
    scratch, on every row, and both equal the reference's."""
    rng = np.random.default_rng(7)
    words = _edges(_u16(rng, ROWS * 10), (0, 0xFFFF), rng).reshape(ROWS, 10)
    want, base = _both(ref_csum.checksum16, csum.checksum16, words)
    assert np.array_equal(want, base)
    old_a = ((words[:, 0].astype(np.uint32) << 16) |
             words[:, 1].astype(np.uint32)).view(np.int32)
    old_p = words[:, 2].copy()
    new_a = _edges(_u32(rng, ROWS), (-1, -(1 << 31)), rng)
    new_p = _edges(_u16(rng, ROWS), (0, 0xFFFF), rng)
    fixed = csum.nat_csum_fix(*[torch.as_tensor(a) for a in (
        base, old_a, new_a, old_p, new_p)]).numpy()
    new_words = words.copy()
    nu = new_a.view(np.uint32)
    new_words[:, 0] = (nu >> 16).astype(np.int32)
    new_words[:, 1] = (nu & 0xFFFF).astype(np.int32)
    new_words[:, 2] = new_p
    scratch = csum.checksum16(torch.as_tensor(new_words)).numpy()
    assert np.array_equal(fixed, scratch)
    want_fix = np.asarray(ref_csum.nat_csum_fix(*[jnp.asarray(a) for a in (
        base, old_a, new_a, old_p, new_p)]))
    assert np.array_equal(want_fix, fixed)


@pytest.mark.parametrize("prefix", [nat46.WK_PREFIX,
                                    (0x20010DB8, 0x1234, 0xFFFFFFFF, 0)])
def test_nat46_and_nat64_match_reference(prefix):
    rng = np.random.default_rng(21)
    v4 = _edges(_u32(rng, ROWS), (-1, -(1 << 31), 0), rng)
    want, got = _both(ref_nat46.nat46_translate, nat46.nat46_translate,
                      v4, prefix=prefix)
    assert got.shape == (ROWS, 4) and got.dtype == np.int32
    assert np.array_equal(want, got)
    # half the rows under the prefix, half under another /96
    v6 = got.copy()
    foreign = rng.random(ROWS) < 0.5
    v6[foreign, int(rng.integers(0, 3))] ^= 0x10
    (wv4, wok) = ref_nat46.nat64_translate(jnp.asarray(v6), prefix=prefix)
    gv4, gok = nat46.nat64_translate(torch.as_tensor(v6), prefix=prefix)
    assert np.array_equal(np.asarray(wv4), gv4.numpy())
    assert np.array_equal(np.asarray(wok), gok.numpy())
    assert gok.numpy().tolist() == (~foreign).tolist()
    rt = nat46.nat46_roundtrip_ok(torch.as_tensor(v4), prefix).numpy()
    assert rt.all() and np.array_equal(
        np.asarray(ref_nat46.nat46_roundtrip_ok(jnp.asarray(v4), prefix)),
        rt)
