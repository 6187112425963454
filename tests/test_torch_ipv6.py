"""The v6 building blocks: the JAX package's vs the port's, on the CPU.

``compile_lpm6`` tables and ``lpm6_lookup`` results, the v6 prefilter's
``drop_mask6``, ``compile_lb6`` tables, ``lb6_step`` DNAT and
``lb6_rev_nat`` must equal the reference's bit for bit (tolerance 0).
The inputs put the sign bit in address words (``fd00::/8``, ``ff..``),
include an empty table, a backend-less service compiled last (whose
backend index lies one past the arrays: JAX clamps it, the port clips
it) and ports >= 32768; the backend selection is held against the
reference's expression at h = -2**31.
"""

import ipaddress

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.compiler import lpm as ref_lpm
from cilium_tpu.datapath import lb as ref_lb
from cilium_tpu.datapath import prefilter as ref_pf
from cilium_tpu.ops import lpm_ops as ref_lpm_ops

from cilium_tpu_torch.compiler import lpm
from cilium_tpu_torch.datapath import lb, prefilter
from cilium_tpu_torch.ops import lpm_ops


def _prefixes6(rng, n):
    """``n`` random v6 prefixes of lengths 8..128, under fd00::/8, ff::
    and 2001:db8::, nested so that longer prefixes lie inside shorter
    ones."""
    out = {}
    bases = [0xFD << 120, 0xFF02 << 112, 0x20010DB8 << 96]
    for i in range(n):
        base = bases[i % 3] | int(rng.integers(0, 2 ** 63)) << 32 | \
            int(rng.integers(0, 2 ** 32))
        plen = int(rng.choice([8, 48, 64, 96, 112, 120, 127, 128]))
        net = ipaddress.IPv6Network((base, plen), strict=False)
        out[str(net)] = int(rng.integers(256, 2 ** 31))
        if plen > 16:  # a parent prefix of the same address
            parent = ipaddress.IPv6Network((base, plen - 16), strict=False)
            out[str(parent)] = int(rng.integers(256, 2 ** 31))
    return out


def _addrs_near(rng, prefixes, n):
    """[n, 4] int32 words: addresses inside the prefixes (a random
    host part) and uniform ones."""
    nets = [ipaddress.IPv6Network(c) for c in prefixes]
    rows = []
    for _ in range(n):
        if rng.random() < 0.7 and nets:
            net = nets[int(rng.integers(0, len(nets)))]
            host = int(rng.integers(0, 2 ** 63)) % max(1, net.num_addresses)
            v = int(net.network_address) + host
        else:
            v = int(rng.integers(0, 2 ** 63)) << 65 | \
                int(rng.integers(0, 2 ** 63))
        rows.append(lpm.ipv6_to_words(str(ipaddress.IPv6Address(v))))
    return np.asarray(rows, np.uint32).view(np.int32)


def _assert_lpm6_equal(ref, port):
    assert (ref.max_probe, ref.slots) == (port.max_probe, port.slots)
    for f in ("prefix_lens", "masks", "k0", "k1", "k2", "k3", "kb",
              "value"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(port, f), f)


@pytest.mark.parametrize("n", [0, 1, 40, 600])
def test_compile_lpm6_and_lookup_match_reference(n):
    rng = np.random.default_rng(n)
    prefixes = _prefixes6(rng, n)
    ref, port = ref_lpm.compile_lpm6(prefixes), lpm.compile_lpm6(prefixes)
    _assert_lpm6_equal(ref, port)
    assert port.entry_count() == len(prefixes)
    addrs = _addrs_near(rng, prefixes, 512)
    assert (addrs[:, 0] < 0).any()
    tables = [port.masks, port.k0, port.k1, port.k2, port.k3, port.kb,
              port.value, port.prefix_lens]
    want = ref_lpm_ops.lpm6_lookup(*map(jnp.asarray, tables),
                                   jnp.asarray(addrs), ref.max_probe)
    got = lpm_ops.lpm6_lookup(*map(torch.as_tensor, tables),
                              torch.as_tensor(addrs), port.max_probe)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # and the scalar oracle on a sample
    for i in range(0, 512, 37):
        assert int(got[1][i]) == lpm.oracle_lpm6(prefixes, addrs[i])
    if n:
        assert 0 < int(got[0].sum()) < 512


def test_ipv6_words_helpers_match_reference():
    ips = ["::", "fd00::10.1.2.3", "ff02::1:ff00:1", "2001:db8::ffff:1",
           "ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff"]
    np.testing.assert_array_equal(ref_lpm.ipv6_batch_words(ips),
                                  lpm.ipv6_batch_words(ips))
    for plen in (0, 1, 31, 32, 33, 64, 127, 128):
        assert ref_lpm._mask128_words(plen) == lpm._mask128_words(plen)
    with pytest.raises(ValueError, match="IPv6-only"):
        lpm.compile_lpm6({"10.0.0.0/8": 1})


def test_drop_mask6_matches_reference():
    """v6 deny CIDRs of both map types; drop_mask6 and drop_mask equal
    the reference's before and after a delete."""
    rng = np.random.default_rng(2)
    ref, port = ref_pf.PreFilter(), prefilter.PreFilter()
    v6 = list(_prefixes6(rng, 30))
    for pf, types in ((ref, ref_pf.PrefilterType),
                      (port, prefilter.PrefilterType)):
        pf.insert(v6[:20])
        pf.insert(v6[20:], types.PREFIX_FIX_V6)
        pf.insert(["10.0.0.0/8"])
    assert port.dump() == ref.dump()
    addrs6 = _addrs_near(rng, v6, 400)
    v4 = np.asarray(rng.integers(0, 2 ** 32, 64), np.uint32).view(np.int32)

    def check():
        np.testing.assert_array_equal(
            np.asarray(ref.drop_mask6(jnp.asarray(addrs6))),
            port.drop_mask6(torch.as_tensor(addrs6)).numpy())
        np.testing.assert_array_equal(
            np.asarray(ref.drop_mask(jnp.asarray(v4))),
            port.drop_mask(torch.as_tensor(v4)).numpy())
    check()
    assert port.drop_mask6(torch.as_tensor(addrs6)).any()
    for pf in (ref, port):
        pf.delete(v6[:10])
    check()
    assert port.dump() == ref.dump()
    empty = prefilter.PreFilter()
    assert not empty.drop_mask6(torch.as_tensor(addrs6)).any()


def _services6(rng, n, zero_last=True):
    """``n`` v6 services under fd00:: with 1..3 backends (none for the
    last), ports up to 65535."""
    def words():
        return (0xFD000000, int(rng.integers(0, 2 ** 32)), 0,
                int(rng.integers(0, 2 ** 32)))
    out = []
    for i in range(n):
        k = 0 if zero_last and i == n - 1 else int(rng.integers(1, 4))
        out.append(lb.Service6(
            vip=words(), port=int(rng.choice([80, 443, 40000, 65535])),
            proto=int(rng.choice([6, 17])),
            backends=[lb.Backend6(addr=words(),
                                  port=int(rng.integers(1, 65536)))
                      for _ in range(k)]))
    return out


def _twin6(services):
    return [ref_lb.Service6(vip=s.vip, port=s.port, proto=s.proto,
                            backends=[ref_lb.Backend6(b.addr, b.port)
                                      for b in s.backends],
                            rev_nat_index=s.rev_nat_index)
            for s in services]


@pytest.mark.parametrize("n", [1, 7, 60])
def test_lb6_matches_reference(n):
    """compile_lb6 tables, lb6_step on VIP traffic (the backend-less
    last service included) and on other traffic, and lb6_rev_nat with
    in-range, zero and out-of-range indices."""
    rng = np.random.default_rng(10 + n)
    services = _services6(rng, n)
    services[0].rev_nat_index = 5   # a preset index is kept
    ref_c = ref_lb.compile_lb6(_twin6(services))
    port_c = lb.compile_lb6(services, device="cpu")
    assert (ref_c.max_probe, ref_c.num_services, ref_c.num_backends) == \
        (port_c.max_probe, port_c.num_services, port_c.num_backends)
    for f in ref_c.tables._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref_c.tables, f)),
                                      getattr(port_c.tables, f).numpy(), f)
    assert services[0].rev_nat_index == 5

    b = 600
    pick = rng.integers(0, n, b)
    to_vip = rng.random(b) < 0.8
    vips = np.asarray([services[i].vip for i in pick], np.uint32)
    other = np.asarray(rng.integers(0, 2 ** 32, (b, 4)), np.uint32)
    daddr = np.where(to_vip[:, None], vips, other).view(np.int32)
    dport = np.where(to_vip, [services[i].port for i in pick],
                     rng.integers(1, 65536, b)).astype(np.int32)
    proto = np.where(to_vip, [services[i].proto for i in pick],
                     6).astype(np.int32)
    saddr = np.asarray(rng.integers(0, 2 ** 32, (b, 4)),
                       np.uint32).view(np.int32)
    sport = rng.integers(1, 65536, b).astype(np.int32)
    args = (daddr, dport, proto, saddr, sport)
    want = ref_lb.lb6_step(ref_c.tables, *map(jnp.asarray, args),
                           max_probe=ref_c.max_probe)
    got = lb.lb6_step(port_c.tables, *map(torch.as_tensor, args),
                      max_probe=port_c.max_probe)
    for name, w, g in zip(("daddr", "dport", "rev_nat", "is_svc"), want,
                          got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), name)
    hit_last = to_vip & (pick == n - 1)
    assert hit_last.any() and not got[3].numpy()[hit_last].any()
    if n > 1:
        assert got[3].any()

    n_rev = port_c.tables.rev_port.shape[0]
    idx = rng.integers(-2, n_rev + 3, b).astype(np.int32)
    want = ref_lb.lb6_rev_nat(ref_c.tables, jnp.asarray(saddr),
                              jnp.asarray(sport), jnp.asarray(idx))
    got = lb.lb6_rev_nat(port_c.tables, torch.as_tensor(saddr),
                         torch.as_tensor(sport), torch.as_tensor(idx))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_lb6_backend_selection_at_int32_edges():
    """``select_slave`` against the reference's lb6 expression
    ``where(count > 0, abs(h) % max(count, 1), 0)`` at h = -2**31 and
    the other edges of int32."""
    h = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 1, 2 ** 31 - 1] * 4,
                 np.int32)
    count = np.repeat(np.array([0, 1, 3, 7], np.int32), 6)
    hj, cj = jnp.asarray(h), jnp.asarray(count)
    want = jnp.where(cj > 0, jnp.abs(hj) % jnp.maximum(cj, 1),
                     jnp.int32(0))
    got = lb.select_slave(torch.as_tensor(h), torch.as_tensor(count))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
