"""Service LB and prefilter: the JAX package's vs the port's, on the CPU.

``compile_lb`` tables, ``lb_step`` DNAT and ``lb_rev_nat`` must equal the
reference's bit for bit (tolerance 0), including a backend-less service
compiled last, whose backend index lies one past the backend arrays
(JAX clamps it; the port clips it).  The backend selection helper is
held against ``jnp.abs(h) % n`` at the edges of int32.  ``PreFilter``
insert / delete / dump / drop_mask / drop_mask6 match the reference's.
"""

import functools
import ipaddress

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import lb as ref_lb
from cilium_tpu.datapath import prefilter as ref_pf

from cilium_tpu_torch.datapath import lb, prefilter


def _services(rng, n, backends=3, zero_last=True):
    """``n`` random port services of 1..``backends`` backends; the last
    has none when ``zero_last``."""
    out = []
    for i in range(n):
        k = int(rng.integers(1, backends + 1))
        if zero_last and i == n - 1:
            k = 0
        out.append(lb.Service(
            vip=int(rng.integers(0, 2 ** 32)),
            port=int(rng.choice([80, 443, 8080, 40000, 65535])),
            proto=int(rng.choice([6, 17])),
            backends=[lb.Backend(addr=int(rng.integers(0, 2 ** 32)),
                                 port=int(rng.integers(1, 65536)))
                      for _ in range(k)]))
    return out


def _twin(services):
    """The same services as reference objects."""
    return [ref_lb.Service(vip=s.vip, port=s.port, proto=s.proto,
                           backends=[ref_lb.Backend(b.addr, b.port)
                                     for b in s.backends],
                           rev_nat_index=s.rev_nat_index)
            for s in services]


def _assert_tables_equal(ref, port):
    assert ref.max_probe == port.max_probe
    assert ref.num_services == port.num_services
    assert ref.num_backends == port.num_backends
    for f in ref.tables._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref.tables, f)),
                                      getattr(port.tables, f).numpy(), f)


# (name, services, preassigned rev-NAT indices): no service at all; one
# backend-less service alone; many services with the backend-less one
# last; indices given with gaps (a deleted service's row stays zero).
CASES = [("empty", 0, None), ("only-backendless", 1, None),
         ("backendless-last", 60, None), ("index-gaps", 12, [3, 0, 9, 0])]


@pytest.mark.parametrize("name,n,indices", CASES, ids=[c[0] for c in CASES])
def test_compile_lb_and_steps_match_reference(name, n, indices):
    rng = np.random.default_rng(n)
    services = _services(rng, n)
    for svc, idx in zip(services, indices or []):
        svc.rev_nat_index = idx
    ref_services = _twin(services)
    ref_c = ref_lb.compile_lb(ref_services)
    port_c = lb.compile_lb(services, device="cpu")
    _assert_tables_equal(ref_c, port_c)
    assert [s.rev_nat_index for s in services] == \
        [s.rev_nat_index for s in ref_services]

    b = 4096
    vips = np.array([s.vip for s in services] or [0], np.uint32)
    ports = np.array([s.port for s in services] or [80], np.int32)
    protos = np.array([s.proto for s in services] or [6], np.int32)
    pick = rng.integers(0, vips.shape[0], b)
    hit = rng.random(b) < 0.7
    cols = dict(
        daddr=np.where(hit, vips[pick], rng.integers(0, 2 ** 32, b)
                       .astype(np.uint32)).view(np.int32),
        dport=np.where(hit, ports[pick], rng.integers(1, 65536, b))
        .astype(np.int32),
        proto=np.where(hit, protos[pick], 6).astype(np.int32),
        saddr=rng.integers(0, 2 ** 32, b).astype(np.uint32).view(np.int32),
        sport=rng.integers(0, 65536, b).astype(np.int32))
    order = ("daddr", "dport", "proto", "saddr", "sport")
    ref_out = jax.jit(functools.partial(
        ref_lb.lb_step, max_probe=ref_c.max_probe))(
            ref_c.tables, *(jnp.asarray(cols[k]) for k in order))
    port_out = lb.lb_step(port_c.tables,
                          *(torch.as_tensor(cols[k]) for k in order),
                          max_probe=port_c.max_probe)
    for f, r, t in zip(("daddr", "dport", "rev_nat", "is_service"),
                       ref_out, port_out):
        np.testing.assert_array_equal(np.asarray(r), t.numpy(), f)
    if port_c.num_backends:
        assert bool(port_out[3].any())

    # rev-NAT: every index of the table, 0, and indices past its end
    nr = port_c.tables.rev_vip.shape[0]
    idx = rng.integers(-2, nr + 3, b).astype(np.int32)
    ref_rn = ref_lb.lb_rev_nat(ref_c.tables, jnp.asarray(cols["saddr"]),
                               jnp.asarray(cols["sport"]), jnp.asarray(idx))
    port_rn = lb.lb_rev_nat(port_c.tables, torch.as_tensor(cols["saddr"]),
                            torch.as_tensor(cols["sport"]),
                            torch.as_tensor(idx))
    for r, t in zip(ref_rn, port_rn):
        np.testing.assert_array_equal(np.asarray(r), t.numpy())


def test_backendless_service_compiled_last_reads_past_the_backends():
    """The case the clip exists for: the backend-less service's offset
    equals the backend count, and its packets pass through untouched."""
    services = _services(np.random.default_rng(1), 5)
    port_c = lb.compile_lb(services, device="cpu")
    t = port_c.tables
    assert int(t.svc_offset[-1]) == t.b_addr.shape[0]
    last = services[-1]
    n = 64
    daddr = torch.full((n,), np.uint32(last.vip).view(np.int32),
                       dtype=torch.int32)
    out = lb.lb_step(t, daddr, torch.full((n,), last.port,
                                          dtype=torch.int32),
                     torch.full((n,), last.proto, dtype=torch.int32),
                     torch.arange(n, dtype=torch.int32),
                     torch.arange(n, dtype=torch.int32),
                     max_probe=port_c.max_probe)
    assert torch.equal(out[0], daddr) and not bool(out[3].any())


def test_select_slave_matches_jax_at_int32_edges():
    h = np.array([-2 ** 31, -1, 0, 2 ** 31 - 1, -7, 12345], np.int32)
    for count in (0, 1, 3, 4, 7, 2 ** 31 - 1):
        c = np.full(h.shape, count, np.int32)
        want = np.asarray(jnp.where(
            jnp.asarray(c) > 0,
            jnp.abs(jnp.asarray(h)) % jnp.maximum(jnp.asarray(c), 1), 0))
        got = lb.select_slave(torch.as_tensor(h), torch.as_tensor(c))
        np.testing.assert_array_equal(want, got.numpy(), str(count))
    # abs(-2**31) stays negative; the modulo takes the divisor's sign
    assert int(lb.select_slave(torch.tensor([-2 ** 31], dtype=torch.int32),
                               torch.tensor([3], dtype=torch.int32))) == 1


def test_load_balancer_rev_nat_stable_across_upsert_and_delete():
    rng = np.random.default_rng(4)
    services = _services(rng, 6, zero_last=False)
    ref_bal, port_bal = ref_lb.LoadBalancer(), lb.LoadBalancer(device="cpu")
    for svc, rsvc in zip(services, _twin(services)):
        port_bal.upsert_service(svc)
        ref_bal.upsert_service(rsvc)
    # replace one (index kept), delete one (its row goes to zero), add
    # one (next index, the freed one is not reused)
    new_backends = [lb.Backend(addr=1, port=2)]
    port_bal.upsert_service(lb.Service(vip=services[2].vip,
                                       port=services[2].port,
                                       proto=services[2].proto,
                                       backends=new_backends))
    ref_bal.upsert_service(ref_lb.Service(vip=services[2].vip,
                                          port=services[2].port,
                                          proto=services[2].proto,
                                          backends=[ref_lb.Backend(1, 2)]))
    key = (services[4].vip, services[4].port, services[4].proto)
    assert port_bal.delete_service(*key) and ref_bal.delete_service(*key)
    assert not port_bal.delete_service(*key)
    extra = _services(rng, 1, zero_last=False)
    port_bal.upsert_service(extra[0])
    ref_bal.upsert_service(_twin(extra)[0])
    assert len(port_bal) == len(ref_bal) == 6
    assert [(s.vip, s.rev_nat_index) for s in port_bal.services()] == \
        [(s.vip, s.rev_nat_index) for s in ref_bal.services()]
    assert max(s.rev_nat_index for s in port_bal.services()) == 7
    _assert_tables_equal(ref_bal.compiled, port_bal.compiled)
    # the bulk upsert allocates and compiles as one upsert at a time
    one, bulk = lb.LoadBalancer(device="cpu"), lb.LoadBalancer(device="cpu")
    for svc in _services(np.random.default_rng(4), 6, zero_last=False):
        one.upsert_service(svc)
    bulk.upsert_services(_services(np.random.default_rng(4), 6,
                                   zero_last=False))
    assert [(s.vip, s.rev_nat_index) for s in bulk.services()] == \
        [(s.vip, s.rev_nat_index) for s in one.services()]
    for f in one.compiled.tables._fields:
        assert torch.equal(getattr(one.compiled.tables, f),
                           getattr(bulk.compiled.tables, f)), f


def test_prefilter_matches_reference():
    ref_f, port_f = ref_pf.PreFilter(), prefilter.PreFilter()
    rng = np.random.default_rng(8)
    addr = lambda: ".".join(str(int(x)) for x in  # noqa: E731
                            rng.integers(1, 255, 4))
    v4 = [f"{addr()}/{p}" for p in (8, 16, 24, 24, 32, 32, 32)]
    v6 = ["2001:db8::/32", "fd00::1/128"]
    fixed = ["192.0.2.0/24"]
    for f, mod in ((ref_f, ref_pf), (port_f, prefilter)):
        f.insert(v4 + v6)
        f.insert(fixed, which=mod.PrefilterType.PREFIX_FIX_V4)
    assert port_f.dump() == ref_f.dump()
    with pytest.raises(KeyError):
        port_f.delete(["203.0.113.0/24"])
    port_f.delete([v4[0], v6[0]])
    ref_f.delete([v4[0], v6[0]])
    assert port_f.dump() == ref_f.dump()

    b = 4096
    inside = [int(ipaddress.ip_network(n, strict=False).network_address)
              for n in v4[1:] + fixed]
    src = np.where(rng.random(b) < 0.5,
                   np.array(inside, np.uint32)[rng.integers(0, len(inside),
                                                            b)],
                   rng.integers(0, 2 ** 32, b).astype(np.uint32))
    src = src.view(np.int32)
    want = np.asarray(ref_f.drop_mask(jnp.asarray(src)))
    got = port_f.drop_mask(torch.as_tensor(src))
    np.testing.assert_array_equal(want, got.numpy())
    assert 0 < int(got.sum()) < b
    # the v6 set left after the delete: fd00::1/128
    src6 = np.zeros((4, 4), np.uint32)
    src6[:, 0] = 0xFD000000
    src6[:, 3] = [1, 2, 1, 0]
    src6 = src6.view(np.int32)
    want6 = np.asarray(ref_f.drop_mask6(jnp.asarray(src6)))
    got6 = port_f.drop_mask6(torch.as_tensor(src6))
    np.testing.assert_array_equal(want6, got6.numpy())
    assert got6.tolist() == [True, False, True, False]
    empty = prefilter.PreFilter()
    assert not bool(empty.drop_mask(torch.as_tensor(src)).any())
