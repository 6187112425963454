"""Conntrack: the JAX package's ``ct_step`` / ``ct_gc`` /
``ct_set_rev_nat`` vs the port's, on the CPU.

Batch sequences made from numpy seeds go through both; after every
batch the CT verdicts, rev-NAT and proxy outputs and every CT field
(sentinel slot included) must be equal bit for bit (tolerance 0).  The
sequences cover create, established, reply, related, FIN/RST closing,
expiry, GC and rev-NAT stamping; a crowded case puts many packets of a
flow in one batch into a 2**8-slot table, so that several rows set one
slot and probe windows fill up.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.datapath import conntrack as ref_ct

from cilium_tpu_torch import convert
from cilium_tpu_torch.datapath import conntrack as ct


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TCP_FLAGS = np.array([ct.TCP_SYN, ct.TCP_ACK, ct.TCP_SYN | ct.TCP_ACK,
                      ct.TCP_FIN | ct.TCP_ACK, ct.TCP_RST, ct.TCP_ACK,
                      ct.TCP_ACK], np.int32)


def _flows(rng, n):
    return dict(
        saddr=rng.integers(0, 2 ** 32, n).astype(np.uint32).view(np.int32),
        daddr=rng.integers(0, 2 ** 32, n).astype(np.uint32).view(np.int32),
        sport=rng.integers(1, 65536, n).astype(np.int32),
        dport=rng.choice(np.array([53, 80, 443, 8080, 40000, 65535],
                                  np.int32), n),
        proto=rng.choice(np.array([6, 6, 6, 17, 1], np.int32), n))


def _batch(rng, flows, b):
    """One batch over the flow pool: 30% replies (reverse tuple,
    ingress), TCP flags from SYN to FIN/RST, a few related rows."""
    n = flows["saddr"].shape[0]
    pick = rng.integers(0, n, b)
    f = {k: v[pick] for k, v in flows.items()}
    reply = rng.random(b) < 0.3
    tcp = f["proto"] == 6
    return dict(
        saddr=np.where(reply, f["daddr"], f["saddr"]),
        daddr=np.where(reply, f["saddr"], f["daddr"]),
        sport=np.where(reply, f["dport"], f["sport"]),
        dport=np.where(reply, f["sport"], f["dport"]),
        proto=f["proto"],
        direction=np.where(reply, 0, 1).astype(np.int32),
        tcp_flags=np.where(tcp, rng.choice(TCP_FLAGS, b), 0)
        .astype(np.int32),
        related=(rng.random(b) < 0.05).astype(np.int32))


def _masks(rng, b):
    return dict(create=rng.random(b) < 0.8, update=rng.random(b) < 0.95,
                rev_nat=rng.integers(0, 5, b).astype(np.int32),
                proxy=rng.choice(np.array([0, 0, 0, 15001], np.int32), b))


class Pair:
    """The reference's CT state (classic per-field form) and the port's
    table, stepped together."""

    def __init__(self, slots, max_probe):
        self.slots, self.max_probe = slots, max_probe
        self.ref = ref_ct.make_ct_state(slots)
        self.port = ct.make_ct_state(slots, device="cpu")
        statics = dict(slots=slots, max_probe=max_probe)
        self._ref_step = jax.jit(functools.partial(ref_ct.ct_step,
                                                   **statics))
        self._ref_stamp = jax.jit(functools.partial(ref_ct.ct_set_rev_nat,
                                                    **statics))
        self._ref_gc = jax.jit(ref_ct.ct_gc)

    def step(self, pk, m, now):
        jb = ref_ct.CTBatch(**{k: jnp.asarray(v) for k, v in pk.items()})
        tb = ct.CTBatch(**{k: torch.as_tensor(v) for k, v in pk.items()})
        rv, rr, rp, self.ref = self._ref_step(
            self.ref, jb, jnp.int32(now), jnp.asarray(m["create"]),
            jnp.asarray(m["update"]), jnp.asarray(m["rev_nat"]),
            jnp.asarray(m["proxy"]))
        tv, tr, tp, self.port = ct.ct_step(
            self.port, tb, torch.tensor(now, dtype=torch.int32),
            torch.as_tensor(m["create"]), torch.as_tensor(m["update"]),
            torch.as_tensor(m["rev_nat"]), torch.as_tensor(m["proxy"]),
            slots=self.slots, max_probe=self.max_probe)
        for name, r, t in (("verdict", rv, tv), ("rev_nat", rr, tr),
                           ("proxy_port", rp, tp)):
            np.testing.assert_array_equal(np.asarray(r), t.numpy(), name)
        self.check()
        return np.asarray(rv)

    def stamp(self, pk, idx, now):
        jb = ref_ct.CTBatch(**{k: jnp.asarray(v) for k, v in pk.items()})
        tb = ct.CTBatch(**{k: torch.as_tensor(v) for k, v in pk.items()})
        self.ref = self._ref_stamp(self.ref, jb, jnp.asarray(idx),
                                   jnp.int32(now))
        self.port = ct.ct_set_rev_nat(
            self.port, tb, torch.as_tensor(idx),
            torch.tensor(now, dtype=torch.int32), slots=self.slots,
            max_probe=self.max_probe)
        self.check()

    def gc(self, now):
        self.ref, rn = self._ref_gc(self.ref, jnp.int32(now))
        self.port, tn = ct.ct_gc(self.port,
                                 torch.tensor(now, dtype=torch.int32))
        assert int(rn) == int(tn)
        self.check()
        return int(tn)

    def check(self):
        """Every field of every slot, sentinel included, bit for bit."""
        ref = ref_ct.ct_host_fields(self.ref)
        for i, f in enumerate(ct.FIELDS):
            np.testing.assert_array_equal(
                ref[f], self.port[i, :self.slots + 1].numpy(), f)


# (name, slots, max_probe, flows, batch, times): the lifecycle case
# spans SYN/close/non-TCP lifetimes and a jump past every lifetime; the
# crowded case has ~6 packets of each flow in a batch and more flows
# than a 2**8-slot table holds.
CASES = [
    ("lifecycle", 1 << 10, 8, 200, 256,
     (100, 101, 105, 130, 171, 172, 200, 30000)),
    ("crowded", 1 << 8, 4, 400, 2048, (10, 11, 12, 40, 80, 81)),
]


@pytest.mark.parametrize("name,slots,max_probe,n_flows,b,times", CASES,
                         ids=[c[0] for c in CASES])
def test_ct_step_sequence_matches_reference(name, slots, max_probe,
                                            n_flows, b, times):
    rng = np.random.default_rng(len(name))
    flows = _flows(rng, n_flows)
    pair = Pair(slots, max_probe)
    seen = set()
    deleted = 0
    for i, now in enumerate(times):
        if i % 2 == 1:
            # before the step, whose creates would reuse expired slots
            deleted += pair.gc(now)
        pk = _batch(rng, flows, b)
        seen.update(pair.step(pk, _masks(rng, b), now).tolist())
        if i % 3 == 1:
            stamp = rng.integers(0, 7, b).astype(np.int32)
            pair.stamp(pk, stamp, now)
    assert seen == {ct.CT_NEW, ct.CT_ESTABLISHED, ct.CT_REPLY,
                    ct.CT_RELATED}, seen
    assert deleted > 0
    if name == "crowded":
        # the table ran full: most slots hold live entries
        live = int((pair.port[ct.FIELDS.index("k3"), :slots] != 0).sum())
        assert live > slots // 2, live


def test_elect_keeps_the_last_row_of_each_slot():
    tgt = torch.tensor([3, 1, 3, 9, 1, 3, 9], dtype=torch.int32)
    got = ct._elect(tgt, discard=9)
    assert got.tolist() == [9, 9, 9, 9, 1, 3, 9]


def test_snapshot_round_trips_between_packages():
    """JAX state -> snapshot -> port; step both; port snapshot -> JAX;
    step both: every output and field agrees, and the snapshots have
    the reference's layout (per-field [N+1] arrays plus ``slots``)."""
    slots, max_probe, b = 1 << 9, 8, 384
    rng = np.random.default_rng(11)
    flows = _flows(rng, 150)
    pair = Pair(slots, max_probe)
    for now in (50, 51, 52):
        pair.step(_batch(rng, flows, b), _masks(rng, b), now)

    ref_table = ref_ct.ConntrackTable(slots=slots, max_probe=max_probe,
                                      packed=True)
    ref_table.state = ref_ct.make_ct_pack(slots)
    snap = ref_ct.ct_host_fields(pair.ref)
    snap["slots"] = np.array([slots], np.int64)
    port_table = convert.conntrack_from_snapshot(snap, max_probe=max_probe,
                                                 device="cpu")
    assert port_table.entry_count() == \
        int((snap["k3"][:-1] != 0).sum()) > 0
    pair.port = port_table.state
    pair.step(_batch(rng, flows, b), _masks(rng, b), 53)

    port_table.state = pair.port
    back = port_table.snapshot()
    assert sorted(back) == sorted(list(ct.FIELDS) + ["slots"])
    assert all(back[f].shape == (slots + 1,) and back[f].dtype == np.int32
               for f in ct.FIELDS)
    assert ref_table.restore_snapshot(back) == port_table.entry_count()
    pair.ref = ref_ct.CTState(**ref_ct.ct_host_fields(ref_table.state))
    pair.step(_batch(rng, flows, b), _masks(rng, b), 54)

    with pytest.raises(ValueError, match="geometry"):
        ct.ConntrackTable(slots=slots * 2, device="cpu").prepare_snapshot(
            back)


def test_conntrack_table_wrapper_matches_reference():
    """``ConntrackTable`` step / stamp_rev_nat / gc / entry_count on
    both packages."""
    slots = 1 << 8
    rng = np.random.default_rng(5)
    flows = _flows(rng, 60)
    ref_table = ref_ct.ConntrackTable(slots=slots, max_probe=8)
    port_table = ct.ConntrackTable(slots=slots, max_probe=8, device="cpu")
    for now in (10, 11, 100):
        pk = _batch(rng, flows, 128)
        rv, rr = ref_table.step(
            ref_ct.CTBatch(**{k: jnp.asarray(v) for k, v in pk.items()}),
            now)
        tb = ct.CTBatch(**{k: torch.as_tensor(v) for k, v in pk.items()})
        tv, tr = port_table.step(tb, now)
        np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(rr), tr.numpy())
        idx = rng.integers(0, 4, 128).astype(np.int32)
        ref_table.stamp_rev_nat(
            ref_ct.CTBatch(**{k: jnp.asarray(v) for k, v in pk.items()}),
            jnp.asarray(idx), now)
        port_table.stamp_rev_nat(tb, torch.as_tensor(idx), now)
        assert ref_table.entry_count() == port_table.entry_count()
        assert ref_table.gc(now + 30) == port_table.gc(now + 30)
    snap_ref, snap_port = ref_table.snapshot(), port_table.snapshot()
    for f in ct.FIELDS:
        np.testing.assert_array_equal(snap_ref[f], snap_port[f], f)
