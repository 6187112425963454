"""The benchmark's copy of the serving generators gives what the port's
``workloads.py`` gives, and a ring pass outlives a closed connection."""

import json

import numpy as np
import pytest

from benchmark import generate as G
from benchmark.conftest import REPO, TINY_STATE
from benchmark.drivers import bulk
from benchmark.reference import conntrack

from cilium_tpu_torch import workloads as W

B, FLOWS = 512, 256


def _port_maps(states):
    return [{(k.identity, k.dest_port, k.nexthdr, k.direction): v.proxy_port
             for k, v in s.items()} for s in states]


@pytest.fixture(scope="module")
def both():
    kw = {k: v for k, v in TINY_STATE.items() if k != "backends"}
    return W.v4_serving_state(**kw), G.node_state(TINY_STATE,
                                                  G.DEFAULT_SEEDS)


def test_v4_state_equals_port_workloads(both):
    st, node = both
    assert _port_maps(st.states) == node.maps
    assert [list(m) for m in _port_maps(st.states)] == \
        [list(m) for m in node.maps]
    assert st.prefixes == node.prefixes
    assert [(s.vip, s.port, s.proto, [(b.addr, b.port) for b in s.backends])
            for s in st.services] == node.services
    assert st.prefilter == node.prefilter
    assert st.tunnel == node.tunnel
    assert st.ep_identity == node.ep_identity
    assert st.ident_port == node.ident_port


def test_v4_batches_equal_port_workloads(both):
    st, node = both
    traffic = json.loads((REPO / "benchmark/traffic/pool.json").read_text())
    assert traffic["shares"] == W.V4_SHARES
    port = W.v4_serving_packets(st, B, n_flows=FLOWS, seed=5)
    ours = G.batches(node, dict(traffic, batch=B, pool_flows=FLOWS),
                     G.DEFAULT_SEEDS)
    for _ in range(12):
        packed, index = next(ours)
        assert index is None
        np.testing.assert_array_equal(next(port), packed)


def _port_l7(cfg, traffic):
    """The L7 blocks of a configuration and a mix set to the port's own
    rules, requests and names (the committed files take Cilium's
    documented rules instead)."""
    cfg = json.loads(json.dumps(cfg))
    for red in cfg["l7"]["redirects"]:
        if red["protocol"] == "http":
            red["rules"] = [{k: v for k, v in vars(r).items()
                             if k in ("method", "path", "host") and v}
                            for r in W.HTTP_RULES]
        else:
            red["rules"] = [{k: v for k, v in vars(s).items()
                             if k in ("match_name", "match_pattern") and v}
                            for s in W.FQDN_SELECTORS]
    traffic = dict(traffic, l7=dict(
        traffic["l7"], http_host="admin.example.com",
        http_paths=list(W.HTTP_PATHS), http_methods=list(W.HTTP_METHODS),
        dns_names=list(W.L7_DNS_NAMES), bad_shares=W.L7_BAD_SHARES,
        flow_share=W.L7_FLOW_SHARE))
    return cfg, traffic


def test_l7_state_and_batches_equal_port_workloads(both):
    st, node = both
    cfg, traffic = _port_l7(
        json.loads(
            (REPO / "benchmark/configs/v4-node-10k-l7.json").read_text()),
        json.loads((REPO / "benchmark/traffic/pool-l7.json").read_text()))
    port = W.l7_serving_state(st, window=cfg["l7"]["window"])
    node7 = G.with_l7(node, cfg["l7"])
    assert _port_maps(port.v4.states) == node7.maps
    assert port.v4.prefixes == node7.prefixes
    np.testing.assert_array_equal(port.table,
                                  G.payload_table(node7, traffic))
    port_stream = W.l7_serving_packets(port, B, n_flows=FLOWS, seed=5)
    ours = G.batches(node7, dict(traffic, batch=B, pool_flows=FLOWS),
                     G.DEFAULT_SEEDS)
    for _ in range(12):
        (pa, pi), (oa, oi) = next(port_stream), next(ours)
        np.testing.assert_array_equal(pa, oa)
        np.testing.assert_array_equal(pi, oi)


@pytest.mark.parametrize("mix", ["pool", "pool-l7"])
def test_ring_pass_outlives_a_closed_connection(mix):
    """A replayed SYN meets a collected entry: one pass spans more clock
    seconds than a closed entry lives plus the GC cadence."""
    t = json.loads((REPO / f"benchmark/traffic/{mix}.json").read_text())
    span = t["ring"]                    # one clock second a batch
    assert span > conntrack.CT_CLOSE_TIMEOUT + bulk.GC_EVERY
    assert span > 18


def test_traffic_seeds_come_from_large_seeds():
    cfg = json.loads((REPO / "benchmark/configs/v4-node-10k.json")
                     .read_text())
    a = G.seeds_of(2 ** 31 + 12345, cfg)
    assert a == G.seeds_of(2 ** 31 + 12345, cfg)
    assert set(a) == set(G.DEFAULT_SEEDS)
    b = G.seeds_of(2 ** 31 + 12346, cfg)
    assert a["traffic"] != b["traffic"] and a["l7"] != b["l7"]
    # the deployment is the configuration's: the port's defaults here
    assert (a["policy"], a["state"]) == (b["policy"], b["state"]) == (7, 11)
