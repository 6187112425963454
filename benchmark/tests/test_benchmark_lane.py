"""The lane driver on the CPU: tickets through ``Datapath.serving()`` in a
closed and an open loop, judged launch by launch.  It has no cell yet;
a cell for it is a traffic file (``"driver": "lane"``) and an entry."""

import json
import time

import pytest
import torch

from benchmark import harness

LOADS = {"closed": {"submitters": 4, "outstanding": 2},
         "open": {"rate": 150}}


@pytest.mark.parametrize("load", sorted(LOADS))
@pytest.mark.parametrize("trace", [False, True])
def test_lane_runs_and_is_correct(tiny_tree, monkeypatch, load, trace):
    from benchmark.drivers import lane
    monkeypatch.setattr(lane, "WARMUP_SECONDS", 0.4)
    monkeypatch.setattr(lane, "TRACE_SECONDS", 0.3)
    b = tiny_tree / "benchmark"
    pool = json.loads((b / "traffic/pool.json").read_text())
    traffic = {k: pool[k] for k in ("batch", "pool_flows", "shares")}
    traffic.update(driver="lane", ring=4, records=64, **LOADS[load])
    (b / f"traffic/lane-{load}.json").write_text(json.dumps(traffic))
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    cell = f"v4-node-10k.lane-{load}"
    bench["workloads"].append({"name": cell, "config": "v4-node-10k",
                               "traffic": f"lane-{load}", "chips": 1,
                               "why": "test"})
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(bench))
    result, checks = harness.run_cell(tiny_tree, cell, 21, 1.0, trace,
                                      torch.device("cpu"),
                                      time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 10 and result["failed"] == 0
    if not trace:
        assert result["metrics"]["verdicts_per_s"]["value"] > 0
