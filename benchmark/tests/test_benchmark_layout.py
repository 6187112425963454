"""The benchmark is data: a cell, a mix, a configuration and a metric are
added as files, and BENCHMARK.json keeps to its contract."""

import importlib
import json
import re
import time

import pytest
import torch

from benchmark import harness
from benchmark.conftest import REPO, TINY_STATE

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_cell_needs_new_files_only(tiny_tree):
    b = tiny_tree / "benchmark"
    cfg = json.loads((b / "configs/v4-node-10k.json").read_text())
    cfg["state"] = dict(TINY_STATE, n_rules=120, n_services=24)
    (b / "configs/v4-node-1k.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic/pool.json").read_text())
    traffic["shares"] = dict(traffic["shares"], new=0.08, reply=0.06)
    (b / "traffic/pool-churny.json").write_text(json.dumps(traffic))
    (b / "metrics/gc_ms.json").write_text(json.dumps({
        "reader": "stage_ms", "stage": "gc", "unit": "ms",
        "functions": ["cilium_tpu_torch.datapath.conntrack:ct_gc"],
        "moves": "verdicts_per_s", "workloads": ["v4-node-1k.pool-churny"]}))
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "v4-node-1k", "source": "x",
                             "file": "benchmark/configs/v4-node-1k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "v4-node-1k.pool-churny",
                               "config": "v4-node-1k",
                               "traffic": "pool-churny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "gc_ms", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "conntrack", "moves":
        "verdicts_per_s", "workloads": ["v4-node-1k.pool-churny"]})
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in REPO.joinpath("benchmark").rglob(
        "*") if p.is_file() and "__pycache__" not in p.parts}

    cell = harness.find_cell(tiny_tree, "v4-node-1k.pool-churny")
    assert [m["name"] for m in cell.per_layer] == ["gc_ms"]
    assert cell.config["state"]["n_rules"] == 120
    for trace in (False, True):
        result, _ = harness.run_cell(tiny_tree, "v4-node-1k.pool-churny",
                                     11, 1.0, trace, torch.device("cpu"),
                                     time.perf_counter())
        assert result["correct"] is True and result["attempted"] > 0
    assert set(result["checks"]) >= {"rows_mismatched"}
    after = {p: p.read_bytes() for p in before}
    assert before == after


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + \
        1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == \
            c["source"]
        assert all(k in cfg["state"] for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) \
            not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (REPO / f"benchmark/traffic/{w['traffic']}.json").read_text())
        importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        spec = json.loads(
            (REPO / f"benchmark/metrics/{m['name']}.json").read_text())
        assert spec["unit"] == m["unit"] and spec["moves"] == m["moves"]
        assert spec["workloads"] == m["workloads"]
        importlib.import_module(f"benchmark.readers.{spec['reader']}")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for cell in cells:
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", ["v4-node-10k.pool", "v4-node-10k-l7.pool"])
def test_each_metric_function_exists_in_the_program(cell):
    for spec in harness.find_cell(REPO, cell).per_layer:
        for ref in spec.get("functions", ()):
            mod, attr = ref.split(":")
            assert callable(getattr(importlib.import_module(mod), attr))
