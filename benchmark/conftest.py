"""Test settings of the benchmark's own tests (``benchmark/tests``).

``card`` marks a test that needs a CUDA card; the ``card`` fixture skips
it where there is none, decided when the test runs, never at import.
``tiny_tree`` builds a checkout-like tree in a temporary directory: the
benchmark's files with each configuration and mix cut to a size the CPU
runs in seconds, and a ``BENCHMARK.json`` naming them.  Run the tests
with ``python -m pytest benchmark/tests -q``; the card tests run on a
card with ``python -m pytest benchmark/tests -q -m card``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

TINY_STATE = {"n_rules": 200, "n_endpoints": 4, "n_services": 40,
              "backends": 4, "n_prefilter": 20, "n_nodes": 8}
TINY_ENGINE = {"ct_slots": 1 << 12, "flow_slots": 256}
TINY_TRAFFIC = {"batch": 512, "pool_flows": 256}
# batches a traced CPU run profiles
TINY_TRACE_BATCHES = 4


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def make_tiny_tree(root: Path) -> Path:
    """The benchmark's files under ``root`` at a CPU size."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["state"] = dict(TINY_STATE)
        cfg["engine"].update(TINY_ENGINE)
        path.write_text(json.dumps(cfg))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(TINY_TRAFFIC)
        tr.pop("pinned_bytes", None)
        path.write_text(json.dumps(tr))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny_tree(tmp_path, monkeypatch):
    from benchmark.drivers import bulk
    monkeypatch.setattr(bulk, "TRACE_BATCHES", TINY_TRACE_BATCHES)
    return make_tiny_tree(tmp_path)
