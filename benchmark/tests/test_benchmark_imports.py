"""What the benchmark loads: nothing of the JAX stack or the JAX package
in a whole run, nothing of the program in the reference, and none of the
repo's older bench scripts and artifacts."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark.conftest import REPO, make_tiny_tree

# the older bench scripts and artifacts, spelled so that this file does
# not name them itself
OLD = ["bench" + ".py", "bench" + "_suite.py", "chip" + "_smoke.py",
       "BENCH" + "_"]


def _fresh(code: str, cwd: Path) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_run_loads_no_jax(tmp_path):
    tree = make_tiny_tree(tmp_path / "tree")
    code = f"""
import sys, time, json
sys.path.insert(0, {str(REPO)!r})
import torch
from benchmark import harness
harness.run_cell(__import__("pathlib").Path({str(tree)!r}),
                 "v4-node-10k-l7.pool", 3, 0.5, True, torch.device("cpu"),
                 time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    loaded = set(json.loads(_fresh(code, tmp_path)))
    assert "cilium_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cilium_tpu"}


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    code = f"""
import sys, json, pkgutil, importlib
sys.path.insert(0, {str(REPO)!r})
import benchmark.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("benchmark.reference." + m.name)
import benchmark.generate, benchmark.compare
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    loaded = set(json.loads(_fresh(code, tmp_path)))
    assert not loaded & {"jax", "jaxlib", "flax", "cilium_tpu",
                         "cilium_tpu_torch"}


def test_no_file_reads_the_old_bench_scripts():
    for path in (REPO / "benchmark").rglob("*"):
        if path.suffix in (".py", ".json") and path.name != Path(
                __file__).name:
            text = path.read_text()
            assert not [o for o in OLD if o in text], path


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "v4-node-10k.pool", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
