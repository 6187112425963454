"""On a card: one short run of each cell, as the check runs it."""

import json
import subprocess
import sys

import pytest

from benchmark.conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("cell", ["v4-node-10k.pool", "v4-node-10k-l7.pool"])
def test_a_short_run_is_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
