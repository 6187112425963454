"""The comparison fails what it must: the control (the reference with
the connection-tracking guarantee broken) and the timed path broken
underneath a run, each driven through the rest of a run on the CPU."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.program import PortSystem, ReferenceSystem

CELLS = ["v4-node-10k.pool", "v4-node-10k-l7.pool"]


class StateUnchanged(PortSystem):
    """A step that returns its state unchanged."""

    def step(self, packed, now, payload=None):
        keep = self.snapshot()
        out = super().step(packed, now, payload)
        dp = self.dp
        dp.ct.state.copy_(keep["ct"])
        dp.flows.state.keys.copy_(keep["flow_keys"])
        dp.flows.state.counters.copy_(keep["flow_counters"])
        dp._counters.copy_(keep["counters"])
        return out


class HalfBatch(PortSystem):
    """Half of the batch left out: its outputs are zeros."""

    def step(self, packed, now, payload=None):
        half = packed.shape[1] // 2
        out = super().step(packed[:, :half].contiguous(), now,
                           None if payload is None
                           else payload[:half].contiguous())
        return tuple(torch.cat([o, torch.zeros_like(o)]) for o in out)


class AlteredAnswer(PortSystem):
    """One verdict altered where it is produced."""

    def step(self, packed, now, payload=None):
        out = list(super().step(packed, now, payload))
        v = out[0].clone()
        v[0] = torch.where(v[0] == 0, -1, 0)
        out[0] = v
        return tuple(out)


def _run(tree, cell, system):
    result, checks = harness.run_cell(tree, cell, 2 ** 31 + 9, 1.0, False,
                                      torch.device("cpu"),
                                      time.perf_counter(),
                                      make_system=system)
    return result, {name: value for name, value, _ in checks}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_tree, cell):
    result, checks = _run(tiny_tree, cell, ReferenceSystem)
    assert result["correct"] is False
    assert checks["rows_mismatched"] > 0
    assert checks["ct_entries_mismatched"] > 0


@pytest.mark.parametrize("fault,fails", [
    (StateUnchanged, ("ct_entries_mismatched", "counters_mismatched")),
    (HalfBatch, ("rows_mismatched",)),
    (AlteredAnswer, ("rows_mismatched",))])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_tree, cell, fault, fails):
    result, checks = _run(tiny_tree, cell, fault)
    assert result["correct"] is False
    assert all(checks[name] > 0 for name in fails)
