"""Sync-point lint of the port's serving path: the async lane cannot
silently start waiting for the card.

The one permitted wait on the serving path is the completion wait in
``VerdictDispatcher._finalize_records`` (the "complete" stage, a
flagged blocking boundary one batch behind the launch front).  Any
torch construct that copies a tensor to the host or waits for the card
(``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()``,
``torch.cuda.synchronize``, an event's ``.synchronize()``, ``np.asarray``
/ ``np.array`` of a tensor) inside the serving modules, or inside the
engine's dispatch functions, must carry a ``# sync-ok: <reason>``
marker, and the markers are pinned: the completion wait, and the
engine's event-gated read of finished verdicts for the outcome counts.
"""

import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOT_MODULES = (
    "cilium_tpu_torch/datapath/serving.py",
    "cilium_tpu_torch/datapath/supervisor.py",
    "cilium_tpu_torch/verdict_service.py",
    "cilium_tpu_torch/observability/slo.py",
    "cilium_tpu_torch/observability/events.py",
)

# the engine is hot only in its dispatch functions; table loading, CT
# snapshots and replay are control plane and read the card freely
ENGINE_MODULE = "cilium_tpu_torch/datapath/engine.py"
ENGINE_HOT_FUNCS = {"process", "process6", "process_packed", "_serve",
                    "_timestamp", "_payload_in", "_dispatch_locked",
                    "_account_dispatch", "_flush_verdict_counts",
                    "serving"}

SYNC_RE = re.compile(
    r"\.cpu\(\)|\.item\(\)|\.tolist\(\)|\.numpy\(\)"
    r"|torch\.cuda\.synchronize|\.synchronize\(\)|np\.asarray\(|np\.array\(")
MARKER_RE = re.compile(r"#\s*sync-ok:\s*\S")


def _module_lines(relpath):
    with open(os.path.join(REPO, relpath)) as f:
        return f.read().splitlines()


def _engine_hot_lines():
    """(lineno, text) of every line inside the engine's hot functions,
    found through the AST so a renamed function cannot leave the lint."""
    lines = _module_lines(ENGINE_MODULE)
    tree = ast.parse("\n".join(lines))
    found, out = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name in ENGINE_HOT_FUNCS:
            found.add(node.name)
            out += [(ln, lines[ln - 1])
                    for ln in range(node.lineno, node.end_lineno + 1)]
    assert found == ENGINE_HOT_FUNCS, ENGINE_HOT_FUNCS - found
    return out


def _all_hot_lines():
    for rel in HOT_MODULES:
        for i, line in enumerate(_module_lines(rel), start=1):
            yield rel, i, line
    for ln, line in _engine_hot_lines():
        yield ENGINE_MODULE, ln, line


def test_no_unflagged_sync_in_the_serving_path():
    violations = [f"{rel}:{ln}: {line.strip()}"
                  for rel, ln, line in _all_hot_lines()
                  if SYNC_RE.search(line) and "sync-ok" not in line]
    assert not violations, (
        "a host read or wait for the card on the serving path without "
        "a '# sync-ok: <reason>' marker:\n" + "\n".join(violations))


def test_sync_ok_markers_carry_reasons():
    bare = [f"{rel}:{ln}: {line.strip()}"
            for rel, ln, line in _all_hot_lines()
            if "sync-ok" in line and not MARKER_RE.search(line)]
    assert not bare, bare


def test_whitelisted_boundaries_stay_pinned():
    """Exactly the completion wait in serving.py and the event-gated
    verdict-count read in the engine."""
    by_module = {}
    for rel, _ln, line in _all_hot_lines():
        if "sync-ok" in line and SYNC_RE.search(line):
            by_module[rel] = by_module.get(rel, 0) + 1
    assert by_module == {"cilium_tpu_torch/datapath/serving.py": 1,
                         ENGINE_MODULE: 1}, by_module
    finalize = [line for _rel, _ln, line in _all_hot_lines()
                if "sync-ok" in line and "serving.py" in _rel]
    assert finalize and "done.synchronize()" in finalize[0]


def test_lint_catches_each_construct():
    for text in ("x = v.cpu()", "n = v.item()", "v.tolist()",
                 "a = t.numpy()", "torch.cuda.synchronize()",
                 "ev.synchronize()", "np.asarray(verdict)",
                 "np.array(identity)"):
        assert SYNC_RE.search(text), text
    for text in ("np.ascontiguousarray(x)", "ev.query()",
                 "t.to(dev, non_blocking=True)"):
        assert not SYNC_RE.search(text), text
