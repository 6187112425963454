"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  It refuses to run (exit 2, no result) without them; there is
no CPU fallback.  The last line of standard output is the JSON result;
the last lines of standard error are the numbers compared, each beside
its limit.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.  Exit 3 and no
result where a module of the JAX stack or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    t_now = time.perf_counter()
    from .harness import (cache_dirs, find_cell, forbidden_loaded,
                          process_elapsed_s, run_cell)
    process_start = t_now - process_elapsed_s()
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    os.environ.update(cache_dirs(root))

    import torch
    cell = find_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import cilium_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not here: {e}", file=sys.stderr)
        return 2
    result, checks = run_cell(root, args.workload, args.seed,
                              args.seconds, bool(args.trace),
                              torch.device("cuda", 0), process_start)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: modules of the JAX stack or package loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
