"""The control of ``correct``: runs of one cell on several seeds in one
process with the control in the program's place, each printing its
checks.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --seconds 5

The control is the reference with one guarantee of the configuration
broken (``program.ReferenceSystem``: conntrack forgets every connection,
so replies and established flows no longer follow their entries).  Its
runs have to come out not correct.  The benchmark's own runs never run
it.  Needs a CUDA card, as ``benchmark.run`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    from .harness import cache_dirs, run_cell
    from .program import ReferenceSystem
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    os.environ.update(cache_dirs(root))
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, _ = run_cell(root, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), t,
                             make_system=ReferenceSystem)
        print(json.dumps({"seed": seed,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "attempted": result["attempted"],
                          "run_s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
