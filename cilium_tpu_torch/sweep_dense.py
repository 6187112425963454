"""Time the dense verdict kernel built with 1, 2, 4 and 8 packets a thread.

    python3 -m cilium_tpu_torch.sweep_dense

Needs one CUDA card.  For each value k it writes a copy of
``csrc/dense_verdict.cu`` with ``kPerThread = k`` into ``_build/sweep/``,
builds it with the port's nvcc flags, reads from its SASS the
instructions a (packet, entry) pair issues in the segment loop
(``sass_mix``), and runs ``ops.dense_verdict.dense_verdict`` on that
library: bit-exact against the plain version on the baseline-config1
batch of both traffics, then timed with CUDA events at B = 2**20 on both
config-1 states and both traffics.  One JSON line per variant and per
cell.  The port itself builds the source as it is.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from unittest import mock

import numpy as np
import torch

from . import kernels, sass_mix
from .device import cuda_ms, probe
from .ops import dense_verdict as dv
from .workloads import TRAFFICS, Config1Run

VARIANTS = (1, 2, 4, 8)
STATES = ((100, 50), (10_000, 20))  # (rules, timed calls)


def build_variant(k: int):
    """(library, SASS text, ptxas register lines) of the kernel with
    ``kPerThread = k``."""
    src = (kernels.CSRC / "dense_verdict.cu").read_text()
    line = f"constexpr int kPerThread = {dv.PACKETS_PER_THREAD};"
    if src.count(line) != 1:
        raise RuntimeError(f"dense_verdict.cu: no single line {line!r}")
    out = kernels.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"dense_verdict_k{k}.cu", out / f"dense_verdict_k{k}.so"
    cu.write_text(src.replace(line, f"constexpr int kPerThread = {k};"))
    proc = subprocess.run(
        [kernels._cuda_tool("nvcc"), *kernels.NVCC_FLAGS, "-o", str(so),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for variant {k}:\n{proc.stdout}")
    lib = dv.declare(ctypes.CDLL(str(so)))
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    sass = subprocess.run([kernels._cuda_tool("cuobjdump"), "-sass",
                           str(so)], check=True, stdout=subprocess.PIPE,
                          text=True).stdout
    return lib, sass, [ln.strip() for ln in proc.stdout.splitlines()
                       if "registers" in ln]


def sweep_variant(k: int, runs: dict, feats: dict) -> None:
    """Build variant ``k`` and time the wrapper launching it."""
    lib, sass, ptxas = build_variant(k)
    mix = sass_mix.hot_loop_mix(sass, "segment_verdict_kernel", k)
    clock_hz = float(feats["max_sm_clock"].split()[0]) * 1e6
    pair = sass_mix.pair_seconds(mix["per_pair"], feats["sm_count"],
                                 clock_hz)
    print(json.dumps({
        "phase": "variant", "packets_per_thread": k,
        "ptxas": ptxas, "per_pair": mix["per_pair"],
        "opcodes": mix["opcodes"],
        "pair_seconds": pair["seconds"], "bound_pipe": pair["pipe"]}),
        flush=True)
    with mock.patch.object(dv, "_kernel_library", lambda: lib):
        for rules, iters in STATES:
            run = runs[rules]
            for traffic in TRAFFICS:
                run.set_traffic(traffic)
                ident = run.dense_step()[1]
                pk = run.pkt
                args = (pk["endpoint"], ident, pk["dport"], pk["proto"],
                        pk["direction"], pk["length"])
                exact = None
                if rules == 100:
                    got = dv.dense_verdict(run.dense, *args,
                                           segments=run.segments)
                    want = dv.dense_verdict_reference(run.dense, *args)
                    exact = all(torch.equal(g, w)
                                for g, w in zip(got, want))
                    if not exact:
                        raise AssertionError(f"variant {k}: kernel != "
                                             "plain")
                ms = cuda_ms(lambda: dv.dense_verdict(
                    run.dense, *args, segments=run.segments), iters)
                print(json.dumps({
                    "phase": "time", "packets_per_thread": k,
                    "rules": rules, "traffic": traffic,
                    "kernel_ms": float(np.median(ms)), "min_ms": min(ms),
                    "samples": len(ms),
                    "bit_exact": exact}), flush=True)


def main() -> None:
    dev = torch.device("cuda:0")
    feats = probe()
    print(json.dumps({"phase": "device",
                      "name_power_limit": feats["name_power_limit"]}),
          flush=True)
    runs = {rules: Config1Run(rules, 1 << 20, dev) for rules, _ in STATES}
    for k in VARIANTS:
        sweep_variant(k, runs, feats)


if __name__ == "__main__":
    main()
