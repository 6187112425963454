"""Device resolution, a small probe of the card, and CUDA-event timing.

Twin of the engine list in ``cilium_tpu/utils/platform.py``: the port
has three verdict engines, ``hash``, ``dense`` and the at-scale
two-choice ``bucket`` engine; on a CUDA device the dense engine's
verdict stage is the hand-written kernel ``csrc/dense_verdict.cu``.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when a CUDA device is asked
    for (explicitly or by default) and none is present: the port never
    falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one, ``cuda`` and ``cuda:0`` alike (a
    tensor made on ``cuda`` reports ``cuda:0``)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if a.index is None or \
        b.index is None else 0
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def host_buffer(shape, pinned: bool) -> Tuple[torch.Tensor, np.ndarray]:
    """An int32 host tensor, page-locked when ``pinned`` (so copies
    between it and a card can be queued without the host waiting), and
    a numpy view of the same memory for the host to fill or read."""
    t = torch.empty(shape, dtype=torch.int32, pin_memory=pinned)
    return t, t.numpy()


def nvidia_smi(fields: str) -> Optional[str]:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` for the
    first card, or None where nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def probe() -> Dict:
    """Torch version, CUDA presence, device name, compute capability
    (9.0 = Hopper), power limit and the verdict engines on offer."""
    feats: Dict = {"torch": torch.__version__,
                   "cuda": torch.version.cuda,
                   "cuda_available": torch.cuda.is_available()}
    if feats["cuda_available"]:
        major, minor = torch.cuda.get_device_capability(0)
        feats.update(device_name=torch.cuda.get_device_name(0),
                     device_count=torch.cuda.device_count(),
                     capability=f"{major}.{minor}",
                     hopper=major == 9,
                     sm_count=torch.cuda.get_device_properties(0)
                     .multi_processor_count,
                     name_power_limit=nvidia_smi("name,power.limit"),
                     max_sm_clock=nvidia_smi("clocks.max.sm"))
    feats["verdict_engines"] = ["hash", "dense", "bucket"] + \
        (["dense-cuda"] if feats["cuda_available"] else [])
    return feats


def cuda_ms(fn: Callable[[], object], iters: int) -> List[float]:
    """Per-call device time of ``fn`` in ms, one CUDA event pair each,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times
