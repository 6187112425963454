"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library is built at first use, from the sources in the package only,
into ``_build/`` (listed in ``.gitignore``) under a name that carries a
digest of the source and the flags, so an edited source is rebuilt.
Nothing is built or loaded when this module is imported.  The caller
sets each C function's ``argtypes`` next to its wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _cuda_tool(tool: str) -> str:
    exe = shutil.which(tool) or f"/usr/local/cuda/bin/{tool}"
    if not os.access(exe, os.X_OK):
        raise RuntimeError(f"{tool} not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return exe


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Optional[Dict]:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns
    {"seconds", "log"} when it compiled now (``log`` holds ptxas's
    register and spill report), else None; raises if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        _loaded[name] = lib
    return lib


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    build(name)
    return subprocess.run(
        [_cuda_tool("cuobjdump"), "-sass", str(library_path(name))],
        check=True, stdout=subprocess.PIPE, text=True).stdout


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
