"""The 32-bit mix the datapath hashes with: load-balancer backend
selection and the probe windows of the conntrack and flow tables.

All arithmetic is int32 on torch tensors: uint32 multiply, add and xor
are bit-identical under two's complement, and a logical right shift is
an arithmetic shift followed by a mask of the kept bits.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = int(np.array(0x9E3779B1, np.uint32).view(np.int32))
_C2 = int(np.array(0x85EBCA6B, np.uint32).view(np.int32))
_C3 = int(np.array(0xC2B2AE35, np.uint32).view(np.int32))


def _srl(h: torch.Tensor, n: int) -> torch.Tensor:
    return (h >> n) & ((1 << (32 - n)) - 1)


def hash_mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mix two int32 words (uint32 bits) into one."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    h = a * _C1
    h = h ^ _srl(h, 15)
    h = h + b * _C2
    h = h ^ _srl(h, 13)
    h = h * _C3
    h = h ^ _srl(h, 16)
    return h


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits as non-negative int64 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as int32."""
    return (((x & 0xFFFFFFFF) ^ (1 << 31)) - (1 << 31)).to(torch.int32)
