"""Arithmetic that must give the same bits on every device.

* ``mul_i32``: int32 multiply that wraps modulo 2^32, as XLA's does.  It is
  computed in int64 and cut back, so no signed overflow happens on any
  backend (the spatial hashes multiply cell coordinates by large primes).
* ``div``: float division by a Python number through a one-element tensor on
  the operand's device.  PyTorch's CUDA backend divides by a CPU scalar as a
  multiply by its reciprocal, which can round differently from IEEE
  division and move a point across a voxel boundary; a device tensor keeps
  the division exact on CPU and CUDA alike.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def mul_i32(x: Tensor, k: int) -> Tensor:
    """x * k wrapped to int32 (two's complement), for int32 x."""
    return ((x.to(torch.int64) * k) & 0xFFFFFFFF).to(torch.int32)


def div(x: Tensor, s: float) -> Tensor:
    """x / s in IEEE float division, for a Python number s."""
    return x / torch.full((1,), s, dtype=x.dtype, device=x.device)
