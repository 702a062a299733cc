"""Arithmetic that must give the same bits on every device.

* ``mul_i32``: int32 multiply that wraps modulo 2^32, as XLA's does.  It is
  computed in int64 and cut back, so no signed overflow happens on any
  backend (the spatial hashes multiply cell coordinates by large primes).
* ``hash3``: the spatial hash of integer cell coordinates that the voxel
  feature map and the knn hash grid share, with msst_tpu's int32 semantics.
* ``div``: float division by a Python number through a one-element tensor on
  the operand's device.  PyTorch's CUDA backend divides by a CPU scalar as a
  multiply by its reciprocal, which can round differently from IEEE
  division and move a point across a voxel boundary; a device tensor keeps
  the division exact on CPU and CUDA alike.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# large prime multipliers of the 3D spatial hash (Teschner et al.)
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_INT32_MIN = -2**31


def mul_i32(x: Tensor, k: int) -> Tensor:
    """x * k wrapped to int32 (two's complement), for int32 x."""
    return ((x.to(torch.int64) * k) & 0xFFFFFFFF).to(torch.int32)


def hash3(c: Tensor, table_size: int) -> Tensor:
    """``abs(c0*P1 ^ c1*P2 ^ c2*P3) % table_size`` for int32 cells (..., 3)
    with msst_tpu's int32 semantics: the multiplies wrap, abs(INT32_MIN)
    stays INT32_MIN, and the modulo is a floor-mod (non-negative)."""
    h = (mul_i32(c[..., 0], _P1) ^ mul_i32(c[..., 1], _P2)
         ^ mul_i32(c[..., 2], _P3)).to(torch.int64)
    h = torch.where(h == _INT32_MIN, h, torch.abs(h))
    return torch.remainder(h, table_size).to(torch.int32)


def div(x: Tensor, s: float) -> Tensor:
    """x / s in IEEE float division, for a Python number s."""
    return x / torch.full((1,), s, dtype=x.dtype, device=x.device)
