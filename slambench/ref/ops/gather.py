# Frozen copy of msst_torch/ops/gather.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
# Changed: gather_rows always takes the plain twin.
"""Row gather ``table[idx]`` over an (H, W) float32 table (port of
``msst_tpu.ops.gather_pallas``).

msst_tpu's ``onehot_gather_rows`` computes the gather as a one-hot x table
matmul, the one form Mosaic could express on the TPU.  Its contract is its
docstring, ``table[idx]``, with each index clamped to [0, H-1]; on finite
tables the matmul gives exactly those bits.  Where a table holds inf or NaN
the one-hot form spreads them over a whole H-chunk (0 * inf = NaN); the
port follows the contract, not that artifact, and copies the addressed row.

On a CUDA tensor :func:`gather_rows` is the hand-written kernel
``msst_torch/csrc/gather_rows.cu``, a direct indexed row load; on a CPU
tensor it is the plain twin :func:`gather_rows_plain`.  The loop closure
gathers keyframe-store rows through it.
"""

from __future__ import annotations

import torch


Tensor = torch.Tensor

_launch = None   # the kernel's C entry point, looked up at its first launch


def gather_rows_plain(table: Tensor, idx: Tensor) -> Tensor:
    """``table[clip(idx, 0, H-1)]`` in plain PyTorch (the kernel's twin)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """(N, W) rows of `table` (H, W) float32 at `idx` (N,) int32, each index
    clamped to [0, H-1] (msst_tpu's ``onehot_gather_rows`` contract).

    A CPU tensor takes the plain twin; a CUDA tensor launches the CUDA
    kernel or raises.  ``gather_rows.launches`` counts kernel launches."""
    return gather_rows_plain(table, idx)


gather_rows.launches = 0
