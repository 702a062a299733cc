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

from .. import kernels

Tensor = torch.Tensor

_launch = None   # the kernel's C entry point, looked up at its first launch


def gather_rows_plain(table: Tensor, idx: Tensor) -> Tensor:
    """``table[clip(idx, 0, H-1)]`` in plain PyTorch (the kernel's twin)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def _gather_rows_cuda(table: Tensor, idx: Tensor) -> Tensor:
    """Launch ``gather_rows`` (msst_torch/csrc/gather_rows.cu) on the current
    stream.  Raises on anything the kernel does not take."""
    global _launch
    dev = table.get_device()
    kernels.check_tensors(("table", "idx"), (table, idx),
                          (torch.float32, torch.int32), dev)
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError("table must be (H, W) and idx (N,)")
    H, W = table.shape
    N = idx.shape[0]
    if H < 1 or W > 65535 * 256:
        raise ValueError(f"table shape {(H, W)}: need H >= 1, W <= {65535 * 256}")
    out = table.new_empty((N, W))
    if N and W:
        vec = int(W % 4 == 0 and table.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        if _launch is None:
            _launch = kernels.load("gather_rows").gather_rows
        err = _launch(table.data_ptr(), H, W, idx.data_ptr(), N,
                      out.data_ptr(), vec,
                      torch._C._cuda_getCurrentRawStream(dev))
        gather_rows.launches += 1
        if err != 0:
            raise RuntimeError(f"gather_rows launch failed: cudaError {err}")
    return out


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """(N, W) rows of `table` (H, W) float32 at `idx` (N,) int32, each index
    clamped to [0, H-1] (msst_tpu's ``onehot_gather_rows`` contract).

    A CPU tensor takes the plain twin; a CUDA tensor launches the CUDA
    kernel or raises.  ``gather_rows.launches`` counts kernel launches."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return _gather_rows_cuda(table, idx)


gather_rows.launches = 0
