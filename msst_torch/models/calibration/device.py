"""The calibration tools' device and their fixed-capacity inputs."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises where it names CUDA and no CUDA
    device is present (the tools never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the calibration runs on device={str(device)!r} and no CUDA "
            "device is present; pass device='cpu' to run on the CPU")
    return dev


def pad(xyz: np.ndarray, capacity: int, device) -> tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(capacity, 3) float32 points and their (capacity,) mask on `device`:
    the first `capacity` rows of `xyz`, zeros after them."""
    n = min(len(xyz), capacity)
    out = np.zeros((capacity, 3), np.float32)
    out[:n] = np.asarray(xyz, np.float32)[:n]
    mask = np.arange(capacity) < n
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(mask).to(device))
