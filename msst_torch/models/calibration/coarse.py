"""Robust coarse registration: GNC-TLS over feature correspondences (port of
``msst_tpu.models.calibration.coarse``).

The TEASER++ role in Multi_LiCa (``Calibration.py:139-212``
compute_initial_transformation): graduated non-convexity on the
correspondence residuals (Yang et al., GNC) around a weighted-Kabsch core,
each iteration one weighted Kabsch and one vectorized weight update.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import linalg, se3

Tensor = torch.Tensor


class CoarseResult(NamedTuple):
    pose: se3.Pose
    inliers: Tensor      # (P,) final TLS weights in [0, 1]
    n_inliers: Tensor
    ok: Tensor


def gnc_tls_registration(src: Tensor, dst: Tensor, valid: Tensor,
                         noise_bound: float = 0.1, max_outer: int = 20,
                         gnc_factor: float = 1.4) -> CoarseResult:
    """(R, t) from src -> dst correspondences (P, 3) under heavy outliers.

    TLS cost sum_i min(r_i^2, c^2); GNC weights w_i = (mu c^2 / (r_i^2 +
    mu c^2))^2 with mu growing by gnc_factor each outer iteration, from the
    largest residual of the unweighted solve (Yang et al.)."""
    c2 = noise_bound * noise_bound
    w0 = valid.to(src.dtype)

    def solve(w):
        R, t = linalg.weighted_kabsch(src, dst, w)
        return R, t, torch.sum((src @ R.T + t - dst) ** 2, dim=1)

    _, _, r2 = solve(w0)
    r2max = torch.max(torch.where(valid, r2, 0.0))
    mu = torch.clamp(c2 / torch.clamp(2.0 * r2max - c2, min=1e-9), min=1e-6)
    w = w0
    for _ in range(max_outer):
        _, _, r2 = solve(w)
        w = (mu * c2 / (r2 + mu * c2)) ** 2 * w0
        mu = mu * gnc_factor
    R, t, r2 = solve(w)
    n = torch.sum(((r2 < c2) & valid).to(torch.int32))
    return CoarseResult(se3.Pose(se3.matrix_to_quat(R), t), w, n, n >= 3)
