"""Batched-hypothesis RANSAC and robust refinement (port of
``msst_tpu.ops.ransac``).

* plane RANSAC + Tukey-weighted refinement: the auto-calibrator's ground
  extraction (``SensorsCalibration/lidar2lidar/auto_calib/src/
  calibration.cpp:241-269``) and the heading estimator's ground/wall fits;
* 3-point circle RANSAC with a radius constraint, and the algebraic (Kasa)
  circle fit of the reflective-target trackers;
* statistical outlier removal (the mean k-NN distance gate of
  ``pcl::StatisticalOutlierRemoval``), whose k-NN is kernel B2.

Every hypothesis is scored against every point at once, as one (N, H)
computation.  The hypotheses' sample points come from one function,
:func:`draw_hypotheses`, fed by a ``torch.Generator`` where msst_tpu takes
a ``jax.random`` key (torch cannot reproduce JAX's random bits).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import knn, linalg

Tensor = torch.Tensor


class PlaneFit(NamedTuple):
    normal: Tensor       # (3,) unit
    d: Tensor            # () plane offset: n.x + d = 0
    inlier_count: Tensor
    inlier_mask: Tensor  # (N,)
    rms: Tensor
    ok: Tensor


def draw_hypotheses(mask: Tensor, n_hyp: int,
                    generator: Optional[torch.Generator] = None) -> Tensor:
    """(3, n_hyp) int64 point indices: three independent draws of n_hyp
    samples each, with replacement, uniform over the points where `mask`
    holds (over all points when none does)."""
    n = mask.shape[0]
    cnt = torch.sum(mask.to(torch.float32))
    probs = torch.where(cnt > 0, mask.to(torch.float32) / torch.clamp(cnt, min=1.0),
                        torch.full_like(cnt, 1.0 / n))
    return torch.stack([torch.multinomial(probs, n_hyp, replacement=True,
                                          generator=generator)
                        for _ in range(3)])


def _plane_from_3pts(p0, p1, p2, eps=1e-9):
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(nn, min=eps)
    d = -torch.sum(n * p0, dim=-1)
    return n, d, nn[..., 0] > eps


def ransac_plane(xyz: Tensor, mask: Tensor,
                 generator: Optional[torch.Generator] = None,
                 max_iters: int = 200, threshold: float = 0.05,
                 min_inliers: int = 10) -> PlaneFit:
    """Batched plane RANSAC: max_iters hypotheses scored in parallel; the
    first of the hypotheses with the most inliers wins."""
    idx = draw_hypotheses(mask, max_iters, generator)
    nrm, d, valid_h = _plane_from_3pts(xyz[idx[0]], xyz[idx[1]], xyz[idx[2]])

    dist = torch.abs(xyz @ nrm.T + d[None, :])              # (N, H)
    inl = (dist < threshold) & mask[:, None]
    counts = torch.sum(inl.to(torch.int32), dim=0)
    counts = torch.where(valid_h, counts, -1)
    best = torch.argmax(counts)

    normal, dd = nrm[best], d[best]
    inlier_mask = inl[:, best]
    count = counts[best]
    resid = (xyz @ normal + dd) * inlier_mask
    rms = torch.sqrt(torch.sum(resid * resid) / torch.clamp(count, min=1))
    return PlaneFit(normal, dd, count, inlier_mask, rms, count >= min_inliers)


def tukey_weights(xyz: Tensor, mask: Tensor, normal: Tensor, d: Tensor,
                  c: float = 0.1) -> Tensor:
    """Tukey biweight per point from plane residuals
    (``computeTukeyWeights``)."""
    u = (xyz @ normal + d) / c
    w = torch.where(torch.abs(u) < 1.0, (1.0 - u * u) ** 2, 0.0)
    return w * mask.to(w.dtype)


def refine_plane_weighted(xyz: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """Weighted total-least-squares plane: centroid + smallest eigenvector
    of the weighted covariance (``refinePlaneWeighted``)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    c = torch.sum(xyz * w[:, None], dim=0) / wsum
    dev = (xyz - c) * torch.sqrt(w)[:, None]
    cov = dev.T @ dev / wsum
    _, vecs = linalg.sym3x3_eigh(cov)
    normal = vecs[0]
    return normal, -torch.dot(normal, c)


def fit_plane_robust(xyz: Tensor, mask: Tensor,
                     generator: Optional[torch.Generator] = None,
                     max_iters: int = 200, threshold: float = 0.05,
                     min_inliers: int = 10, irls_rounds: int = 3,
                     tukey_c: float = 0.1) -> PlaneFit:
    """RANSAC + Tukey IRLS refinement (``estimateGroundAttitude``
    ``HeadingEstimator.cpp:325-415``)."""
    fit = ransac_plane(xyz, mask, generator, max_iters, threshold,
                       min_inliers)
    normal, d = fit.normal, fit.d
    for _ in range(irls_rounds):
        w = tukey_weights(xyz, mask & fit.inlier_mask, normal, d, tukey_c)
        normal, d = refine_plane_weighted(xyz, w)
    # keep the orientation of the RANSAC result
    flip = torch.dot(normal, fit.normal) < 0
    normal = torch.where(flip, -normal, normal)
    d = torch.where(flip, -d, d)
    resid = xyz @ normal + d
    inl = (torch.abs(resid) < threshold) & mask
    count = torch.sum(inl.to(torch.int32))
    rms = torch.sqrt(torch.sum(torch.where(inl, resid * resid, 0.0))
                     / torch.clamp(count, min=1))
    return PlaneFit(normal, d, count, inl, rms, fit.ok)


# ---------------------------------------------------------------------------
# circles (reflective-target detection)
# ---------------------------------------------------------------------------


class CircleFit(NamedTuple):
    center: Tensor       # (2,)
    radius: Tensor
    inlier_count: Tensor
    mean_error: Tensor
    ok: Tensor


def _circle_from_3pts(p0, p1, p2, eps=1e-9):
    """Circumcircle of 3 2D points (batched)."""
    ax, ay = p0[..., 0], p0[..., 1]
    bx, by = p1[..., 0], p1[..., 1]
    cx, cy = p2[..., 0], p2[..., 1]
    dd = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    ok = torch.abs(dd) > eps
    dd = torch.where(ok, dd, 1.0)
    ux = ((ax**2 + ay**2) * (by - cy) + (bx**2 + by**2) * (cy - ay)
          + (cx**2 + cy**2) * (ay - by)) / dd
    uy = ((ax**2 + ay**2) * (cx - bx) + (bx**2 + by**2) * (ax - cx)
          + (cx**2 + cy**2) * (bx - ax)) / dd
    center = torch.stack([ux, uy], dim=-1)
    return center, torch.linalg.norm(p0 - center, dim=-1), ok


def ransac_circle(xy: Tensor, mask: Tensor,
                  generator: Optional[torch.Generator] = None,
                  max_iters: int = 400, threshold: float = 0.02,
                  radius_range: tuple = (0.02, 0.5),
                  min_inliers: int = 5) -> CircleFit:
    """3-point circle RANSAC with a radius constraint, scored by inlier
    count, then by lower mean error (``circle_fit.cpp:8-101``)."""
    idx = draw_hypotheses(mask, max_iters, generator)
    c, r, valid_h = _circle_from_3pts(xy[idx[0]], xy[idx[1]], xy[idx[2]])
    valid_h = valid_h & (r >= radius_range[0]) & (r <= radius_range[1])

    d = torch.abs(torch.linalg.norm(xy[:, None, :] - c[None, :, :], dim=-1)
                  - r[None, :])                             # (N, H)
    inl = (d < threshold) & mask[:, None]
    counts = torch.sum(inl.to(torch.int32), dim=0)
    err = torch.sum(torch.where(inl, d, 0.0), dim=0) / torch.clamp(counts,
                                                                  min=1)
    score = torch.where(valid_h, counts.to(torch.float32) - err, -math.inf)
    best = torch.argmax(score)
    return CircleFit(c[best], r[best], counts[best], err[best],
                     (counts[best] >= min_inliers) & valid_h[best])


def fit_circle_algebraic(xy: Tensor, mask: Tensor) -> CircleFit:
    """Least-squares (Kasa) circle fit, [2x 2y 1] p = x^2 + y^2
    (``target_detector.cpp:538-603``), on points centred on their
    centroid: the raw normal equations are ill-conditioned in float32 for a
    small circle far from the origin."""
    w = mask.to(xy.dtype)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(xy * w[:, None], dim=0) / wsum
    q = xy - mu
    M = torch.stack([2 * q[:, 0], 2 * q[:, 1], torch.ones_like(q[:, 0])],
                    dim=1) * w[:, None]
    b = (q[:, 0] ** 2 + q[:, 1] ** 2) * w
    MtM = M.T @ M + 1e-9 * torch.eye(3, dtype=xy.dtype, device=xy.device)
    p = torch.linalg.solve(MtM, M.T @ b)
    center = p[:2] + mu
    radius = torch.sqrt(torch.clamp(p[2] + torch.sum(p[:2] * p[:2]), min=0.0))
    d = torch.abs(torch.linalg.norm(xy - center, dim=1) - radius)
    cnt = torch.sum(mask.to(torch.int32))
    err = torch.sum(d * w) / torch.clamp(cnt, min=1)
    return CircleFit(center, radius, cnt, err, cnt >= 3)


# ---------------------------------------------------------------------------
# statistical outlier removal
# ---------------------------------------------------------------------------


def statistical_outlier_mask(xyz: Tensor, mask: Tensor, k: int = 10,
                             std_mul: float = 1.0, cell_size: float = 1.0,
                             table_size: int = 8192,
                             candidates_per_cell: int = 32) -> Tensor:
    """``pcl::StatisticalOutlierRemoval``: drop the points whose mean k-NN
    distance exceeds the global mean + std_mul * the global std.  A point
    with no neighbour within the grid's 27 cells is an outlier."""
    grid = knn.build(xyz, mask, cell_size, table_size)
    res = knn.query(grid, xyz, mask, k=k + 1,
                    candidates_per_cell=candidates_per_cell)
    # the first neighbour is the point itself
    d = torch.sqrt(torch.clamp(res.sqdist[:, 1:], min=0.0))
    valid = res.valid[:, 1:]
    n_valid = torch.sum(valid.to(torch.int32), dim=1)
    has_nbr = n_valid > 0
    mean_d = torch.sum(torch.where(valid, d, 0.0), dim=1) / torch.clamp(
        n_valid, min=1)
    mean_d = torch.where(has_nbr, mean_d, math.inf)
    wm = mask & has_nbr
    n_wm = torch.clamp(torch.sum(wm.to(torch.int32)), min=1)
    mu = torch.sum(torch.where(wm, mean_d, 0.0)) / n_wm
    var = torch.sum(torch.where(wm, (mean_d - mu) ** 2, 0.0)) / n_wm
    return mask & (mean_d <= mu + std_mul * torch.sqrt(var))
