"""LOAM edge/planar feature extraction, non-max-suppression variant (port
of ``msst_tpu.ops.features.extract_features_nms``; the reference's
``featureExtraction`` stage).

* curvature = square of the 11-tap range stencil (``calculateSmoothness``
  :81-101)
* occlusion and parallel-beam rejection (``markOccludedPoints`` :103-139)
* corners: candidates above ``edge_threshold`` that are maxima over +-5
  packed neighbours, capped at the 20 largest per ring x 6 sectors; every
  other sector point is a surface candidate (``extractFeatures`` :141-238)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .range_image import ExtractedScan

Tensor = torch.Tensor

N_SECTORS = 6
MAX_CORNERS_PER_SECTOR = 20


def curvature(scan: ExtractedScan) -> tuple[Tensor, Tensor]:
    """(N_SCAN, H) curvature + validity (needs 5 neighbours each side)."""
    h = scan.rng.shape[1]
    rng = torch.where(torch.isfinite(scan.rng), scan.rng, 0.0)
    # 11-tap stencil: sum of the +-5 neighbours (zero padded) - 10 * centre
    pad = torch.nn.functional.pad(rng, (5, 5))
    nb = pad[:, 0:h]
    for s in (1, 2, 3, 4, 6, 7, 8, 9, 10):
        nb = nb + pad[:, s:s + h]
    diff = nb - 10.0 * rng
    curv = diff * diff
    pos = torch.arange(h, device=rng.device)[None, :]
    cnt = scan.count[:, None]
    valid = (pos >= 5) & (pos < cnt - 5)
    return torch.where(valid, curv, 0.0), valid


def mark_occluded(scan: ExtractedScan) -> Tensor:
    """(N_SCAN, H) bool — True where the point must not seed a feature:
    range steps > 0.3 m between points < 10 columns apart mark the 6 points
    on the far side; both neighbours > 2% of range away mark a parallel
    beam (``markOccludedPoints`` :103-139)."""
    h = scan.rng.shape[1]
    rng0 = torch.where(torch.isfinite(scan.rng), scan.rng, 0.0)
    d2 = torch.roll(rng0, -1, dims=1)
    near = torch.abs(torch.roll(scan.col, -1, dims=1) - scan.col) < 10
    a_occ = near & (rng0 - d2 > 0.3)   # marks i-5..i
    b_occ = near & (d2 - rng0 > 0.3)   # marks i+1..i+6
    picked = torch.zeros_like(a_occ)
    for s in range(0, 6):
        picked |= torch.roll(a_occ, -s, dims=1)
    for s in range(1, 7):
        picked |= torch.roll(b_occ, s, dims=1)
    diff_prev = torch.abs(torch.roll(rng0, 1, dims=1) - rng0)
    diff_next = torch.abs(torch.roll(rng0, -1, dims=1) - rng0)
    picked |= (diff_prev > 0.02 * rng0) & (diff_next > 0.02 * rng0)
    pos = torch.arange(h, device=rng0.device)[None, :]
    in_range = (pos >= 5) & (pos < scan.count[:, None] - 6)
    return picked & in_range


class FeatureMasks(NamedTuple):
    corner: Tensor   # (N_SCAN, H) bool
    surface: Tensor  # (N_SCAN, H) bool (pre-downsample)


def _sector_bounds(count: Tensor) -> tuple[Tensor, Tensor]:
    """Per-sector inclusive [sp, ep] inside each ring, (R, 6) each, matching
    ``extractFeatures`` :156-157 with start=5, end=count-6."""
    j = torch.arange(N_SECTORS, device=count.device)[None, :]
    end = count[:, None] - 6
    sp = (5 * (N_SECTORS - j) + end * j) // N_SECTORS
    ep = (5 * (N_SECTORS - 1 - j) + end * (j + 1)) // N_SECTORS - 1
    return sp, ep


def extract_features_nms(scan: ExtractedScan, edge_threshold: float = 1.0,
                         surf_threshold: float = 0.1) -> FeatureMasks:
    """Corner = candidate that is the maximum over +-5 packed neighbours,
    capped at the 20 largest per (ring, sector)."""
    curv, curv_valid = curvature(scan)
    occluded = mark_occluded(scan)
    n_scan, h = scan.rng.shape
    pos = torch.arange(h, device=curv.device)[None, :]

    cand = curv_valid & ~occluded & (curv > edge_threshold)
    wmax = torch.full_like(curv, -math.inf)
    for s in range(1, 6):
        wmax = torch.maximum(wmax, torch.roll(curv, s, dims=1))
        wmax = torch.maximum(wmax, torch.roll(curv, -s, dims=1))
    ismax = cand & (curv >= wmax)

    sp, ep = _sector_bounds(scan.count)
    sec_masks = (pos[None] >= sp[:, :, None]) & (pos[None] <= ep[:, :, None])
    masked = torch.where(sec_masks & ismax[:, None, :], curv[:, None, :],
                         -math.inf)
    kth = torch.topk(masked.reshape(n_scan * N_SECTORS, h),
                     MAX_CORNERS_PER_SECTOR, dim=1).values[:, -1]
    kth = kth.reshape(n_scan, N_SECTORS)
    # a sector with < 20 candidates has k-th value -inf: keep all
    keep = masked >= torch.where(torch.isfinite(kth), kth, -math.inf)[:, :, None]
    corner = torch.any(keep & torch.isfinite(masked), dim=1)

    in_sector = torch.any(sec_masks, dim=1)
    surface = in_sector & ~corner & (pos < scan.count[:, None])
    return FeatureMasks(corner, surface)
