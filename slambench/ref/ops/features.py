# Frozen copy of msst_torch/ops/features.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
"""LOAM edge/planar feature extraction (port of ``msst_tpu.ops.features``;
the reference's ``featureExtraction`` stage): the non-max-suppression
variant ``extract_features_nms`` (the default) and the reference's greedy
picks ``extract_features``.

* curvature = square of the 11-tap range stencil (``calculateSmoothness``
  :81-101)
* occlusion and parallel-beam rejection (``markOccludedPoints`` :103-139)
* corners (NMS): candidates above ``edge_threshold`` that are maxima over +-5
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


def extract_features(scan: ExtractedScan, edge_threshold: float = 1.0,
                     surf_threshold: float = 0.1) -> FeatureMasks:
    """The reference's greedy corner picks (``extractFeatures`` :141-238),
    all rings at once.

    Per ring, sector by sector: up to 20 times, the largest unpicked
    candidate above ``edge_threshold`` becomes a corner (the first column
    among equals) and it and up to 5 packed neighbours each side are marked
    picked, a side stopping at a column gap > 10; then the sector's flat
    points (below ``surf_threshold``) and up to 5 neighbours each side,
    across gaps <= 10, are marked picked.  The picks of each sector see
    those of the sectors before it, so the sector and pick order is the
    contract: the loops run over sectors and picks, each step over every
    ring."""
    curv, valid = curvature(scan)
    occluded = mark_occluded(scan)
    n_scan, h = scan.rng.shape
    dev = curv.device
    pos = torch.arange(h, device=dev)[None, :]
    sp, ep = _sector_bounds(scan.count)
    col = scan.col
    # gap[:, i]: columns i-1 and i lie <= 10 apart (i in [1, h)); False at
    # 0 and at h, so that a suppression walk stops at either end
    near = torch.abs(col[:, 1:] - col[:, :-1]) <= 10
    no = torch.zeros((n_scan, 1), dtype=torch.bool, device=dev)
    gap = torch.cat([no, near, no], dim=1)
    # the flat spread's gaps, as the reference rolls them (wrapping)
    gap_roll = torch.abs(col - torch.roll(col, 1, dims=1)) <= 10
    steps = torch.arange(1, 6, device=dev)
    # forward step l lands on ind + l (gap at ind + l); backward on ind - l
    # (gap at ind - l + 1)
    walk = torch.cat([steps, 1 - steps])[None, :]
    edge = valid & (curv > edge_threshold)
    flat_pt = valid & (curv < surf_threshold)

    picked = occluded | ~valid
    corner = torch.zeros_like(picked)
    covered = torch.zeros_like(picked)
    for j in range(N_SECTORS):
        in_sec = ((pos >= sp[:, j:j + 1]) & (pos <= ep[:, j:j + 1])
                  & (sp[:, j:j + 1] < ep[:, j:j + 1]))
        for _ in range(MAX_CORNERS_PER_SECTOR):
            c = torch.where(in_sec & ~picked & edge, curv, -math.inf)
            best, ind = torch.max(c, dim=1, keepdim=True)
            ok = best > -math.inf
            on = torch.gather(gap, 1, torch.clamp(ind + walk, 0, h))
            n_fwd = torch.sum(torch.cumprod(on[:, :5].to(torch.int32), 1),
                              dim=1, keepdim=True)
            n_bwd = torch.sum(torch.cumprod(on[:, 5:].to(torch.int32), 1),
                              dim=1, keepdim=True)
            picked = picked | (ok & (pos >= ind - n_bwd) & (pos <= ind + n_fwd))
            corner = corner | (ok & (pos == ind))
        spread = in_sec & ~picked & flat_pt
        for _ in range(5):
            spread = (spread | (torch.roll(spread, 1, dims=1) & gap_roll)
                      | (torch.roll(spread, -1, dims=1)
                         & torch.roll(gap_roll, -1, dims=1)))
        picked = picked | spread
        covered = covered | in_sec
    surface = covered & ~corner & (pos < scan.count[:, None])
    return FeatureMasks(corner, surface)
