"""Point normals, FPFH descriptors and mutual feature matches (port of
``msst_tpu.models.calibration.features``).

The Multi_LiCa coarse stage (``Calibration.py:139-212``) voxel-downsamples,
estimates normals, computes 33-bin FPFH (Open3D) and matches features by
mutual nearest neighbour.  Each stage is one fixed-shape batched program:
normals from the k-NN covariance (kernel B2 at k = 48), SPFH Darboux-angle
histograms, FPFH as the distance-weighted neighbour average, and the feature
distance matrix as one (N, 33) x (33, M) matmul in full float32.
"""

from __future__ import annotations

import math

import torch

from ...ops import knn, linalg

Tensor = torch.Tensor

N_BINS = 11  # per angle, 3 angles -> 33-dim FPFH (Open3D/PCL layout)


def estimate_normals(xyz: Tensor, mask: Tensor, grid: knn.HashGrid,
                     k: int = 16, candidates_per_cell: int = 32,
                     max_radius: float = math.inf) -> Tensor:
    """Smallest-eigenvector normals oriented toward the origin (the
    viewpoint).  ``max_radius`` bounds the support as Open3D's
    KDTreeSearchParamHybrid does (``Calibration.py:413-415``), so that the
    feature scale does not depend on the cloud's density."""
    res = knn.query(grid, xyz, mask, k=k,
                    candidates_per_cell=candidates_per_cell,
                    max_sqdist=float(max_radius) ** 2)
    nbrs = xyz[res.idx.long()]
    w = res.valid.to(xyz.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mu = torch.sum(nbrs * w, dim=1) / cnt
    dev = (nbrs - mu[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", dev, dev)
    _, vecs = linalg.sym3x3_eigh(cov)
    n = vecs[:, 0, :]
    # orient toward the sensor origin (pcl::flipNormalTowardsViewpoint)
    flip = torch.sum(n * xyz, dim=1) > 0
    return torch.where(flip[:, None], -n, n)


def _pair_features(p1, n1, p2, n2, eps=1e-9):
    """Darboux frame angles (alpha, phi, theta) of point pairs (batched)."""
    d = p2 - p1
    dist = torch.linalg.norm(d, dim=-1)
    dn = d / torch.clamp(dist, min=eps)[..., None]
    u = n1.expand(dn.shape)
    v = torch.linalg.cross(dn, u, dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * n2, dim=-1)                       # in [-1, 1]
    phi = torch.sum(u * dn, dim=-1)                         # in [-1, 1]
    theta = torch.arctan2(torch.sum(w * n2, dim=-1), torch.sum(u * n2, dim=-1))
    return alpha, phi, theta, dist


def _spfh(xyz: Tensor, normals: Tensor, nbr_idx: Tensor,
          nbr_valid: Tensor) -> Tensor:
    """Simplified point feature histograms (N, 33), each row normalised to
    a sum of 100.  A bin counts whole neighbours, so its float sum is exact
    in any order."""
    alpha, phi, theta, _ = _pair_features(xyz[:, None, :], normals[:, None, :],
                                          xyz[nbr_idx], normals[nbr_idx])
    wv = nbr_valid.to(xyz.dtype)

    def hist(vals, lo, hi):
        b = torch.clamp(((vals - lo) / (hi - lo) * N_BINS).to(torch.int32),
                        0, N_BINS - 1)
        onehot = torch.nn.functional.one_hot(b.long(), N_BINS).to(xyz.dtype)
        return torch.einsum("nkb,nk->nb", onehot, wv)

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)], dim=1)   # (N, 33)
    s = torch.clamp(torch.sum(h, dim=1, keepdim=True), min=1e-9)
    return h / s * 100.0


def fpfh(xyz: Tensor, mask: Tensor, grid: knn.HashGrid, k: int = 16,
         candidates_per_cell: int = 32, max_radius: float = math.inf
         ) -> Tensor:
    """(N, 33) FPFH: SPFH(p) + the distance-weighted mean of its
    neighbours' SPFHs, over a radius-capped support that excludes the point
    itself."""
    normals = estimate_normals(xyz, mask, grid, k, candidates_per_cell,
                               max_radius)
    res = knn.query(grid, xyz, mask, k=k,
                    candidates_per_cell=candidates_per_cell,
                    max_sqdist=float(max_radius) ** 2)
    # the self-neighbour's zero-length pair vector gives meaningless angles
    # and its 1/d weight would dominate the average
    nbr_ok = res.valid & (res.sqdist > 1e-12)
    nbr_idx = torch.where(nbr_ok, res.idx, 0).long()
    spfh = _spfh(xyz, normals, nbr_idx, nbr_ok)

    d = torch.sqrt(torch.clamp(res.sqdist, min=1e-12))
    wgt = torch.where(nbr_ok, 1.0 / torch.clamp(d, min=1e-3), 0.0)   # (N, k)
    acc = torch.einsum("nk,nkf->nf", wgt, spfh[nbr_idx])
    wsum = torch.clamp(torch.sum(wgt, dim=1, keepdim=True), min=1e-9)
    return torch.where(mask[:, None], spfh + acc / wsum, 0.0)


def mutual_correspondences(feat_a: Tensor, mask_a: Tensor, feat_b: Tensor,
                           mask_b: Tensor, max_pairs: int
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Mutual nearest neighbours in feature space (``Calibration.py:176-198``
    find_correspondences): (idx_a (P,), idx_b (P,), valid (P,)), the P
    best mutual pairs first.  The dense distance |a|^2 - 2ab + |b|^2 is one
    full-float32 matmul; the first minimum wins a row or column, and equal
    scores keep the lower row first (a stable sort, as ``lax.top_k``)."""
    d2 = (torch.sum(feat_a**2, dim=1)[:, None] - 2.0 * (feat_a @ feat_b.T)
          + torch.sum(feat_b**2, dim=1)[None, :])
    big = 1e18
    d2 = torch.where(mask_a[:, None] & mask_b[None, :], d2, big)
    rows = torch.arange(feat_a.shape[0], device=feat_a.device)
    a2b = torch.argmin(d2, dim=1)       # (Na,)
    b2a = torch.argmin(d2, dim=0)       # (Nb,)
    best = d2[rows, a2b]
    del d2
    mutual = (b2a[a2b] == rows) & mask_a & (best < big)
    score = torch.where(mutual, -best, -big)
    vals, sel = torch.sort(score, descending=True, stable=True)
    vals, sel = vals[:max_pairs], sel[:max_pairs]
    return sel, a2b[sel], vals > -big
