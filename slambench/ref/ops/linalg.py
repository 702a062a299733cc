# Frozen copy of msst_torch/ops/linalg.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
"""Small batched linear algebra (port of ``msst_tpu.ops.linalg``): the
closed-form symmetric 3x3 eigendecomposition the voxel-feature fit runs over
every map cell, the adjugate 3x3 inverse of GICP's and NDT's per-point
information matrices, the damped Cholesky solve of the 6x6 Gauss-Newton
normal equations, and the weighted Kabsch fit of the ICP update."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def sym3x3_eigvals(A: Tensor) -> Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending — trigonometric method
    (Smith's algorithm), branch-free and batched."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = 0.5 * (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    half_det = torch.clamp(half_det, -1.0, 1.0)
    phi = torch.arccos(half_det) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    # degenerate (p ~ 0): all eigenvalues == q
    tiny = p2 < 1e-24
    e_lo = torch.where(tiny, q, e_lo)
    e_mid = torch.where(tiny, q, e_mid)
    e_hi = torch.where(tiny, q, e_hi)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _eigvec_with_quality(A: Tensor, lam: Tensor, eps: float = 1e-12
                         ) -> tuple[Tensor, Tensor]:
    """(unit eigenvector, well-defined?) for eigenvalue lam via the largest
    cross-product of rows of (A - lam I); ill-defined when lam is a repeated
    root (all cross-products collapse relative to ||B||_F^2)."""
    B = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
    n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
    n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
    v = torch.where(n01 >= torch.maximum(n02, n12), c01,
                    torch.where(n02 >= n12, c02, c12))
    n = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps)
    s2 = torch.sum(B * B, dim=(-2, -1))
    qual = torch.maximum(torch.maximum(n01, n02), n12)[..., 0]
    good = qual > 1e-10 * s2 * s2 + 1e-30
    return v / torch.sqrt(n), good


def _perp_of(g: Tensor) -> Tensor:
    """A unit vector perpendicular to unit-ish g."""
    ax = torch.argmin(torch.abs(g), dim=-1)
    e = torch.nn.functional.one_hot(ax, 3).to(g.dtype)
    w = torch.linalg.cross(g, e, dim=-1)
    return w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-12)


def sym3x3_eigh(A: Tensor) -> tuple[Tensor, Tensor]:
    """(eigvals ascending (..., 3), eigvecs (..., 3, 3) with vecs in rows).

    Closed form, batched, robust to repeated eigenvalues: an ill-defined
    vector is replaced by a unit perpendicular of the well-defined one (or a
    fixed frame when the spectrum is fully degenerate); healthy inputs keep
    the plain closed form."""
    vals = sym3x3_eigvals(A)
    v_hi, hi_ok = _eigvec_with_quality(A, vals[..., 2])
    v_lo, lo_ok = _eigvec_with_quality(A, vals[..., 0])
    e_x = torch.zeros_like(v_hi)
    e_x[..., 0] = 1.0
    e_z = torch.zeros_like(v_hi)
    e_z[..., 2] = 1.0
    both_bad = (~hi_ok & ~lo_ok)[..., None]
    v_hi2 = torch.where(both_bad, e_z,
                        torch.where(hi_ok[..., None], v_hi, _perp_of(v_lo)))
    v_lo2 = torch.where(both_bad, e_x,
                        torch.where(lo_ok[..., None], v_lo, _perp_of(v_hi2)))
    v_mid = torch.linalg.cross(v_hi2, v_lo2, dim=-1)
    v_mid = v_mid / torch.clamp(torch.linalg.norm(v_mid, dim=-1, keepdim=True),
                                min=1e-12)
    return vals, torch.stack([v_lo2, v_mid, v_hi2], dim=-2)


def solve_psd(A: Tensor, b: Tensor, damping: float = 0.0) -> Tensor:
    """Solve small dense PSD systems (the 6x6 normal equations of
    ``LMOptimization``) by Cholesky with optional LM damping.  Uses the
    ``_ex`` factorization, which reports failure in a tensor instead of
    synchronizing with the device to raise."""
    n = A.shape[-1]
    A = A + damping * torch.eye(n, dtype=A.dtype, device=A.device)
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def weighted_kabsch(src: Tensor, dst: Tensor, w: Tensor
                    ) -> tuple[Tensor, Tensor]:
    """Best-fit rigid transform (R, t) minimizing sum w |R src + t - dst|^2
    (src, dst (N, 3), w (N,) non-negative): the weighted 3x3
    cross-covariance in full f32 (TF32 is off package-wide, the counterpart
    of msst_tpu's HIGHEST precision: TF32 noise here jitters the ICP update
    above its 1e-6 transform epsilon), its SVD, and the det sign
    correction."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    H = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    return R, mu_d - R @ mu_s
