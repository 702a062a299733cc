"""Scan-to-map Gauss-Newton (port of ``msst_tpu.ops.registration``'s
``scan_to_map_voxel`` and ``scan_to_map``; the reference's
``scan2MapOptimization`` + ``LMOptimization``, ``mapOptmization.cpp:974-1310``):
against voxel feature maps (one structured lookup an iteration), and the
reference-faithful form against 5-NN correspondences in the corner and surf
map hash grids.  And the loop closure's point-to-point ICP
(``icp_point2point_brute``) with its per-axis cost curvature
(``icp_curvature_brute``).  And the calibration tools' registrations:
GICP against regularized point covariances and NDT against a voxel
Gaussian map, each iteration's correspondences one launch of kernel B2.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import knn, linalg, se3, segments, voxel, voxelmap

Tensor = torch.Tensor

# Residual weight of surf cells reclassified as arc-lines (see
# voxelmap.build(plane_min_spread)); msst_tpu's value, kept identical.
ARC_LINE_WEIGHT = 0.35


def _rot_and_derivs(rpy: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """R = Rz Ry Rx and dR/droll, dR/dpitch, dR/dyaw (each 3x3)."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    o, z = torch.ones_like(r), torch.zeros_like(r)

    def m(*e):
        return torch.stack(e).reshape(3, 3)

    Rx = m(o, z, z, z, cr, -sr, z, sr, cr)
    Ry = m(cp, z, sp, z, o, z, -sp, z, cp)
    Rz = m(cy, -sy, z, sy, cy, z, z, z, o)
    dRx = m(z, z, z, z, -sr, -cr, z, cr, -sr)
    dRy = m(-sp, z, cp, z, z, z, -cp, z, -sp)
    dRz = m(-sy, -cy, z, cy, -sy, z, z, z, z)
    return Rz @ Ry @ Rx, Rz @ Ry @ dRx, Rz @ dRy @ Rx, dRz @ Ry @ Rx


class ScanToMapResult(NamedTuple):
    pose: Tensor        # (6,) roll,pitch,yaw,x,y,z
    degenerate: Tensor  # () bool
    converged: Tensor   # () bool
    iterations: Tensor  # () int32
    n_corner: Tensor    # () int32 inlier corners at the last iteration
    n_surf: Tensor      # () int32 inlier surfs


def scan_to_map_voxel(
    corner_scan: Tensor, corner_mask: Tensor,
    surf_scan: Tensor, surf_mask: Tensor,
    corner_vmap, surf_vmap,
    init_pose: Tensor,
    max_iters: int = 30,
    eig_threshold: float = 100.0,
    min_points: int = 50,
    plateau_rtol: float = 1e-3,
    plateau_min_iters: int = 2,
    reassoc_rot: float = 0.0,
    reassoc_trans: float = 0.0,
) -> ScanToMapResult:
    """Gauss-Newton on (roll, pitch, yaw, x, y, z) with point-to-line
    residuals for corners (and surf cells reclassified as lines) and
    point-to-plane residuals for surfaces, the s = 1 - 0.9|r| weights and
    pick gates, the eigenvalue degeneracy projection fixed on the first
    iteration (``LMOptimization`` :1232-1252), the reference's convergence
    gates (0.05 deg, 0.05 cm), and a stop when the mean squared residual
    plateaus.

    reassoc_rot/reassoc_trans > 0 freeze the correspondences: the lookup
    only re-runs once the pose moved more than the thresholds (max-abs rad
    / m) since the last lookup; 0/0 re-associates every iteration.

    The loop runs on the host: each iteration reads one small flag tensor
    (stop? and re-associate next?) back from the device, a known cost that
    a later kernel fusing the iteration removes."""
    Qc = corner_scan.shape[0]
    dev = init_pose.device
    pts = torch.cat([corner_scan, surf_scan])
    pmask = torch.cat([corner_mask, surf_mask])
    is_c = torch.arange(pts.shape[0], device=dev) < Qc
    rng_q = torch.linalg.norm(pts, dim=1)
    s_div = torch.sqrt(torch.sqrt(torch.clamp(rng_q, min=1e-6)))
    freeze = reassoc_rot > 0.0 or reassoc_trans > 0.0

    pose = init_pose
    P = torch.eye(6, device=dev)
    degenerate = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    prev_cost = torch.full((), torch.inf, device=dev)
    nc = ns = torch.zeros((), dtype=torch.int32, device=dev)
    hit = None
    pose_ref = init_pose
    need = True
    it = 0
    while it < max_iters:
        R, dRr, dRp, dRy = _rot_and_derivs(pose[:3])
        w = pts @ R.T + pose[3:]
        if need or not freeze:
            hit = voxelmap.lookup_cat(corner_vmap, surf_vmap, w, pmask, Qc)
            pose_ref = pose

        dnorm = torch.linalg.norm(hit.direction, dim=1)
        hit_is_line = dnorm < voxelmap.LINE_DIR_GATE
        v = hit.direction / torch.clamp(dnorm, min=1e-9)[:, None]
        use_line = is_c | hit_is_line
        delta = w - hit.mean
        along = torch.sum(delta * v, dim=1, keepdim=True)
        perp = delta - along * v
        rl = torch.linalg.norm(perp, dim=1)
        gradl = perp / torch.clamp(rl, min=1e-9)[:, None]
        rp = torch.sum(w * v, dim=1) + hit.d
        r = torch.where(use_line, rl, rp)
        n = torch.where(use_line[:, None], gradl, v)
        s = torch.where(is_c, 1.0 - 0.9 * torch.abs(r),
                        1.0 - 0.9 * torch.abs(r) / s_div)
        m = pmask & hit.found & (s > 0.1)
        s = torch.where(hit_is_line & ~is_c, ARC_LINE_WEIGHT * s, s)
        nw = n * s[:, None]
        jr = torch.stack([torch.sum(nw * (pts @ dR.T), dim=1)
                          for dR in (dRr, dRp, dRy)], dim=1)
        mf = m.to(pts.dtype)
        J = torch.cat([jr, nw], dim=1) * mf[:, None]
        rr = s * r * mf
        H = J.T @ J
        g = J.T @ rr
        n_sel = torch.sum(m.to(torch.int32))
        cost = (rr @ rr) / torch.clamp(n_sel, min=1)
        dx = -linalg.solve_psd(H, g, damping=1e-6)
        if it == 0:
            vals, vecs = torch.linalg.eigh(H)
            good = (vals >= eig_threshold).to(H.dtype)
            P = (vecs * good[None, :]) @ vecs.T
            degenerate = torch.any(vals < eig_threshold)
        dx = P @ dx
        enough = n_sel >= min_points
        dx = torch.where(enough, dx, 0.0)
        delta_r = torch.sqrt(torch.sum(torch.rad2deg(dx[:3]) ** 2))
        delta_t = torch.sqrt(torch.sum((dx[3:] * 100.0) ** 2))
        converged = (delta_r < 0.05) & (delta_t < 0.05)
        pose = pose + dx
        plateau = (it >= plateau_min_iters) & (prev_cost - cost
                                               < plateau_rtol * cost)
        done = converged | ~enough | plateau
        prev_cost = cost
        nc = torch.sum((m & is_c).to(torch.int32))
        ns = torch.sum((m & ~is_c).to(torch.int32))
        it += 1
        moved = ((torch.max(torch.abs(pose[:3] - pose_ref[:3])) > reassoc_rot)
                 | (torch.max(torch.abs(pose[3:] - pose_ref[3:]))
                    > reassoc_trans))
        stop, need = torch.stack([done, moved]).tolist()
        if stop:
            break
    return ScanToMapResult(pose, degenerate, done,
                           torch.tensor(it, dtype=torch.int32, device=dev),
                           nc, ns)


# ---------------------------------------------------------------------------
# Scan-to-map against 5-NN correspondences (the reference-faithful path)
# ---------------------------------------------------------------------------


def _corner_coeffs(
    p_world: Tensor, p_mask: Tensor, grid: knn.HashGrid, map_xyz: Tensor,
    candidates_per_cell: int,
) -> tuple[Tensor, Tensor, Tensor]:
    """Point-to-line residuals: (n (N, 3), d (N,), weight-gated mask (N,)).

    Mirrors ``cornerOptimization`` (:974-1064): 5-NN gated at sqdist < 1,
    line from the largest eigenvector of the neighbour covariance if
    lam_max > 3 * lam_mid, weight s = 1 - 0.9|d|, keep s > 0.1."""
    res = knn.query(grid, p_world, p_mask, k=5,
                    candidates_per_cell=candidates_per_cell)
    return _corner_from_knn(res, p_world, p_mask, map_xyz)


def _corner_from_knn(res: knn.KnnResult, p_world: Tensor, p_mask: Tensor,
                     map_xyz: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`_corner_coeffs` after its 5-NN query `res`."""
    ok = p_mask & torch.all(res.valid, dim=1) & (res.sqdist[:, 4] < 1.0)
    nbrs = map_xyz[res.idx.long()]               # (N, 5, 3)
    c = torch.mean(nbrs, dim=1)
    dev = nbrs - c[:, None, :]
    cov = torch.einsum("nki,nkj->nij", dev, dev) / 5.0
    vals, vecs = linalg.sym3x3_eigh(cov)
    line_ok = vals[:, 2] > 3.0 * vals[:, 1]
    v = vecs[:, 2, :]                            # line direction
    delta = p_world - c
    along = torch.sum(delta * v, dim=1, keepdim=True)
    perp = delta - along * v
    d = torch.linalg.norm(perp, dim=1)
    n = perp / torch.clamp(d, min=1e-9)[:, None]  # unit gradient of d wrt point
    s = 1.0 - 0.9 * torch.abs(d)
    keep = ok & line_ok & (s > 0.1)
    return n * s[:, None], s * d, keep


def _surf_coeffs(
    p_world: Tensor, p_scan: Tensor, p_mask: Tensor, grid: knn.HashGrid,
    map_xyz: Tensor, candidates_per_cell: int,
) -> tuple[Tensor, Tensor, Tensor]:
    """Point-to-plane residuals, mirroring ``surfOptimization``
    (:1066-1135): plane through the 5 neighbours, valid if |n.x + d| <= 0.2
    for all 5, weight s = 1 - 0.9|pd| / sqrt(sqrt(|p_scan|)).

    As in msst_tpu the plane is the total-least-squares fit (centroid +
    smallest covariance eigenvector), not the reference's algebraic fit,
    which is singular for planes through the origin."""
    res = knn.query(grid, p_world, p_mask, k=5,
                    candidates_per_cell=candidates_per_cell)
    return _surf_from_knn(res, p_world, p_scan, p_mask, map_xyz)


def _surf_from_knn(res: knn.KnnResult, p_world: Tensor, p_scan: Tensor,
                   p_mask: Tensor, map_xyz: Tensor
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`_surf_coeffs` after its 5-NN query `res`."""
    ok = p_mask & torch.all(res.valid, dim=1) & (res.sqdist[:, 4] < 1.0)
    nbrs = map_xyz[res.idx.long()]
    c = torch.mean(nbrs, dim=1)
    dev = nbrs - c[:, None, :]
    cov = torch.einsum("nki,nkj->nij", dev, dev)
    _, vecs = linalg.sym3x3_eigh(cov)
    n = vecs[:, 0, :]                            # smallest-eigenvector normal
    d0 = -torch.sum(n * c, dim=1)
    fit_err = torch.abs(torch.einsum("nki,ni->nk", nbrs, n) + d0[:, None])
    plane_ok = torch.all(fit_err <= 0.2, dim=1)
    pd = torch.sum(p_world * n, dim=1) + d0
    rng = torch.linalg.norm(p_scan, dim=1)
    s = 1.0 - 0.9 * torch.abs(pd) / torch.sqrt(torch.sqrt(
        torch.clamp(rng, min=1e-6)))
    keep = ok & plane_ok & (s > 0.1)
    return n * s[:, None], s * pd, keep


def scan_to_map(
    corner_scan: Tensor, corner_mask: Tensor,
    surf_scan: Tensor, surf_mask: Tensor,
    corner_grid: knn.HashGrid, corner_map_xyz: Tensor,
    surf_grid: knn.HashGrid, surf_map_xyz: Tensor,
    init_pose: Tensor,
    max_iters: int = 30,
    eig_threshold: float = 100.0,
    min_points: int = 50,
    candidates_per_cell: int = 24,
) -> ScanToMapResult:
    """LOAM scan-to-map Gauss-Newton on (roll, pitch, yaw, x, y, z): each
    iteration the corners' and the surfs' 5-NN in one query
    (``knn.query_cat``: one launch of the CUDA kernel on a CUDA tensor), the
    line and plane coefficients, a damped 6x6 solve, the eigenvalue
    degeneracy projection fixed on the first iteration, and the reference's
    convergence gates (0.05 deg, 0.05 cm).

    The loop runs on the host and reads one stop flag back from the device
    each iteration, like :func:`scan_to_map_voxel`."""
    dev = init_pose.device
    pose = init_pose
    P = torch.eye(6, device=dev)
    degenerate = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    nc = ns = torch.zeros((), dtype=torch.int32, device=dev)
    Qc = corner_scan.shape[0]
    scan_pts = torch.cat([corner_scan, surf_scan])
    scan_mask = torch.cat([corner_mask, surf_mask])

    def jac(n, pts, m, dRs):
        jr = torch.stack([torch.sum(n * (pts @ dR.T), dim=1) for dR in dRs],
                         dim=1)
        return torch.cat([jr, n], dim=1) * m[:, None]

    it = 0
    while it < max_iters:
        R, *dRs = _rot_and_derivs(pose[:3])
        w = scan_pts @ R.T + pose[3:]
        res = knn.query_cat(corner_grid, surf_grid, w, scan_mask, Qc, k=5,
                            candidates_per_cell=candidates_per_cell)
        cn, cd, cm = _corner_from_knn(
            knn.KnnResult(*(f[:Qc] for f in res)), w[:Qc], corner_mask,
            corner_map_xyz)
        sn, sd, sm = _surf_from_knn(
            knn.KnnResult(*(f[Qc:] for f in res)), w[Qc:], surf_scan,
            surf_mask, surf_map_xyz)
        cmf, smf = cm.to(pose.dtype), sm.to(pose.dtype)
        Jc = jac(cn, corner_scan, cmf, dRs)
        Js = jac(sn, surf_scan, smf, dRs)
        H = Jc.T @ Jc + Js.T @ Js
        g = Jc.T @ (cd * cmf) + Js.T @ (sd * smf)
        nc = torch.sum(cm.to(torch.int32))
        ns = torch.sum(sm.to(torch.int32))
        dx = -linalg.solve_psd(H, g, damping=1e-6)
        if it == 0:
            # degeneracy analysis on the first iteration (:1232-1252)
            vals, vecs = torch.linalg.eigh(H)
            good = (vals >= eig_threshold).to(H.dtype)
            P = (vecs * good[None, :]) @ vecs.T
            degenerate = torch.any(vals < eig_threshold)
        dx = P @ dx
        enough = (nc + ns) >= min_points
        dx = torch.where(enough, dx, 0.0)
        delta_r = torch.sqrt(torch.sum(torch.rad2deg(dx[:3]) ** 2))
        delta_t = torch.sqrt(torch.sum((dx[3:] * 100.0) ** 2))
        pose = pose + dx
        done = ((delta_r < 0.05) & (delta_t < 0.05)) | ~enough
        it += 1
        if bool(done):
            break
    return ScanToMapResult(pose, degenerate, done,
                           torch.tensor(it, dtype=torch.int32, device=dev),
                           nc, ns)


# ---------------------------------------------------------------------------
# Point-to-point ICP (loop closure)
# ---------------------------------------------------------------------------


class IcpResult(NamedTuple):
    pose: se3.Pose      # source -> target
    fitness: Tensor     # mean sq distance of matched points (PCL getFitnessScore)
    matched_frac: Tensor
    converged: Tensor
    iters: Tensor       # () int32 iterations run


def icp_point2point_brute(
    src_xyz: Tensor, src_mask: Tensor,
    tgt_xyz: Tensor, tgt_mask: Tensor,
    init_pose: se3.Pose,
    max_iters: int = 100,
    max_corr_dist: float = 2.0,
    fitness_max_dist: float = math.inf,
    transformation_eps: float = 1e-6,
    rel_mse_eps: float = 1e-5,
    abs_mse_eps: float = 1e-12,
    chunk: int = 8192,
) -> IcpResult:
    """SVD-based rigid ICP with pcl::IterativeClosestPoint semantics
    (msst_tpu's ``icp_point2point_brute``): each iteration exact 1-NN
    correspondences within `max_corr_dist` by the dense sweep
    (:func:`knn.nearest1_brute`), a weighted Kabsch update, and PCL's
    DefaultConvergenceCriteria as the stop: the iteration cap, transform
    similarity (update translation^2 < `transformation_eps` and rotation
    cos(angle) > 1 - `transformation_eps`), the correspondence MSE below
    `abs_mse_eps` or changed by less than `rel_mse_eps` of its previous
    value, or no matches.  `converged` is PCL's ``hasConverged()``:
    correspondences existed (the cap is a valid stop); fitness is the
    caller's gate, as in ``performLoopClosure`` (mapOptmization.cpp:575-580).

    The loop runs on the host and reads one stop flag back from the device
    each iteration, like :func:`scan_to_map_voxel`."""

    def nn1(moved, max_sq):
        res = knn.nearest1_brute(tgt_xyz, tgt_mask, moved, src_mask,
                                 chunk=chunk)
        return res._replace(valid=res.valid & (res.sqdist <= max_sq))

    return _icp_run(src_xyz, src_mask, nn1, tgt_xyz, init_pose, max_iters,
                    max_corr_dist, fitness_max_dist, transformation_eps,
                    rel_mse_eps, abs_mse_eps)


def _icp_run(src_xyz, src_mask, nn1, tgt_xyz, init_pose, max_iters,
             max_corr_dist, fitness_max_dist, transformation_eps,
             rel_mse_eps, abs_mse_eps) -> IcpResult:
    dev = src_xyz.device
    pose = init_pose
    mse = torch.full((), torch.inf, device=dev)
    it = 0
    while True:
        moved = pose.apply(src_xyz)
        res = nn1(moved, max_corr_dist * max_corr_dist)
        ok = res.valid[:, 0] & src_mask
        w = ok.to(src_xyz.dtype)
        nmatch = torch.sum(w)
        prev_mse = mse
        mse = torch.sum(torch.where(ok, res.sqdist[:, 0], 0.0)) / torch.clamp(
            nmatch, min=1.0)
        dst = tgt_xyz[res.idx[:, 0].long()]
        R, t = linalg.weighted_kabsch(moved, dst, w)
        pose = se3.Pose(se3.matrix_to_quat(R), t).compose(pose)
        it += 1
        # PCL's update magnitude: translation^2 and rotation cos(angle)
        similar = (torch.sum(t * t) < transformation_eps) & (
            0.5 * (torch.trace(R) - 1.0) > 1.0 - transformation_eps)
        mse_stop = (mse < abs_mse_eps) | (
            torch.abs(prev_mse - mse) < rel_mse_eps * prev_mse)
        if it >= max_iters or bool(similar | mse_stop | (nmatch <= 0)):
            break

    moved = pose.apply(src_xyz)
    res = nn1(moved, min(fitness_max_dist ** 2, 1e18))
    ok = res.valid[:, 0] & src_mask
    n_ok = torch.sum(ok.to(torch.int32))
    nm = torch.clamp(n_ok, min=1)
    fitness = torch.sum(torch.where(ok, res.sqdist[:, 0], 0.0)) / nm
    frac = nm / torch.clamp(torch.sum(src_mask.to(torch.int32)), min=1)
    return IcpResult(pose, fitness, frac, n_ok > 0,
                     torch.tensor(it, dtype=torch.int32, device=dev))


def icp_curvature_brute(
    src_xyz: Tensor, src_mask: Tensor,
    tgt_xyz: Tensor, tgt_mask: Tensor,
    pose: se3.Pose,
    max_corr_dist: float = 2.0,
    delta_t: float = 1.5,
    delta_r: float = 0.1,
    chunk: int = 8192,
) -> tuple[Tensor, Tensor]:
    """Per-axis curvature of the ICP cost around a converged `pose`
    (msst_tpu's ``icp_curvature_brute``): ``(kappa, c0)`` with kappa (6,) =
    [rot x,y,z, trans x,y,z] central second differences of the mean squared
    NN distance, each probe re-associating its correspondences, so that a
    corridor match sliding along its axis reads near zero there.

    Rotation probes are conjugated about the moved cloud's centroid
    (``x' = R_dq (x - c) + c``), so kappa does not depend on the scene's
    distance from the origin.  A probe that loses every correspondence
    costs the saturated ``max_corr_dist**2``, not 0.  The 13 sweeps run one
    after another, one sweep's memory at a time."""
    max_sq = max_corr_dist * max_corr_dist
    dev = src_xyz.device

    def cost(p):
        res = knn.nearest1_brute(tgt_xyz, tgt_mask, p.apply(src_xyz),
                                 src_mask, chunk=chunk)
        ok = res.valid[:, 0] & src_mask & (res.sqdist[:, 0] <= max_sq)
        n_ok = torch.sum(ok.to(torch.int32))
        mean = torch.sum(torch.where(ok, res.sqdist[:, 0], 0.0)) / torch.clamp(
            n_ok, min=1)
        return torch.where(n_ok == 0, max_sq, mean)

    c0 = cost(pose)
    w = src_mask.to(src_xyz.dtype)
    center = (torch.sum(pose.apply(src_xyz) * w[:, None], dim=0)
              / torch.clamp(torch.sum(w), min=1.0))
    zero3 = torch.zeros(3, device=dev)

    def perturb(i, sign):
        rot = i < 3
        e = torch.zeros(3, device=dev)
        e[i % 3] = sign * (delta_r if rot else delta_t)
        dq = se3.so3_exp_quat(e if rot else zero3)
        c = center if rot else zero3
        return se3.Pose(se3.quat_mul(dq, pose.q),
                        se3.quat_rotate(dq, pose.t - c) + c
                        + (zero3 if rot else e))

    kappa = []
    for i in range(6):
        d = delta_r if i < 3 else delta_t
        kappa.append((cost(perturb(i, 1.0)) + cost(perturb(i, -1.0))
                       - 2.0 * c0) / (d * d))
    return torch.stack(kappa), c0


# ---------------------------------------------------------------------------
# GICP (plane-to-plane, covariance-weighted)
# ---------------------------------------------------------------------------


def point_covariances(xyz: Tensor, mask: Tensor, grid: knn.HashGrid,
                      k: int = 10, epsilon: float = 1e-3,
                      candidates_per_cell: int = 24) -> Tensor:
    """GICP-regularized per-point covariances (N, 3, 3): the k-NN scatter's
    eigenvalues replaced by (eps, 1, 1) (Segal et al.), as Open3D does for
    Multi_LiCa's GICP (``Calibration.py:292-345``).  `grid` is built over
    `xyz` itself; its k-NN is kernel B2."""
    res = knn.query(grid, xyz, mask, k=k,
                    candidates_per_cell=candidates_per_cell)
    nbrs = xyz[res.idx.long()]                              # (N, k, 3)
    w = res.valid.to(xyz.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mu = torch.sum(nbrs * w, dim=1) / cnt
    dev = (nbrs - mu[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", dev, dev) / cnt[..., None]
    _, vecs = linalg.sym3x3_eigh(cov)
    new_vals = torch.tensor([epsilon, 1.0, 1.0], dtype=xyz.dtype,
                            device=xyz.device)
    return torch.einsum("nki,k,nkj->nij", vecs, new_vals, vecs)


class GicpResult(NamedTuple):
    pose: se3.Pose
    fitness: Tensor       # inlier RMSE (msst_tpu's field name)
    matched_frac: Tensor  # matched fraction of the source
    converged: Tensor     # iterations < max_iters
    iters: Optional[Tensor] = None   # () int32 iterations run (the port's)


def _gn_pose_update(moved: Tensor, r: Tensor, M: Tensor, w: Tensor,
                    pose: se3.Pose, damping: float, step: float
                    ) -> tuple[se3.Pose, Tensor]:
    """One left-perturbation Gauss-Newton update on sum w r^T M r with
    J = [-skew(moved) | I]: the new pose and |dx|^2."""
    Jr = -se3.skew(moved)
    eye = torch.eye(3, dtype=moved.dtype, device=moved.device).expand(Jr.shape)
    J = torch.cat([Jr, eye], dim=2)                         # (N, 3, 6)
    MJ = M @ J
    H = torch.einsum("nik,nij,n->kj", J, MJ, w)
    g = torch.einsum("nik,ni,n->k", MJ, r, w)
    dx = -step * linalg.solve_psd(H, g, damping=damping)
    dq = se3.so3_exp_quat(dx[:3])
    new_pose = se3.Pose(se3.quat_normalize(se3.quat_mul(dq, pose.q)),
                        se3.quat_rotate(dq, pose.t) + dx[3:])
    return new_pose, torch.sum(dx * dx)


def gicp(src_xyz: Tensor, src_mask: Tensor, src_cov: Tensor,
         tgt_grid: knn.HashGrid, tgt_xyz: Tensor, tgt_cov: Tensor,
         init_pose: se3.Pose, max_iters: int = 50,
         max_corr_dist: float = 1.0, transformation_eps: float = 1e-8,
         candidates_per_cell: int = 16) -> GicpResult:
    """Generalized ICP (msst_tpu's ``gicp``): Gauss-Newton on
    sum r^T (Cq + R Cp R^T)^-1 r with left-perturbation se(3) updates, each
    iteration's 1-NN correspondences one launch of kernel B2.  The loop runs
    on the host and reads one stop flag (|dx|^2 > eps) an iteration, as
    msst_tpu's ``lax.while_loop`` tests it."""
    max_sq = max_corr_dist * max_corr_dist
    pose, it = init_pose, 0
    while it < max_iters:
        R = se3.quat_to_matrix(pose.q)
        moved = pose.apply(src_xyz)
        res = knn.query(tgt_grid, moved, src_mask, k=1,
                        candidates_per_cell=candidates_per_cell,
                        max_sqdist=max_sq)
        ok = res.valid[:, 0] & src_mask
        j = res.idx[:, 0].long()
        M = linalg.inv3x3(tgt_cov[j] + R @ src_cov @ R.T)
        pose, delta = _gn_pose_update(moved, moved - tgt_xyz[j], M,
                                      ok.to(src_xyz.dtype), pose, 1e-6, 1.0)
        it += 1
        if not bool(delta > transformation_eps):
            break

    moved = pose.apply(src_xyz)
    res = knn.query(tgt_grid, moved, src_mask, k=1,
                    candidates_per_cell=candidates_per_cell, max_sqdist=max_sq)
    ok = res.valid[:, 0] & src_mask
    n_ok = torch.sum(ok.to(torch.int32))
    frac = n_ok / torch.clamp(torch.sum(src_mask.to(torch.int32)), min=1)
    rmse = torch.sqrt(torch.sum(torch.where(ok, res.sqdist[:, 0], 0.0))
                      / torch.clamp(n_ok, min=1))
    return GicpResult(pose, rmse, frac,
                      torch.tensor(it < max_iters, device=src_xyz.device),
                      torch.tensor(it, dtype=torch.int32,
                                   device=src_xyz.device))


# ---------------------------------------------------------------------------
# NDT (point-to-distribution, voxel Gaussian map)
# ---------------------------------------------------------------------------


class NdtMap(NamedTuple):
    means: Tensor     # (V, 3)
    inv_cov: Tensor   # (V, 3, 3)
    mask: Tensor      # (V,)
    grid: knn.HashGrid  # over means, cell = resolution


_BIG_CELL = 2**30
_SYM_IU, _SYM_JU = (0, 0, 0, 1, 1, 2), (0, 1, 2, 1, 2, 2)
_SYM_FULL = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def build_ndt_map(xyz: Tensor, mask: Tensor, resolution: float,
                  capacity: int, min_points: int = 5,
                  table_size: int = 8192) -> NdtMap:
    """Voxelize the target into per-cell Gaussians (mean + regularized
    covariance), like ``pcl::NormalDistributionsTransform``'s target grid.

    The voxels' moments are sums of positions minus their cell centre, as
    msst_tpu's; each voxel's rows are added in row order
    (``segments.segment_sum``), where msst_tpu differences float32 prefix
    sums over the whole sorted cloud."""
    c = voxel.voxel_coords(xyz, resolution)
    cx, cy, cz = (torch.where(mask, c[:, i], _BIG_CELL) for i in range(3))
    order = voxel._stable_order(cx, cy, cz)
    cell_s = torch.stack([cx[order], cy[order], cz[order]], dim=1)
    valid_s = mask[order]
    xyz_s = xyz[order]
    new_voxel = torch.any(cell_s != torch.roll(cell_s, 1, dims=0), dim=1)
    new_voxel[0] = True
    new_voxel = new_voxel & valid_s
    seg = torch.cumsum(new_voxel.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, capacity)
    w = valid_s.to(xyz.dtype)
    lo, _ = segments.segment_boundaries(seg, capacity)
    center_s = (cell_s.to(xyz.dtype) + 0.5) * resolution
    r_s = (xyz_s - center_s) * w[:, None]
    outer6 = r_s[:, _SYM_IU] * r_s[:, _SYM_JU]
    moments = segments.segment_sum(
        torch.cat([r_s, outer6, w[:, None]], dim=1), seg, capacity)
    rsums, sq6, cnt = moments[:, :3], moments[:, 3:9], moments[:, 9]
    # an empty voxel takes the row its (empty) run starts at, as msst_tpu's
    cell_v = cell_s[torch.clamp(lo, max=cell_s.shape[0] - 1)]
    denom = torch.clamp(cnt, min=1.0)
    rmu = rsums / denom[:, None]
    mu = (cell_v.to(xyz.dtype) + 0.5) * resolution + rmu
    sq = sq6[:, _SYM_FULL].reshape(capacity, 3, 3)
    cov = sq / denom[:, None, None] - torch.einsum("ni,nj->nij", rmu, rmu)
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    # sensor-noise floor before the eigenvalue clamp (1 % of the cell): a
    # cell of coplanar points would otherwise get a ~1e6 inverse
    cov = cov + (0.01 * resolution) ** 2 * eye
    # Magnusson regularization: eigenvalues at least 1e-2 of the largest
    vals, vecs = linalg.sym3x3_eigh(cov)
    lam_max = torch.clamp(vals[:, 2], min=1e-6)
    vals = torch.maximum(vals, 0.01 * lam_max[:, None])
    cov = torch.einsum("nki,nk,nkj->nij", vecs, vals, vecs)
    ok = cnt >= min_points
    inv_cov = linalg.inv3x3(cov + 1e-6 * eye)
    grid = knn.build(mu, ok, cell_size=resolution, table_size=table_size)
    return NdtMap(mu, inv_cov, ok, grid)


class NdtResult(NamedTuple):
    pose: se3.Pose
    score: Tensor
    converged: Tensor
    iters: Optional[Tensor] = None   # () int32 iterations run (the port's)


def ndt(src_xyz: Tensor, src_mask: Tensor, ndt_map: NdtMap,
        init_pose: se3.Pose, max_iters: int = 35, resolution: float = 1.0,
        transformation_eps: float = 1e-8, step_size: float = 1.0,
        candidates_per_cell: int = 8) -> NdtResult:
    """Gauss-Newton NDT (msst_tpu's ``ndt``): each source point is matched
    to the nearest voxel Gaussian within 1.5 resolutions (one launch of
    kernel B2) and pulled toward its mean under the voxel's inverse
    covariance.  A host loop reading one stop flag an iteration."""
    max_sq = resolution * resolution * 2.25
    pose, it = init_pose, 0
    while it < max_iters:
        moved = pose.apply(src_xyz)
        res = knn.query(ndt_map.grid, moved, src_mask, k=1,
                        candidates_per_cell=candidates_per_cell,
                        max_sqdist=max_sq)
        j = res.idx[:, 0].long()
        ok = res.valid[:, 0] & src_mask & ndt_map.mask[j]
        pose, delta = _gn_pose_update(moved, moved - ndt_map.means[j],
                                      ndt_map.inv_cov[j],
                                      ok.to(src_xyz.dtype), pose, 1e-4,
                                      step_size)
        it += 1
        if not bool(delta > transformation_eps):
            break

    moved = pose.apply(src_xyz)
    res = knn.query(ndt_map.grid, moved, src_mask, k=1,
                    candidates_per_cell=candidates_per_cell, max_sqdist=max_sq)
    ok = res.valid[:, 0] & src_mask
    j = res.idx[:, 0].long()
    r = moved - ndt_map.means[j]
    mahal = torch.einsum("ni,nij,nj->n", r, ndt_map.inv_cov[j], r)
    score = torch.sum(torch.where(ok, torch.exp(-0.5 * mahal), 0.0)) / \
        torch.clamp(torch.sum(src_mask.to(torch.int32)), min=1)
    return NdtResult(pose, score,
                     torch.tensor(it < max_iters, device=src_xyz.device),
                     torch.tensor(it, dtype=torch.int32,
                                  device=src_xyz.device))
