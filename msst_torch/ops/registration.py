"""Scan-to-map Gauss-Newton against voxel feature maps (port of
``msst_tpu.ops.registration.scan_to_map_voxel``; the reference's
``scan2MapOptimization`` + ``LMOptimization``, ``mapOptmization.cpp:974-1310``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg, voxelmap

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
