"""Master/slave multi-LiDAR calibration by ground alignment and a yaw search
(port of ``msst_tpu.models.calibration.auto_calib``).

Rebuild of ``Calibration_Tookit/SensorsCalibration/lidar2lidar/auto_calib``:

* RANSAC ground-plane extraction per cloud (``calibration.cpp:241-269``),
* roll/pitch from aligning the ground normals and z from the plane
  intercepts, with a flipped-normal retry when the z shift exceeds 0.5 m
  (:203-233),
* near-field ego-point removal (:96-163),
* a yaw search minimizing the summed NN distance of the non-ground points:
  the reference's coarse-to-fine halving (``registration_icp.cpp:49-101``)
  becomes 72 coarse and 64 fine yaw bins, each bin one launch of kernel B2
  over the slave's points,
* a final plane-to-plane ICP with the GICP solver (``RegistrationByICP2``
  :103-132).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ...ops import knn, ransac, registration, se3, voxel
from ...ops.numeric import hash3

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AutoCalibConfig:
    ground_ransac_iters: int = 300
    ground_threshold: float = 0.2
    ego_radius: float = 2.5            # near-field removal
    yaw_coarse_bins: int = 72          # 5-degree steps, like the coarse stage
    yaw_fine_bins: int = 64            # fine stage around the coarse best
    yaw_fine_halfwidth_deg: float = 5.0
    icp_iters: int = 30
    icp_max_corr: float = 1.0
    knn_table: int = 8192
    nn_candidates: int = 16


class AutoCalibResult(NamedTuple):
    pose: se3.Pose          # slave -> master
    ground_ok: Tensor
    yaw_cost: Tensor
    icp_rmse: Tensor


def _ground_align(m_xyz, m_mask, s_xyz, s_mask, cfg, generator) -> tuple:
    """Rotation and z shift that put the slave's ground plane onto the
    master's; the master's plane is fitted first, each fit drawing its
    hypotheses from `generator`."""
    fm = ransac.fit_plane_robust(m_xyz, m_mask, generator,
                                 cfg.ground_ransac_iters, cfg.ground_threshold)
    fs = ransac.fit_plane_robust(s_xyz, s_mask, generator,
                                 cfg.ground_ransac_iters, cfg.ground_threshold)
    up_m = fm.normal[2] < 0
    nm = torch.where(up_m, -fm.normal, fm.normal)
    dm = torch.where(up_m, -fm.d, fm.d)

    def align(ns, ds):
        # rotate the slave normal onto the master normal, then shift along
        # it by the offsets' difference
        axis = torch.linalg.cross(ns, nm, dim=-1)
        s = torch.linalg.norm(axis)
        c = torch.clamp(torch.dot(ns, nm), -1.0, 1.0)
        ang = torch.arctan2(s, c)
        q = se3.so3_exp_quat(torch.where(
            s < 1e-9, torch.zeros_like(axis),
            axis / torch.clamp(s, min=1e-9) * ang))
        return se3.Pose(q, nm * (ds - dm))

    # flipped-normal retry (calibration.cpp:218-233): a tilted sensor makes
    # the z > 0 sign heuristic ambiguous
    up_s = fs.normal[2] < 0
    ns = torch.where(up_s, -fs.normal, fs.normal)
    ds = torch.where(up_s, -fs.d, fs.d)
    pose_a = align(ns, ds)
    pose_b = align(-ns, -ds)
    use_b = torch.abs(pose_a.t[2]) > 0.5
    pose = se3.Pose(torch.where(use_b, pose_b.q, pose_a.q),
                    torch.where(use_b, pose_b.t, pose_a.t))
    return pose, nm, dm, fm.ok & fs.ok, fm.inlier_mask, fs.inlier_mask


def linspace_f32(start: Tensor, stop: Tensor, num: int,
                 endpoint: bool = True) -> Tensor:
    """``jnp.linspace``'s formula in float32: start * (1 - s) + stop * s
    with s = i / div, and `stop` itself last when endpoint (where XLA
    contracts the sum into an FMA the two differ by one ULP)."""
    div = num - 1 if endpoint else num
    step = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)]) if endpoint else out


def yaw_costs(grid: knn.HashGrid, s_lev: Tensor, s_ng: Tensor, nm: Tensor,
              yaws: Tensor, nn_candidates: int) -> Tensor:
    """Per yaw (about the master's ground normal `nm`), the summed distance
    of the non-ground slave points to their nearest master point, capped at
    2 m: one launch of kernel B2 a yaw."""
    costs = []
    for yaw in yaws:
        moved = se3.quat_rotate(se3.so3_exp_quat(nm * yaw), s_lev)
        res = knn.query(grid, moved, s_ng, k=1,
                        candidates_per_cell=nn_candidates, max_sqdist=4.0)
        d = torch.where(res.valid[:, 0], torch.sqrt(res.sqdist[:, 0]), 2.0)
        costs.append(torch.sum(torch.where(s_ng, d, 0.0)))
    return torch.stack(costs)


def auto_calibrate(m_xyz: Tensor, m_mask: Tensor, s_xyz: Tensor,
                   s_mask: Tensor, cfg: AutoCalibConfig,
                   generator: Optional[torch.Generator] = None,
                   init_pose: Optional[se3.Pose] = None) -> AutoCalibResult:
    """Slave -> master extrinsic.  init_pose: the rough extrinsic of the
    reference's ``initial_extrinsic.txt`` (``run_lidar2lidar.cpp:48-74``),
    mainly the lever arm; the yaw search resolves the rotation."""
    dev = m_xyz.device
    m_mask = m_mask & (torch.linalg.norm(m_xyz[:, :2], dim=1) > cfg.ego_radius)
    s_mask = s_mask & (torch.linalg.norm(s_xyz[:, :2], dim=1) > cfg.ego_radius)
    if init_pose is None:
        init_pose = se3.Pose.identity(device=dev)
    s_xyz = init_pose.apply(s_xyz)

    base, nm, _, ground_ok, m_ground, s_ground = _ground_align(
        m_xyz, m_mask, s_xyz, s_mask, cfg, generator)

    # the non-ground points search the yaw (:282: ground votes removed)
    m_ng = m_mask & ~m_ground
    s_ng = s_mask & ~s_ground
    s_lev = base.apply(s_xyz)
    grid = knn.build(m_xyz, m_ng, cell_size=2.0, table_size=cfg.knn_table)

    pi = torch.tensor(math.pi, dtype=torch.float32, device=dev)
    coarse = linspace_f32(-pi, pi, cfg.yaw_coarse_bins, endpoint=False)
    cc = yaw_costs(grid, s_lev, s_ng, nm, coarse, cfg.nn_candidates)
    y0 = coarse[torch.argmin(cc)]
    half = torch.tensor(math.radians(cfg.yaw_fine_halfwidth_deg),
                        dtype=torch.float32, device=dev)
    fine = y0 + linspace_f32(-half, half, cfg.yaw_fine_bins)
    fc = yaw_costs(grid, s_lev, s_ng, nm, fine, cfg.nn_candidates)
    y_best = fine[torch.argmin(fc)]
    pose0 = se3.Pose(se3.so3_exp_quat(nm * y_best),
                     torch.zeros(3, device=dev)).compose(base)

    # final refinement: plane-to-plane (covariance-weighted) ICP
    s_grid = knn.build(s_xyz, s_mask, cell_size=1.0, table_size=cfg.knn_table)
    m_grid = knn.build(m_xyz, m_mask, cell_size=1.0, table_size=cfg.knn_table)
    s_cov = registration.point_covariances(s_xyz, s_mask, s_grid, k=10)
    m_cov = registration.point_covariances(m_xyz, m_mask, m_grid, k=10)
    fine_res = registration.gicp(s_xyz, s_mask, s_cov, m_grid, m_xyz, m_cov,
                                 pose0, max_iters=cfg.icp_iters,
                                 max_corr_dist=cfg.icp_max_corr)
    # s_xyz was moved by init_pose first: compose it back in
    return AutoCalibResult(fine_res.pose.compose(init_pose), ground_ok,
                           torch.min(fc), fine_res.fitness)


def voxel_occupancy_score(m_xyz: Tensor, m_mask: Tensor, s_xyz: Tensor,
                          s_mask: Tensor, pose: se3.Pose,
                          voxel_size: float = 0.5,
                          table_size: int = 16384) -> Tensor:
    """Fraction of the moved slave points that land in master-occupied
    voxels (hashed), the octree occupancy metric of the lidar2lidar
    variant's ``RegistrationByVoxelOccupancy`` (``calibration.cpp:330``)."""
    h = hash3(voxel.voxel_coords(m_xyz, voxel_size), table_size).long()
    occ = torch.zeros(table_size + 1, dtype=torch.bool, device=m_xyz.device)
    occ[torch.where(m_mask, h, table_size)] = True
    hs = hash3(voxel.voxel_coords(pose.apply(s_xyz), voxel_size),
               table_size).long()
    hit = occ[:table_size][hs] & s_mask
    return torch.sum(hit.to(torch.int32)) / torch.clamp(
        torch.sum(s_mask.to(torch.int32)), min=1)


def refine_by_voxel_occupancy(m_xyz, m_mask, s_xyz, s_mask, pose: se3.Pose,
                              voxel_size: float = 0.5, delta: float = 0.05,
                              steps: int = 5) -> se3.Pose:
    """Coordinate-descent occupancy refinement over the translation, one
    axis at a time over 2 * steps + 1 offsets (the variant's final stage;
    the rotation is already ICP-refined).  The first best offset wins."""
    offsets = linspace_f32(
        torch.tensor(-delta * steps, dtype=torch.float32, device=m_xyz.device),
        torch.tensor(delta * steps, dtype=torch.float32, device=m_xyz.device),
        2 * steps + 1)
    for ax in range(3):
        e = torch.zeros(3, device=m_xyz.device)
        e[ax] = 1.0
        scores = torch.stack([
            voxel_occupancy_score(m_xyz, m_mask, s_xyz, s_mask,
                                  se3.Pose(pose.q, pose.t + e * o),
                                  voxel_size) for o in offsets])
        pose = se3.Pose(pose.q, pose.t + e * offsets[torch.argmax(scores)])
    return pose
