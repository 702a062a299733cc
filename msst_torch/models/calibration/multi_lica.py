"""Targetless multi-LiDAR -> LiDAR and LiDAR -> ground calibration (port of
``msst_tpu.models.calibration.multi_lica``).

Rebuild of ``Calibration_Tookit/Multi_LiCa`` (MFI 2024, DOI
10.1109/MFI62651.2024.10705773):

* per-source pipeline (``Calibration.py:95-345``): crop -> voxel downsample
  -> FPFH -> mutual-kNN correspondences -> GNC-TLS robust coarse init ->
  GICP fine refinement with a fitness gate;
* orchestration (``multi_lidar_calibrator.py:191-380``): each source against
  the target LiDAR with a retry against the combined cloud, or greedy
  fitness-based pairwise ordering;
* target-to-ground (``Lidar.calibrate_pitch`` ``Lidar.py:99-126``): RANSAC
  ground plane -> pitch/roll/z so the ground maps to z = 0.

Every k-NN of a pair (the FPFH support at k = 48, the covariances at
k = 16, GICP's correspondences at k = 1) is kernel B2 on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...ops import knn, ransac, registration, se3
from ...ops.pointcloud import Cloud, crop_box
from ...ops.voxel import voxel_downsample
from . import coarse as coarse_mod
from . import device as device_mod
from .features import fpfh, mutual_correspondences

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MultiLicaConfig:
    """Mirrors ``Multi_LiCa/config/params.yaml`` defaults."""

    voxel_size: float = 0.35           # TEASER stage voxel (Calibration.py:188)
    crop_lo: tuple = (-20.0, -20.0, -20.0)   # crop_cloud=20 cube (:406-408)
    crop_hi: tuple = (20.0, 20.0, 20.0)
    fpfh_k: int = 48
    # FPFH/normal support radius = factor * voxel (Open3D's hybrid search,
    # :413-420): a radius-capped support keeps the feature scale the same
    # across sensors; 4 * voxel is what the 27-cell probe covers exactly
    fpfh_radius_factor: float = 4.0
    max_corr: int = 1024
    gnc_noise_bound: float = 0.3
    gicp_max_iters: int = 50
    gicp_max_corr_dist: float = 1.0
    fitness_gate: float = 0.6          # the reference's retry threshold
    min_coarse_inliers: int = 50       # below this the FPFH coarse is noise
    capacity: int = 16384
    knn_table: int = 16384
    ground_ransac_iters: int = 300
    ground_threshold: float = 0.1


class PairResult(NamedTuple):
    pose: se3.Pose        # source -> target extrinsic
    fitness: Tensor       # GICP matched fraction
    rmse: Tensor
    coarse_inliers: Tensor


def _prep_stage(xyz, mask, cfg: MultiLicaConfig):
    cl = Cloud.create(xyz, mask=mask)
    cl = crop_box(cl, cfg.crop_lo, cfg.crop_hi)
    cl = voxel_downsample(cl, cfg.voxel_size, capacity=cfg.capacity)
    radius = cfg.fpfh_radius_factor * cfg.voxel_size
    grid = knn.build(cl.xyz, cl.mask, cell_size=radius,
                     table_size=cfg.knn_table)
    feat = fpfh(cl.xyz, cl.mask, grid, k=cfg.fpfh_k, candidates_per_cell=64,
                max_radius=radius)
    cov = registration.point_covariances(cl.xyz, cl.mask, grid, k=16)
    return cl, grid, feat, cov


def _coarse_stage(s_cl, t_cl, s_feat, t_feat, cfg: MultiLicaConfig):
    ia, ib, cval = mutual_correspondences(s_feat, s_cl.mask, t_feat,
                                          t_cl.mask, cfg.max_corr)
    return coarse_mod.gnc_tls_registration(
        s_cl.xyz[ia], t_cl.xyz[ib], cval, noise_bound=cfg.gnc_noise_bound)


def _fine_stage(s_cl, s_cov, t_grid, t_cl, t_cov, init_pose,
                cfg: MultiLicaConfig):
    return registration.gicp(
        s_cl.xyz, s_cl.mask, s_cov, t_grid, t_cl.xyz, t_cov, init_pose,
        max_iters=cfg.gicp_max_iters, max_corr_dist=cfg.gicp_max_corr_dist)


def calibrate_pair(src_xyz, src_mask, tgt_xyz, tgt_mask, cfg: MultiLicaConfig,
                   init: Optional[se3.Pose] = None,
                   generator: Optional[torch.Generator] = None) -> PairResult:
    """Coarse + fine calibration of one source cloud to a target cloud, on
    the inputs' device.

    Where the FPFH coarse stage starves (a planar scene makes FPFH
    non-discriminative) or the fine fitness stays below the gate, retry from
    :func:`auto_calib.auto_calibrate`'s ground-align + yaw-search pose
    (its RANSAC draws from `generator`, a generator seeded 0 by default)
    and keep the refinement that scores higher: the matched fraction less
    0.3 x the inlier RMSE, since a flipped pose can still match ~2/3 of the
    points through the ground plane."""
    s_cl, s_grid, s_feat, s_cov = _prep_stage(src_xyz, src_mask, cfg)
    t_cl, t_grid, t_feat, t_cov = _prep_stage(tgt_xyz, tgt_mask, cfg)
    co = _coarse_stage(s_cl, t_cl, s_feat, t_feat, cfg)
    init_pose = co.pose if init is None else init
    fine = _fine_stage(s_cl, s_cov, t_grid, t_cl, t_cov, init_pose, cfg)
    best = PairResult(fine.pose, fine.matched_frac, fine.fitness, co.n_inliers)
    starved = int(co.n_inliers) < cfg.min_coarse_inliers
    if init is None and (starved or float(best.fitness) < cfg.fitness_gate):
        from .auto_calib import AutoCalibConfig, auto_calibrate

        if generator is None:
            generator = torch.Generator(device=src_xyz.device).manual_seed(0)
        acfg = AutoCalibConfig(knn_table=cfg.knn_table)
        alt = auto_calibrate(t_cl.xyz, t_cl.mask, s_cl.xyz, s_cl.mask, acfg,
                             generator)
        fine2 = _fine_stage(s_cl, s_cov, t_grid, t_cl, t_cov, alt.pose, cfg)
        score1 = float(best.fitness) - 0.3 * float(best.rmse)
        score2 = float(fine2.matched_frac) - 0.3 * float(fine2.fitness)
        if score2 > score1:
            best = PairResult(fine2.pose, fine2.matched_frac, fine2.fitness,
                              co.n_inliers)
    return best


def calibrate_to_ground(xyz, mask, cfg: MultiLicaConfig,
                        generator: Optional[torch.Generator] = None
                        ) -> se3.Pose:
    """Pitch/roll/z so the dominant ground plane maps to z = 0
    (``Lidar.calibrate_pitch``), in closed form from the robust plane fit."""
    fit = ransac.fit_plane_robust(xyz, mask, generator,
                                  cfg.ground_ransac_iters, cfg.ground_threshold)
    down = fit.normal[2] < 0
    n = torch.where(down, -fit.normal, fit.normal)
    d = torch.where(down, -fit.d, fit.d)
    z = torch.tensor([0.0, 0.0, 1.0], device=xyz.device)
    axis = torch.linalg.cross(n, z, dim=-1)
    s = torch.linalg.norm(axis)
    angle = torch.arctan2(s, torch.clamp(torch.dot(n, z), -1.0, 1.0))
    axis = axis / torch.clamp(s, min=1e-9)
    q = se3.so3_exp_quat(torch.where(s < 1e-9, torch.zeros_like(axis),
                                     axis * angle))
    # after the rotation the plane is z + d = 0: shift up by d
    return se3.Pose(q, z * d)


def _numpy(x: Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class MultiLidarCalibrator:
    """Host orchestration (``multi_lidar_calibrator.py:191-380``) on
    `device`: the card unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: MultiLicaConfig = MultiLicaConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.device = device_mod.resolve(device)

    def _pad(self, xyz):
        return device_mod.pad(xyz, self.cfg.capacity, self.device)

    def _moved(self, pose: se3.Pose, xyz) -> np.ndarray:
        return _numpy(pose.apply(torch.from_numpy(
            np.asarray(xyz, np.float32)).to(self.device)))

    def standard_calibration(self, target_xyz: np.ndarray,
                             sources: Sequence[np.ndarray]):
        """Each source -> target; on a fitness below the gate, retry against
        the combined cloud of everything calibrated so far (:220-277)."""
        t_x, t_m = self._pad(target_xyz)
        combined = [np.asarray(target_xyz, np.float32)]
        results = []
        for s in sources:
            s_x, s_m = self._pad(s)
            res = calibrate_pair(s_x, s_m, t_x, t_m, self.cfg)
            if float(res.fitness) < self.cfg.fitness_gate:
                c_x, c_m = self._pad(np.concatenate(combined))
                res2 = calibrate_pair(s_x, s_m, c_x, c_m, self.cfg)
                if float(res2.fitness) > float(res.fitness):
                    res = res2
            results.append(res)
            combined.append(self._moved(res.pose, s))
        return results

    def save_results(self, directory: str, results, sources,
                     target_xyz: np.ndarray,
                     names: Optional[Sequence[str]] = None):
        """Write results.txt and the stitched cloud, like the reference's
        output stage (``multi_lidar_calibrator.py:430-478``)."""
        from ...utils.io_pcd import write_pcd

        os.makedirs(directory, exist_ok=True)
        lines = []
        stitched = [np.asarray(target_xyz, np.float32)]
        for i, (r, s) in enumerate(zip(results, sources)):
            name = names[i] if names else f"lidar_{i + 1}"
            T = _numpy(r.pose.to_matrix())
            lines.append(f"[{name}]")
            lines.append(f"fitness: {float(r.fitness):.4f}  rmse: "
                         f"{float(r.rmse):.4f}")
            lines.append("transformation:")
            for row in T:
                lines.append("  " + " ".join(f"{v: .6f}" for v in row))
            lines.append("")
            stitched.append(self._moved(r.pose, s))
        with open(os.path.join(directory, "results.txt"), "w") as f:
            f.write("\n".join(lines))
        write_pcd(os.path.join(directory, "stitched.pcd"),
                  np.concatenate(stitched))

    def fitness_based_calibration(self, clouds: Sequence[np.ndarray],
                                  target_index: int = 0):
        """Greedy best-fitness merge ordering (:285-380): calibrate the
        uncalibrated cloud with the best fitness against the combined
        calibrated set, again and again."""
        n = len(clouds)
        done = {target_index}
        poses: dict = {target_index: se3.Pose.identity(device=self.device)}
        combined = np.asarray(clouds[target_index], np.float32)
        fits: dict = {target_index: 1.0}
        while len(done) < n:
            best, best_res, best_fit = None, None, -1.0
            c_x, c_m = self._pad(combined)
            for i in range(n):
                if i in done:
                    continue
                s_x, s_m = self._pad(clouds[i])
                res = calibrate_pair(s_x, s_m, c_x, c_m, self.cfg)
                f = float(res.fitness)
                if f > best_fit:
                    best, best_res, best_fit = i, res, f
            done.add(best)
            poses[best] = best_res.pose
            fits[best] = best_fit
            combined = np.concatenate([combined,
                                       self._moved(best_res.pose, clouds[best])])
        return poses, fits
