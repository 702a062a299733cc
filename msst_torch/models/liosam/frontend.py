"""LIO-SAM front-end: deskew, range image, LOAM features (port of
``msst_tpu.models.liosam.frontend.run_frontend``; the reference's
``imageProjection`` + ``featureExtraction`` processes)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import features as F
from ...ops import range_image as ri
from ...ops import voxel
from ...ops.pointcloud import Cloud, compact

Tensor = torch.Tensor


class ScanInput(NamedTuple):
    """One raw LiDAR scan + its IMU window (fixed shapes).

    xyz (N, 3) sensor frame, mask (N,), ring (N,) int32, time (N,) firing
    offset from scan start [s], scan_start (), imu_t (T,), imu_gyro (T, 3),
    imu_acc (T, 3), imu_mask (T,), imu_rpy_init (3,) attitude hint at scan
    start (``imageProjection.cpp:329-330``), imu_available () bool.
    """

    xyz: Tensor
    mask: Tensor
    ring: Tensor
    time: Tensor
    scan_start: Tensor
    imu_t: Tensor
    imu_gyro: Tensor
    imu_acc: Tensor
    imu_mask: Tensor
    imu_rpy_init: Tensor
    imu_available: Tensor


class FrontendOutput(NamedTuple):
    corner: Cloud       # (scan_corner_cap,) deskewed scan-frame corners
    surf: Cloud         # (scan_surf_cap,) deskewed downsampled surface points
    n_corner: Tensor
    n_surf: Tensor


def run_frontend(scan: ScanInput, p) -> FrontendOutput:
    """Rotation deskew, projection, ring packing, features.  Each point's
    firing offset rides along as a 1-wide attr so it survives feature
    selection and downsampling (as the per-voxel mean): the estimator adds
    the translation deskew term to the features later."""
    imu_win = ri.ImuWindow(scan.imu_t, scan.imu_gyro, scan.imu_acc,
                           scan.imu_mask)
    times, rots = ri.imu_rotation_timeline(imu_win)
    n_imu = torch.sum(scan.imu_mask.to(torch.int32))
    deskewed = ri.deskew(scan.xyz, scan.scan_start + scan.time, times, rots,
                         n_imu, t_start=scan.scan_start,
                         enabled=scan.imu_available & (n_imu > 1))
    cloud = Cloud.create(deskewed, mask=scan.mask, attrs=scan.time[:, None])
    img = ri.project(cloud, scan.ring, p.n_scan, p.horizon_scan,
                     p.lidar_min_range, p.lidar_max_range, p.downsample_rate,
                     column_mode="counter" if p.sensor == "livox"
                     else "azimuth")
    return _loam_features(ri.extract_rings(img), p)


def _loam_features(ext: ri.ExtractedScan, p) -> FrontendOutput:
    """LOAM corner/surface selection over the packed rings + per-ring
    surface voxel downsample (``featureExtraction.cpp:226-236``)."""
    if p.feature_method != "nms":
        raise NotImplementedError(
            f"feature_method={p.feature_method!r}: only the NMS features are "
            "ported; the exact greedy variant is ROADMAP item L7")
    masks = F.extract_features_nms(ext, p.edge_threshold, p.surf_threshold)

    flat_xyz = ext.xyz.reshape(-1, 3)
    flat_attrs = ext.attrs.reshape(flat_xyz.shape[0], -1)
    ring_id = torch.arange(p.n_scan, dtype=torch.int32,
                           device=flat_xyz.device)[:, None].expand(
        masks.surface.shape).reshape(-1)
    corner = compact(Cloud(flat_xyz, masks.corner.reshape(-1), flat_attrs),
                     p.scan_corner_cap)
    surf = voxel.voxel_downsample(
        Cloud(flat_xyz, masks.surface.reshape(-1), flat_attrs),
        p.odometry_surf_leaf_size, capacity=p.scan_surf_cap,
        extra_key=ring_id)
    return FrontendOutput(corner, surf, corner.count, surf.count)
