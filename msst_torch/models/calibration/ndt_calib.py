"""Online NDT parent/child calibrator (port of
``msst_tpu.models.calibration.ndt_calib``).

Rebuild of ``Calibration_Tookit/multi_lidar`` (``multi_lidar_calibrator.cpp``):
synced parent/child cloud pairs, the child voxel-downsampled (:113-121),
NDT-aligned from an initial guess (:28-63), each result fed back as the next
frame's guess (:72) so that the estimate tracks over frames.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import registration, se3
from ...ops.pointcloud import Cloud
from ...ops.voxel import voxel_downsample
from . import device as device_mod

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NdtCalibConfig:
    resolution: float = 1.0
    child_leaf: float = 0.2          # voxel_size param
    max_iters: int = 35
    step_size: float = 1.0
    map_capacity: int = 8192
    child_capacity: int = 16384


class NdtCalibResult(NamedTuple):
    pose: se3.Pose
    score: Tensor
    converged: Tensor
    iters: Optional[Tensor] = None   # () int32 NDT iterations (the port's)


def ndt_calibrate_frame(parent_xyz, parent_mask, child_xyz, child_mask,
                        init_pose: se3.Pose,
                        cfg: NdtCalibConfig) -> NdtCalibResult:
    """One frame: the child downsampled, the parent's NDT map, NDT from
    `init_pose`."""
    child = voxel_downsample(Cloud.create(child_xyz, mask=child_mask),
                             cfg.child_leaf, capacity=cfg.child_capacity)
    ndt_map = registration.build_ndt_map(parent_xyz, parent_mask,
                                         cfg.resolution, cfg.map_capacity)
    res = registration.ndt(child.xyz, child.mask, ndt_map, init_pose,
                           max_iters=cfg.max_iters, resolution=cfg.resolution,
                           step_size=cfg.step_size)
    return NdtCalibResult(res.pose, res.score, res.converged, res.iters)


class NdtCalibrator:
    """Host loop on `device` (the card unless the caller passes
    ``device="cpu"``): feeds each frame, carrying the estimate forward
    (:72)."""

    def __init__(self, cfg: NdtCalibConfig = NdtCalibConfig(),
                 initial_guess: Optional[se3.Pose] = None, device="cuda"):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.pose = initial_guess or se3.Pose.identity(device=self.device)
        self.history = []

    def process_pair(self, parent_xyz: np.ndarray, child_xyz: np.ndarray):
        p_x, p_m = device_mod.pad(parent_xyz, self.cfg.child_capacity,
                                  self.device)
        c_x, c_m = device_mod.pad(child_xyz, self.cfg.child_capacity,
                                  self.device)
        res = ndt_calibrate_frame(p_x, p_m, c_x, c_m, self.pose, self.cfg)
        self.pose = res.pose
        self.history.append(float(res.score))
        return res

    def static_transform_command(self, parent="parent_lidar",
                                 child="child_lidar"):
        """The reference's ready-to-use static_transform_publisher line
        (:78-91)."""
        v6 = self.pose.to_vec6().detach().cpu().numpy()
        r, p, y = v6[:3]
        x, yy, z = v6[3:]
        return (f"rosrun tf static_transform_publisher {x:.4f} {yy:.4f} "
                f"{z:.4f} {y:.4f} {p:.4f} {r:.4f} {parent} {child} 10")
