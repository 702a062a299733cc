# Frozen copy of msst_torch/models/liosam/state.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
"""LIO-SAM estimator state (port of ``msst_tpu.models.liosam.state``):
fixed-capacity keyframe store, incremental local map, factor graph and IMU
filter — the mutable members of the reference's ``mapOptmization``
(cloudKeyPoses3D/6D, keyframe clouds, iSAM2 state :50-140) as NamedTuples of
tensors on one device.

The step functions treat the state as a value: they return a new state and
never write into the tensors of the one they were given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops import graph as graph_ops
from ...ops import knn, voxelmap
from . import imu_fusion
from .params import LioParams

Tensor = torch.Tensor


class KeyframeStore(NamedTuple):
    pose6: Tensor        # (K, 6) roll,pitch,yaw,x,y,z in map frame
    time: Tensor         # (K,) scan timestamps
    corner_xyz: Tensor   # (K, Ck, 3) scan-frame downsampled corner features
    corner_mask: Tensor  # (K, Ck)
    surf_xyz: Tensor     # (K, Cs, 3)
    surf_mask: Tensor    # (K, Cs)
    count: Tensor        # () int32
    # pose at which each keyframe's moments were merged into the local map
    baked_pose6: Tensor  # (K, 6)
    baked: Tensor        # (K,) bool — contribution currently in the map

    @property
    def positions(self) -> Tensor:
        return self.pose6[:, 3:]

    @property
    def mask(self) -> Tensor:
        return torch.arange(self.pose6.shape[0],
                            device=self.pose6.device) < self.count


class LocalMap(NamedTuple):
    """Cached scan-matching map, rebuilt when a keyframe is inserted.

    On the voxel path the voxel-feature tables are the map: the flat clouds
    are 8-row placeholders and the knn hash grids are None; the moment
    tables hold the incremental map (8-row placeholders with
    ``map_update="rebuild"``).  On the knn path the flat clouds
    (map_corner_cap / map_surf_cap rows) and their hash grids are the map,
    and the voxel tables and moments are 8-row placeholders."""

    corner_xyz: Tensor
    corner_mask: Tensor
    surf_xyz: Tensor
    surf_mask: Tensor
    corner_grid: Optional[knn.HashGrid]
    surf_grid: Optional[knn.HashGrid]
    corner_vox: voxelmap.VoxelFeatureMap
    surf_vox: voxelmap.VoxelFeatureMap
    corner_mom: voxelmap.VoxelMoments
    surf_mom: voxelmap.VoxelMoments
    anchor: Tensor       # (3,) fine-grid anchor of the moment tables
    valid: Tensor        # () bool
    mom_dropped: Tensor  # (2,) int32 cells dropped by cap overflow since re-bake


class LioState(NamedTuple):
    kf: KeyframeStore
    graph: graph_ops.PoseGraph
    local_map: LocalMap
    n_gps: Tensor            # () next free GPS factor slot
    n_loop: Tensor           # () number of loop factors added
    pose6: Tensor            # (6,) latest optimized pose
    filter: imu_fusion.FilterState
    last_scan_time: Tensor   # ()
    initialized: Tensor      # () bool
    degenerate: Tensor       # () bool
    loop_closed: Tensor      # () bool


def _empty_local_map(p: LioParams, device) -> LocalMap:
    use_vox = p.scan2map_method == "voxel"
    use_inc = use_vox and p.map_update == "incremental"

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def grid(cap):
        if use_vox:
            return None
        return knn.build(zeros(cap, 3), zeros(cap, dtype=torch.bool), 1.0,
                         p.knn_table_size)

    def vox(cap, leaf, kind):
        c = cap if use_vox else 8
        return voxelmap.build(zeros(c, 3), zeros(c, dtype=torch.bool), leaf,
                              c, kind, origin=zeros(3), table_size=2 * c)

    cc = 8 if use_vox else p.map_corner_cap
    sc = 8 if use_vox else p.map_surf_cap
    return LocalMap(
        corner_xyz=zeros(cc, 3), corner_mask=zeros(cc, dtype=torch.bool),
        surf_xyz=zeros(sc, 3), surf_mask=zeros(sc, dtype=torch.bool),
        corner_grid=grid(p.map_corner_cap), surf_grid=grid(p.map_surf_cap),
        corner_vox=vox(p.vox_corner_cap, p.vox_corner_leaf, "line"),
        surf_vox=vox(p.vox_surf_cap, p.vox_surf_leaf, "plane"),
        corner_mom=voxelmap.empty_moments(p.map_corner_cap if use_inc else 8,
                                          device),
        surf_mom=voxelmap.empty_moments(p.map_surf_cap if use_inc else 8,
                                        device),
        anchor=zeros(3),
        valid=torch.tensor(False, device=device),
        mom_dropped=zeros(2, dtype=torch.int32),
    )


def init_state(p: LioParams, device) -> LioState:
    K = p.max_keyframes

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    kf = KeyframeStore(
        pose6=zeros(K, 6), time=zeros(K),
        corner_xyz=zeros(K, p.kf_corner_cap, 3),
        corner_mask=zeros(K, p.kf_corner_cap, dtype=torch.bool),
        surf_xyz=zeros(K, p.kf_surf_cap, 3),
        surf_mask=zeros(K, p.kf_surf_cap, dtype=torch.bool),
        count=zeros(dtype=torch.int32),
        baked_pose6=zeros(K, 6),
        baked=zeros(K, dtype=torch.bool),
    )
    graph = graph_ops.empty_graph(max_poses=K, max_priors=1,
                                  max_betweens=K + p.max_loop_factors,
                                  max_gps=p.max_gps_factors, device=device)
    false = zeros(dtype=torch.bool)
    return LioState(
        kf=kf, graph=graph, local_map=_empty_local_map(p, device),
        n_gps=zeros(dtype=torch.int32), n_loop=zeros(dtype=torch.int32),
        pose6=zeros(6), filter=imu_fusion.FilterState.initial(device=device),
        last_scan_time=zeros(), initialized=false, degenerate=false,
        loop_closed=false,
    )
