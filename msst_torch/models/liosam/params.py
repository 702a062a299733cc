"""LIO-SAM parameter set — field for field the same as
``msst_tpu.models.liosam.params`` (a test holds the two equal).

Mirrors the reference's ``config/params.yaml`` (``include/utility.h:63-250``).
Some fields only steer paths of msst_tpu that the port does not take yet
(windowed uploads, Pallas routing); they stay so
that one parameter object describes both packages.  Paths the port does not
take raise ``NotImplementedError`` where they are selected.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LioParams:
    # --- Lidar sensor geometry (params.yaml:22-31): "velodyne" | "ouster" |
    # "livox" (azimuth columns vs the livox per-ring running counter)
    sensor: str = "velodyne"
    n_scan: int = 16
    horizon_scan: int = 1800
    downsample_rate: int = 1
    lidar_min_range: float = 1.0
    lidar_max_range: float = 1000.0
    max_points: int = 65536          # input cloud capacity

    # --- IMU (params.yaml:33-44)
    imu_acc_noise: float = 3.9939570888238808e-03
    imu_gyr_noise: float = 1.5636343949698187e-03
    imu_acc_bias_noise: float = 6.4356659353532566e-05
    imu_gyr_bias_noise: float = 3.5640318696367613e-05
    imu_gravity: float = 9.80511
    imu_rpy_weight: float = 0.01
    imu_window: int = 256            # IMU samples buffered per scan
    imu_rate: float = 500.0

    # dynamic initializer: buffer the first scans, read back the converged
    # velocity, reset and re-feed (pipeline._bootstrap_refeed)
    dynamic_init: bool = True

    # translation deskew from the ESKF velocity (DEVIATION from the
    # reference, whose findPosition is stubbed, imageProjection.cpp:473-487)
    deskew_translation: bool = True

    # int16 window uploads of msst_tpu's windowed dispatch; not read here
    quantized_upload: bool = True

    # --- LOAM thresholds (params.yaml:60-64)
    edge_threshold: float = 1.0
    feature_method: str = "nms"   # "nms" (ported) | "exact" (not yet)
    surf_threshold: float = 0.1
    edge_feature_min_valid_num: int = 10
    surf_feature_min_valid_num: int = 100

    # --- voxel leaf sizes (params.yaml:66-69).  ops/voxel packs cell coords
    # into +-1024 cells re-centred on each cloud's first point.
    odometry_surf_leaf_size: float = 0.4
    mapping_corner_leaf_size: float = 0.2
    mapping_surf_leaf_size: float = 0.4

    # --- robot motion constraints (params.yaml:71-73)
    z_tolerance: float = 1000.0
    rotation_tolerance: float = 1000.0

    # --- scan-to-map / keyframing (params.yaml:75-86)
    mapping_process_interval: float = 0.15
    surrounding_keyframe_adding_dist_threshold: float = 1.0
    surrounding_keyframe_adding_angle_threshold: float = 0.2
    surrounding_keyframe_density: float = 2.0
    surrounding_keyframe_search_radius: float = 50.0
    scan2map_max_iters: int = 30
    # "voxel": lookups in the voxel-feature map (kernel voxel_lookup.cu);
    # "knn": the reference-faithful 5-NN path (kernel knn_query.cu)
    scan2map_method: str = "voxel"
    # cost-plateau stop for the voxel GN
    plateau_rtol: float = 1e-3
    plateau_min_iters: int = 2
    # frozen re-association: a new voxel lookup only when the pose moved
    # more than these (rad / m) since the last one; 0/0 = every iteration
    s2m_reassoc_rot: float = 0.01
    s2m_reassoc_trans: float = 0.02
    # skip the keyframe graph solve while only the prior + odometry chain
    # exist (the graph is then at its optimum by construction)
    graph_lazy_solve: bool = True
    vox_source: str = "downsampled"  # rebuild-mode fit input (not ported)
    # local-map maintenance of the voxel method: "incremental" (ported) |
    # "rebuild" (not yet); the knn method always rebuilds its map clouds
    map_update: str = "incremental"
    map_anchor_radius: float = 40.0   # re-bake beyond this from the anchor
    map_stale_tolerance: float = 0.2  # re-bake when a baked pose moved more
    # Pallas routing switch of msst_tpu.  The port does not read it: on a
    # CUDA tensor the voxel lookup and the knn query are always CUDA kernels.
    use_pallas: str = "off"
    degeneracy_threshold: float = 100.0  # JtJ eigenvalue gate (LMOptimization :1244)
    # feature-voxel leaves: power-of-two multiples of the mapping leaves, so
    # the moment tables use the hierarchical key packing (mapping._group_bits)
    vox_corner_leaf: float = 0.8
    vox_surf_leaf: float = 0.8
    # min sqrt(lambda_mid) of a surf voxel's scatter for a plane; thinner
    # cells are reclassified as line features (ops/voxelmap.build)
    vox_plane_min_spread: float = 0.05
    vox_corner_cap: int = 8192
    vox_surf_cap: int = 16384

    # --- loop closure (params.yaml:88-96)
    loop_closure_enabled: bool = True
    loop_closure_frequency: float = 1.0
    surrounding_keyframe_size: int = 50
    history_keyframe_search_radius: float = 15.0
    history_keyframe_search_time_diff: float = 30.0
    history_keyframe_search_num: int = 25
    history_keyframe_fitness_score: float = 0.3
    loop_candidates: int = 3
    loop_leaf_size: float = 0.4
    loop_degeneracy_ratio: float = 0.05
    loop_fine: str = "plane"
    loop_icp_refine_dist: float = 2.0
    loop_coarse_factor: int = 2

    # --- GPS fusion (params.yaml:14-18)
    use_gps_elevation: bool = False
    gps_cov_threshold: float = 2.0
    # GPS fuses only while the ESKF position-covariance trace is above this
    pose_cov_threshold: float = 0.05

    # --- static capacity caps
    max_keyframes: int = 1024
    # pose-graph solver: "dense" | "cg" | "auto" (dense up to cg_threshold
    # keyframes, CG beyond)
    graph_solver: str = "auto"
    cg_threshold: int = 512
    kf_corner_cap: int = 2048        # stored downsampled corners per keyframe
    kf_surf_cap: int = 8192
    scan_corner_cap: int = 2048      # downsampled features per scan
    scan_surf_cap: int = 8192
    near_keyframes: int = 32         # local-map keyframe gather count
    map_corner_cap: int = 16384      # moment-table capacities
    map_surf_cap: int = 49152
    loop_submap_cap: int = 49152
    max_gps_factors: int = 256
    max_loop_factors: int = 128
    graph_window: int = 16           # free poses in windowed graph updates
    knn_table_size: int = 32768
    knn_candidates: int = 24

    # --- solver noise (gtsam sigmas in mapOptmization.cpp:1381-1495)
    prior_sigma_rot: float = 1e-2
    prior_sigma_trans: float = 1e-1
    odom_sigma_rot: float = 1e-3
    odom_sigma_trans: float = 1e-2
    # translation-sigma multiplier for between factors of a DEGENERATE match
    degen_between_scale: float = 50.0

    def __post_init__(self):
        # the per-ring surf downsample packs ring ids into a 7-bit key field
        if self.n_scan > 128:
            raise ValueError(
                f"n_scan={self.n_scan} exceeds the 128-ring bound of the "
                "packed per-ring voxel key (ops/voxel.voxel_downsample "
                "extra_key is 7 bits)")

    @property
    def imu_params(self):
        from ...ops.imu import ImuParams

        return ImuParams(
            acc_noise=self.imu_acc_noise,
            gyr_noise=self.imu_gyr_noise,
            acc_bias_noise=self.imu_acc_bias_noise,
            gyr_bias_noise=self.imu_gyr_bias_noise,
            gravity=self.imu_gravity,
        )


def tiny_params(**overrides) -> LioParams:
    """Small-capacity parameter set for CPU tests."""
    base = dict(
        n_scan=16, horizon_scan=360, max_points=8192,
        imu_window=64,
        max_keyframes=64, kf_corner_cap=512, kf_surf_cap=2048,
        scan_corner_cap=512, scan_surf_cap=2048,
        near_keyframes=8, map_corner_cap=2048, map_surf_cap=8192,
        loop_submap_cap=4096, loop_leaf_size=0.8, max_gps_factors=16, max_loop_factors=16,
        knn_table_size=4096, scan2map_max_iters=10,
        degeneracy_threshold=30.0,  # caps are ~4x smaller, eigenvalues scale with them
        vox_plane_min_spread=0.0,
    )
    base.update(overrides)
    return LioParams(**base)
