"""The LIO odometry step (port of ``msst_tpu.models.liosam.mapping``; the
reference's ``mapOptmization`` per-scan pipeline, ``laserCloudInfoHandler``
:237-271):

* initial guess from the IMU filter (``updateInitialGuess`` :786-845),
* scan downsample (:955-967) + scan-to-map Gauss-Newton (:1282-1310),
* roll/pitch slerp fusion + clamps (``transformUpdate`` :1312-1342),
* keyframe gate (``saveFrame`` :1354-1379), prior/between/GPS factors
  (:1381-1475), graph solve, pose-history rewrite (``correctPoses``),
* keyframe eviction with marginalization once the store is full,
* the local map (``extractCloud`` :899-938): the incremental voxel-feature
  map of ``scan2map_method="voxel"`` or its rebuilt map
  (``map_update="rebuild"``), or the rebuilt map clouds and hash grids of
  ``scan2map_method="knn"``, and the ESKF update.

msst_tpu compiles this into one program with ``lax.cond`` branches; here the
branches are Python ``if``s on flags read back from the device.

Windowed dispatch (``odometry_window_*``): W scans come in one upload, in
one of msst_tpu's four layouts byte for byte (float32 rows, int16-quantized
rows, range-image grids per scan or once a window), are decoded on the
device, prepared slot by slot and run through the same core in order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops import graph as graph_ops
from ...ops import imu as imu_ops
from ...ops import knn, registration, se3, voxel, voxelmap
from ...ops.pointcloud import Cloud, compact
from ...utils import profiling
from ...utils.profiling import span, to_host, traced
from . import imu_fusion
from .frontend import ScanInput, run_frontend, run_frontend_grid
from .params import LioParams
from .state import KeyframeStore, LioState, LocalMap, _empty_local_map

Tensor = torch.Tensor


class StepInput(NamedTuple):
    scan: ScanInput
    # inter-scan IMU (previous scan -> this scan) for the filter
    pre_t: Tensor      # (T,)
    pre_gyro: Tensor   # (T, 3)
    pre_acc: Tensor    # (T, 3)
    pre_mask: Tensor   # (T,)
    gps_xyz: Tensor    # (3,)
    gps_sigma: Tensor  # (3,)
    gps_valid: Tensor  # () bool
    # dynamic-init hint: body-frame velocity for the FIRST scan's deskew and
    # filter init, the one scan where no estimate exists yet
    init_vel_body: Tensor   # (3,)
    init_vel_valid: Tensor  # () bool


class StepOutput(NamedTuple):
    pose: se3.Pose
    pose_matrix: Tensor  # (4, 4)
    pose6: Tensor
    velocity: Tensor
    bias: imu_ops.ImuBias
    degenerate: Tensor
    is_keyframe: Tensor
    n_corner: Tensor
    n_surf: Tensor
    kf_count: Tensor
    s2m_iterations: Tensor
    map_occupancy: Tensor  # (2,) float in [0, 1] of the (corner, surf) tables
    map_dropped: Tensor    # (2,) int32 cumulative overflow drops


def unpack_step_input(points: Tensor, aux: Tensor, p: LioParams) -> StepInput:
    """Rebuild a StepInput from the 2-array host format of
    pipeline._make_input_np.

    points: (max_points, 5) = [x, y, z, time_rel, ring]
    aux:    (2T + 3, 8): rows [0, T)   scan-window IMU [t, gyro3, acc3, mask]
                         rows [T, 2T)  inter-scan IMU  [t, gyro3, acc3, mask]
                         row 2T   [scan_start, n_points, imu_available, rpy0..2, gps_valid, 0]
                         row 2T+1 [gps_xyz(3), gps_sigma(3), 0, 0]
                         row 2T+2 [init_vel_body(3), init_vel_valid, 0..0]
    """
    T = p.imu_window
    misc, gps, boot = aux[2 * T], aux[2 * T + 1], aux[2 * T + 2]
    n_pts = misc[1].to(torch.int32)
    scan = ScanInput(
        xyz=points[:, :3],
        mask=torch.arange(p.max_points, device=points.device) < n_pts,
        ring=points[:, 4].to(torch.int32),
        time=points[:, 3],
        scan_start=misc[0],
        imu_t=aux[:T, 0], imu_gyro=aux[:T, 1:4], imu_acc=aux[:T, 4:7],
        imu_mask=aux[:T, 7] > 0.5,
        imu_rpy_init=misc[3:6],
        imu_available=misc[2] > 0.5,
    )
    return StepInput(
        scan=scan,
        pre_t=aux[T:2 * T, 0], pre_gyro=aux[T:2 * T, 1:4],
        pre_acc=aux[T:2 * T, 4:7], pre_mask=aux[T:2 * T, 7] > 0.5,
        gps_xyz=gps[:3], gps_sigma=gps[3:6], gps_valid=misc[6] > 0.5,
        init_vel_body=boot[:3], init_vel_valid=boot[3] > 0.5,
    )


@traced("step")
def odometry_step_packed(state: LioState, points: Tensor, aux: Tensor,
                         p: LioParams):
    """One scan from the packed host arrays (the pipeline's entry)."""
    return odometry_step(state, unpack_step_input(points, aux, p), p)


def odometry_step(state: LioState, inp: StepInput, p: LioParams):
    """One scan through prepare + core."""
    return odometry_core(state, prepare_scan(inp, p), p)


# ---------------------------------------------------------------------------
# windowed dispatch: W scans from one upload
# ---------------------------------------------------------------------------


def _passthrough_output(state: LioState, p: LioParams) -> StepOutput:
    """StepOutput for a padded (invalid) window slot: state unchanged."""
    dev = state.pose6.device
    pose = se3.Pose.from_vec6(state.pose6)
    occ, dropped = _map_telemetry(state.local_map, p)
    none = torch.tensor(0, dtype=torch.int64, device=dev)
    return StepOutput(
        pose=pose, pose_matrix=pose.to_matrix(), pose6=state.pose6,
        velocity=state.filter.nav.v, bias=state.filter.bias,
        degenerate=state.degenerate,
        is_keyframe=torch.tensor(False, device=dev),
        n_corner=none, n_surf=none, kf_count=state.kf.count,
        s2m_iterations=torch.tensor(0, dtype=torch.int32, device=dev),
        map_occupancy=occ, map_dropped=dropped,
    )


def _stack(items):
    """Stack a list of equal NamedTuple trees of tensors leaf by leaf."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([it[i] for it in items])
                             for i in range(len(first))))
    return torch.stack(items)


def _valid_slots(aux_w: Tensor, p: LioParams, n_valid: Optional[int]):
    """The window's valid slots as a host list: the first `n_valid` (the
    packer puts the scans first), else read from the scan-valid flags
    (aux row 2T, column 7) in one copy."""
    W = aux_w.shape[0]
    if n_valid is None:
        return to_host(aux_w[:, 2 * p.imu_window, 7] > 0.5, "step.slot_mask",
                       Tensor.tolist)
    return [i < n_valid for i in range(W)]


def _window_core(state: LioState, preps: list, valid: list, p: LioParams):
    """The estimator core over a window of prepared scans, slot by slot:
    ``odometry_core`` for each valid slot, the state echoed for each padded
    one (msst_tpu's ``lax.cond`` in a ``lax.scan``; here the host knows the
    valid slots).  Returns (state, StepOutput stacked on a leading W axis)."""
    outs = []
    for i, (ps, ok) in enumerate(zip(preps, valid)):
        if ok:
            with profiling.slot(i):
                state, out = odometry_core(state, ps, p)
        else:
            out = _passthrough_output(state, p)
        outs.append(out)
    return state, _stack(outs)


def odometry_window_packed(state: LioState, points_w: Tensor, aux_w: Tensor,
                           p: LioParams, n_valid: Optional[int] = None):
    """W scans of packed inputs: ``prepare_scan`` for each valid slot, then
    the core over the window.  Same results as W ``odometry_step_packed``
    calls; padded slots (aux[2T, 7] = 0) pass the state through.

    points_w: (W, max_points, 5);  aux_w: (W, 2T+3, 8)"""
    valid = _valid_slots(aux_w, p, n_valid)
    preps = [None] * len(valid)
    for i, ok in enumerate(valid):
        if ok:
            with profiling.slot(i):
                preps[i] = prepare_scan(
                    unpack_step_input(points_w[i], aux_w[i], p), p)
    return _window_core(state, preps, valid, p)


def odometry_window_grids(state: LioState, r: Tensor, az: Tensor,
                          tcol: Tensor, elev: Tensor, aux_w: Tensor,
                          p: LioParams, n_valid: Optional[int] = None):
    """:func:`odometry_window_packed` fed by range-image grids: the grid
    frontend for each valid slot.  az/tcol (H,) and elev (S,) are shared by
    the window (the ri2 layout) or per scan (W, .).

    r: (W, S*H);  aux_w: (W, 2T+3, 8)"""
    W = r.shape[0]
    r3 = r.reshape(W, p.n_scan, p.horizon_scan)
    valid = _valid_slots(aux_w, p, n_valid)
    per_scan = az.dim() == 2

    def grid(g, i):
        return g[i] if per_scan else g

    preps = [None] * len(valid)
    for i, ok in enumerate(valid):
        if ok:
            with profiling.slot(i):
                preps[i] = prepare_scan_grid(r3[i], grid(az, i),
                                             grid(tcol, i), grid(elev, i),
                                             aux_w[i], p)
    return _window_core(state, preps, valid, p)


POINT_QUANT = (256.0, 256.0, 256.0, 16384.0, 1.0)  # per-column int16 scales:
# xyz at 3.9 mm steps over +-128 m, time_rel at 61 us steps over +-2 s,
# ring verbatim.
RI_RANGE_SCALE = 250.0  # int16 range steps: 4 mm over [0, 131 m]


def _f32(halves: Tensor) -> Tensor:
    """float32 values that ride as pairs of int16 halves (the packer's
    ``float32.view(int16)``), bit for bit: (..., 2n) int16 -> (..., n)."""
    return halves.contiguous().view(torch.float32)


@traced("step")
def odometry_window_flat(state: LioState, flat_w: Tensor, p: LioParams,
                         n_valid: Optional[int] = None):
    """:func:`odometry_window_packed` fed by one float32 buffer
    (W, max_points*5 + (2T+3)*8): the window's points and aux in one
    upload."""
    W = flat_w.shape[0]
    n5 = p.max_points * 5
    T = p.imu_window
    pts_w = flat_w[:, :n5].reshape(W, p.max_points, 5)
    aux_w = flat_w[:, n5:n5 + (2 * T + 3) * 8].reshape(W, 2 * T + 3, 8)
    return odometry_window_packed(state, pts_w, aux_w, p, n_valid)


@traced("step")
def odometry_window_flat_q16(state: LioState, flat_w: Tensor, p: LioParams,
                             n_valid: Optional[int] = None):
    """:func:`odometry_window_flat` fed by one int16 buffer: points
    quantized per POINT_QUANT, the aux rows as raw float32 bit patterns in
    int16 halves (no precision loss).

    flat_w: (W, max_points*5 + (2T+3)*8*2) int16"""
    W = flat_w.shape[0]
    n5 = p.max_points * 5
    T = p.imu_window
    a8 = (2 * T + 3) * 8
    scales = torch.tensor(POINT_QUANT, dtype=torch.float32,
                          device=flat_w.device)
    pts_w = (flat_w[:, :n5].reshape(W, p.max_points, 5).to(torch.float32)
             / scales)
    aux_w = _f32(flat_w[:, n5:n5 + 2 * a8]).reshape(W, 2 * T + 3, 8)
    return odometry_window_packed(state, pts_w, aux_w, p, n_valid)


@traced("step")
def odometry_window_flat_ri(state: LioState, flat_w: Tensor, p: LioParams,
                            n_valid: Optional[int] = None):
    """Range-image upload: per-pixel ranges (int16 at RI_RANGE_SCALE; an
    invalid pixel carries 0 and fails the min-range gate) plus each scan's
    azimuth / column time / elevation grids, fed to the grid frontend.

    flat_w: (W, S*H + 2H + 2H + 2S + (2T+3)*8*2) int16 —
            [ranges, az, col_time, elev, aux (each f32 block as halves)]"""
    W = flat_w.shape[0]
    S, H = p.n_scan, p.horizon_scan
    n_pix = S * H
    T = p.imu_window
    r = flat_w[:, :n_pix].to(torch.float32) / RI_RANGE_SCALE
    off = n_pix
    blocks = []
    for width in (H, H, S, (2 * T + 3) * 8):
        blocks.append(_f32(flat_w[:, off:off + 2 * width]))
        off += 2 * width
    az, tcol, elev, aux = blocks
    return odometry_window_grids(state, r, az, tcol, elev,
                                 aux.reshape(W, 2 * T + 3, 8), p, n_valid)


def _ri_points(r: Tensor, az: Tensor, tcol: Tensor, elev: Tensor,
               p: LioParams) -> Tensor:
    """The packed (W, max_points, 5) point rows of per-pixel ranges
    (W, S*H), per-column azimuth / time (W, H) and per-ring elevation
    (W, S): ``x = r (cos e cos a, cos e sin a, sin e)``; zero rows pad to
    max_points (range 0: culled by the min-range gate)."""
    W = r.shape[0]
    S, H = p.n_scan, p.horizon_scan
    n_pix = S * H
    ce, se_ = torch.cos(elev), torch.sin(elev)                  # (W, S)
    ca, sa = torch.cos(az), torch.sin(az)                       # (W, H)
    ri = r.reshape(W, S, H)
    x = ri * (ce[:, :, None] * ca[:, None, :])
    y = ri * (ce[:, :, None] * sa[:, None, :])
    z = ri * se_[:, :, None]
    t = tcol[:, None, :].expand(W, S, H)
    ring = torch.arange(S, dtype=torch.float32,
                        device=r.device)[None, :, None].expand(W, S, H)
    pts_w = torch.stack([x, y, z, t, ring], dim=-1).reshape(W, n_pix, 5)
    pad = p.max_points - n_pix
    if pad > 0:
        pts_w = torch.cat([pts_w, pts_w.new_zeros((W, pad, 5))], dim=1)
    return pts_w


def ri_flat_width(p: LioParams) -> int:
    """int16 row width of the range-image window buffer (see
    :func:`odometry_window_flat_ri`)."""
    S, H, T = p.n_scan, p.horizon_scan, p.imu_window
    return S * H + 2 * H + 2 * H + 2 * S + (2 * T + 3) * 8 * 2


def ri2_flat_len(p: LioParams, window: int) -> int:
    """int16 length of the grid-hoisted range-image window buffer (see
    :func:`odometry_window_flat_ri2`)."""
    S, H, T = p.n_scan, p.horizon_scan, p.imu_window
    return window * (S * H + (2 * T + 3) * 8 * 2) + 2 * H + 2 * H + 2 * S


@traced("step")
def odometry_window_flat_ri2(state: LioState, flat_w: Tensor, p: LioParams,
                             n_valid: Optional[int] = None):
    """:func:`odometry_window_flat_ri` with the azimuth / column time /
    elevation grids once a window: a fixed firing pattern makes them equal
    across the window's scans (the packer checks that on the host and
    falls back to the per-scan layout otherwise).

    flat_w: 1-D int16 —
        [W*S*H ranges, W*(2T+3)*8*2 aux, 2H az, 2H col_time, 2S elev]"""
    S, H = p.n_scan, p.horizon_scan
    T = p.imu_window
    n_pix = S * H
    a8 = (2 * T + 3) * 8
    W = (flat_w.shape[0] - 2 * (2 * H + S)) // (n_pix + 2 * a8)
    r = flat_w[:W * n_pix].reshape(W, n_pix).to(torch.float32) / RI_RANGE_SCALE
    off = W * n_pix
    aux_w = _f32(flat_w[off:off + W * 2 * a8].reshape(W, 2 * a8)).reshape(
        W, 2 * T + 3, 8)
    off += W * 2 * a8
    blocks = []
    for width in (H, H, S):
        blocks.append(_f32(flat_w[off:off + 2 * width]))
        off += 2 * width
    az, tcol, elev = blocks
    return odometry_window_grids(state, r, az, tcol, elev, aux_w, p, n_valid)


def select_window_fn(p: LioParams, flat_w: Tensor):
    """The window decoder matching a packed buffer's layout: 1-D is the
    hoisted range image, a row of ``ri_flat_width`` the per-scan one, other
    int16 rows quantized points, float32 rows the plain layout."""
    if flat_w.dim() == 1:
        return odometry_window_flat_ri2
    if p.quantized_upload and flat_w.shape[1] == ri_flat_width(p):
        return odometry_window_flat_ri
    if p.quantized_upload:
        return odometry_window_flat_q16
    return odometry_window_flat


# ---------------------------------------------------------------------------
# local map assembly
# ---------------------------------------------------------------------------


def _set(x: Tensor, idx, val) -> Tensor:
    """A copy of x with x[idx] = val (the state is a value, never written)."""
    y = x.clone()
    y[idx] = val
    return y


def _select_nearby(kf: KeyframeStore, position: Tensor, scan_time: Tensor,
                   p: LioParams):
    """Nearby-keyframe selection (``extractNearby`` :862-897: radius search +
    always the last-10 s keyframes) -> (sel_idx (S,), sel_ok (S,)).  Ties go
    to the lower slot, like XLA's top_k."""
    K = kf.pose6.shape[0]
    d2 = torch.sum((kf.positions - position) ** 2, dim=1)
    recent = (scan_time - kf.time) < 10.0
    in_radius = d2 < p.surrounding_keyframe_search_radius ** 2
    eligible = kf.mask & (in_radius | recent)
    eff = torch.where(eligible, torch.where(recent, 0.0, d2), torch.inf)
    sel_idx = torch.argsort(eff, stable=True)[:min(p.near_keyframes, K)]
    return sel_idx, torch.isfinite(eff[sel_idx])


def _gather_selected(kf: KeyframeStore, sel_idx: Tensor, sel_ok: Tensor):
    """The selected keyframes' feature clouds in the world frame, flattened
    into masked (S*C, 3) clouds."""
    poses = se3.Pose.from_vec6(kf.pose6[sel_idx])

    def gather(cloud_xyz, cloud_mask):
        world = poses.apply(cloud_xyz[sel_idx])
        msk = cloud_mask[sel_idx] & sel_ok[:, None]
        return Cloud.create(world.reshape(-1, 3), mask=msk.reshape(-1))

    return (gather(kf.corner_xyz, kf.corner_mask),
            gather(kf.surf_xyz, kf.surf_mask))


def _gather_nearby_world(kf: KeyframeStore, position: Tensor,
                         scan_time: Tensor, p: LioParams):
    sel_idx, sel_ok = _select_nearby(kf, position, scan_time, p)
    return _gather_selected(kf, sel_idx, sel_ok)


def _assemble_local_map(kf: KeyframeStore, position: Tensor,
                        scan_time: Tensor, p: LioParams):
    """Nearby keyframes fused into fixed-cap masked map clouds
    (``extractCloud`` :899-938: transform + density downsample).  The local
    map lies within the search radius of `position`, far inside the packed
    +-512-cell domain."""
    corner_flat, surf_flat = _gather_nearby_world(kf, position, scan_time, p)
    corner_map = voxel.voxel_downsample_packed(
        corner_flat, p.mapping_corner_leaf_size, position,
        capacity=p.map_corner_cap)
    surf_map = voxel.voxel_downsample_packed(
        surf_flat, p.mapping_surf_leaf_size, position,
        capacity=p.map_surf_cap)
    return corner_map, surf_map


def _use_incremental(p: LioParams) -> bool:
    return p.scan2map_method == "voxel" and p.map_update == "incremental"


@traced("rebuild")
def _rebuild_local_map(kf: KeyframeStore, position: Tensor, scan_time: Tensor,
                       p: LioParams, prev: Optional[LocalMap] = None
                       ) -> LocalMap:
    """The local map rebuilt around a new keyframe: every map of the knn
    method, and of the voxel method with ``map_update="rebuild"``.

    voxel: the voxel-feature tables fit from the nearby keyframes'
    features, centroid-downsampled first (``vox_source="downsampled"``,
    the reference's ``extractCloud`` :899-938) or as gathered
    (``"direct"``); the flat clouds stay 8-row placeholders and there are
    no hash grids.  knn: the map clouds and a hash grid over each (cell
    1 m, the 5-NN gate's radius).  The placeholders (and the unused moment
    tables) are `prev`'s, the map this one replaces (an empty map's if
    None), so that they are built once."""
    if prev is None:
        prev = _empty_local_map(p, position.device)
    if p.scan2map_method == "voxel":
        if p.vox_source == "direct":
            vc, vs = _gather_nearby_world(kf, position, scan_time, p)
        else:
            vc, vs = _assemble_local_map(kf, position, scan_time, p)
        return prev._replace(
            corner_vox=voxelmap.build(
                vc.xyz, vc.mask, p.vox_corner_leaf, p.vox_corner_cap, "line",
                table_size=2 * p.vox_corner_cap, origin=position,
                plane_min_spread=p.vox_plane_min_spread),
            surf_vox=voxelmap.build(
                vs.xyz, vs.mask, p.vox_surf_leaf, p.vox_surf_cap, "plane",
                table_size=2 * p.vox_surf_cap, origin=position,
                plane_min_spread=p.vox_plane_min_spread),
            anchor=position,
            valid=torch.tensor(True, device=position.device))
    corner_map, surf_map = _assemble_local_map(kf, position, scan_time, p)
    return prev._replace(
        corner_xyz=corner_map.xyz, corner_mask=corner_map.mask,
        surf_xyz=surf_map.xyz, surf_mask=surf_map.mask,
        corner_grid=knn.build(corner_map.xyz, corner_map.mask, 1.0,
                              p.knn_table_size),
        surf_grid=knn.build(surf_map.xyz, surf_map.mask, 1.0,
                            p.knn_table_size),
        anchor=position,
        valid=torch.tensor(True, device=position.device))


def _group_bits(coarse: float, fine: float) -> Optional[int]:
    """k when coarse/fine == 2^k (k >= 0 int), else None: with a power-of-two
    leaf ratio the moment tables use the hierarchical key packing and the
    coarse feature fit skips its sort."""
    r = coarse / fine
    if r < 1.0 or abs(r - round(r)) > 1e-6:
        return None
    r = int(round(r))
    k = r.bit_length() - 1
    return k if (1 << k) == r else None


def _moment_group_bits(p: LioParams) -> tuple[Optional[int], Optional[int]]:
    """(corner_k, surf_k) hierarchical-key group bits of the two tables."""
    return (_group_bits(p.vox_corner_leaf, p.mapping_corner_leaf_size),
            _group_bits(p.vox_surf_leaf, p.mapping_surf_leaf_size))


@traced("refit")
def _features_from_moments(corner_mom, surf_mom, anchor: Tensor, p: LioParams,
                           mom_dropped: Optional[Tensor] = None) -> LocalMap:
    """LocalMap from the moment tables: fine-cell centroids feed the coarse
    voxel-feature fit (the reference's centroid-downsample-then-fit,
    ``extractCloud`` :899-938)."""
    dev = anchor.device
    ck, sk = _moment_group_bits(p)
    cx, cm = voxelmap.moments_centroids(corner_mom, p.mapping_corner_leaf_size,
                                        anchor, group_bits=ck or 0)
    sx, sm, s_cnt = voxelmap.moments_centroids(
        surf_mom, p.mapping_surf_leaf_size, anchor, group_bits=sk or 0,
        return_counts=True)
    tiny_xyz = torch.zeros((8, 3), device=dev)
    tiny_mask = torch.zeros(8, dtype=torch.bool, device=dev)
    return LocalMap(
        corner_xyz=tiny_xyz, corner_mask=tiny_mask,
        surf_xyz=tiny_xyz, surf_mask=tiny_mask,
        corner_grid=None, surf_grid=None,
        corner_vox=voxelmap.build(
            cx, cm, p.vox_corner_leaf, p.vox_corner_cap, "line",
            table_size=2 * p.vox_corner_cap, origin=anchor,
            presorted=ck is not None),
        surf_vox=voxelmap.build(
            sx, sm, p.vox_surf_leaf, p.vox_surf_cap, "plane",
            table_size=2 * p.vox_surf_cap, origin=anchor,
            presorted=sk is not None,
            plane_min_spread=p.vox_plane_min_spread, weights=s_cnt),
        corner_mom=corner_mom, surf_mom=surf_mom, anchor=anchor,
        valid=torch.tensor(True, device=dev),
        mom_dropped=(torch.zeros(2, dtype=torch.int32, device=dev)
                     if mom_dropped is None else mom_dropped),
    )


@traced("rebake")
def _rebake_local_map(kf: KeyframeStore, position: Tensor, scan_time: Tensor,
                      p: LioParams):
    """Full re-bake: gather nearby keyframes at their CURRENT poses, rebuild
    the moment tables anchored at `position`, refit features.  Returns
    (LocalMap, baked_pose6, baked)."""
    K = kf.pose6.shape[0]
    ck, sk = _moment_group_bits(p)
    sel_idx, sel_ok = _select_nearby(kf, position, scan_time, p)
    corner_flat, surf_flat = _gather_selected(kf, sel_idx, sel_ok)
    corner_mom, c_drop = voxelmap.points_to_moments(
        corner_flat.xyz, corner_flat.mask, p.mapping_corner_leaf_size,
        position, p.map_corner_cap, group_bits=ck or 0, return_stats=True)
    surf_mom, s_drop = voxelmap.points_to_moments(
        surf_flat.xyz, surf_flat.mask, p.mapping_surf_leaf_size,
        position, p.map_surf_cap, group_bits=sk or 0, return_stats=True)
    lm = _features_from_moments(corner_mom, surf_mom, position, p,
                                mom_dropped=torch.stack([c_drop, s_drop]))
    baked = _set(torch.zeros(K, dtype=torch.bool, device=position.device),
                 sel_idx, sel_ok)
    return lm, kf.pose6, baked


def _kf_moments(kf: KeyframeStore, slot: int, pose6: Tensor, anchor: Tensor,
                p: LioParams):
    """One keyframe's (corner, surf) moment contribution at `pose6`."""
    pose = se3.Pose.from_vec6(pose6)
    ck, sk = _moment_group_bits(p)
    cmom = voxelmap.points_to_moments(
        pose.apply(kf.corner_xyz[slot]), kf.corner_mask[slot],
        p.mapping_corner_leaf_size, anchor, p.kf_corner_cap,
        group_bits=ck or 0)
    smom = voxelmap.points_to_moments(
        pose.apply(kf.surf_xyz[slot]), kf.surf_mask[slot],
        p.mapping_surf_leaf_size, anchor, p.kf_surf_cap,
        group_bits=sk or 0)
    return cmom, smom


def _map_telemetry(lm: LocalMap, p: LioParams) -> tuple[Tensor, Tensor]:
    """(occupancy (2,) in [0, 1], dropped (2,) int32) of the local map's
    capped structures: the moment tables of the incremental map, the voxel
    feature tables of the voxel method's rebuild map, the flat map clouds of
    the knn method."""
    if _use_incremental(p):
        occ = torch.stack([
            torch.sum(lm.corner_mom.key < voxelmap._BIG) / p.map_corner_cap,
            torch.sum(lm.surf_mom.key < voxelmap._BIG) / p.map_surf_cap,
        ])
    elif p.scan2map_method == "voxel":
        occ = torch.stack([torch.mean(lm.corner_vox.mask.to(torch.float32)),
                           torch.mean(lm.surf_vox.mask.to(torch.float32))])
    else:
        occ = torch.stack([torch.mean(lm.corner_mask.to(torch.float32)),
                           torch.mean(lm.surf_mask.to(torch.float32))])
    return occ.to(torch.float32), lm.mom_dropped


def _graph_optimize(graph, p: LioParams, free_mask=None, iters=2):
    """Dense or matrix-free CG solve, chosen from the capacity as msst_tpu
    chooses (the dense 6Kx6K Cholesky stops fitting around 1k keyframes)."""
    if p.graph_solver == "cg" or (p.graph_solver == "auto"
                                  and p.max_keyframes > p.cg_threshold):
        return graph_ops.optimize_cg(graph, free_mask=free_mask, iters=iters)
    return graph_ops.optimize(graph, free_mask=free_mask, iters=iters)


# ---------------------------------------------------------------------------
# keyframe + factor insertion
# ---------------------------------------------------------------------------


@traced("evict")
def _evict_oldest_keyframe(state: LioState, p: LioParams) -> LioState:
    """Ring-buffer eviction with marginalization: drop the oldest keyframe
    and fold its information into a prior on the new oldest pose (the
    reference resets its preintegration graph every 100 keys and carries
    the marginals forward as priors, ``imuPreintegration.cpp:320-347``).

    * incremental map: the evicted keyframe's baked moments are subtracted
      (``scale_moments(-1)`` then ``merge_moments``, whose ``min_cnt``
      removes the emptied cells); the insert that follows refits features;
    * the Schur complement of slot 0's factors (its prior, the 0->1 chain
      factor or a reversed 1->0 one, GPS factors on slot 0) onto slot 1,
      diagonalized into the new prior of row 0;
    * the store and the graph shift down one slot; loop factors on slot 0
      are reparented onto slot 1 (``rel01^-1 Z`` / ``Z rel01``), the
      collapsed self-factor is masked, the chain region rolls so factor
      i -> i+1 stays at row i, and GPS indices shift (below 0: masked)."""
    kf, graph = state.kf, state.graph
    K = kf.pose6.shape[0]
    dev = kf.pose6.device

    lm = state.local_map
    if _use_incremental(p) and to_host(kf.baked[0] & lm.valid, "evict.baked",
                                       bool):
        cmom, smom = _kf_moments(kf, 0, kf.baked_pose6[0], lm.anchor, p)
        ck, sk = _moment_group_bits(p)
        cmerged, _ = voxelmap.merge_moments(
            lm.corner_mom, voxelmap.scale_moments(cmom, -1.0),
            p.map_corner_cap, group_bits=ck or 0, return_stats=True)
        smerged, _ = voxelmap.merge_moments(
            lm.surf_mom, voxelmap.scale_moments(smom, -1.0),
            p.map_surf_cap, group_bits=sk or 0, return_stats=True)
        state = state._replace(local_map=lm._replace(corner_mom=cmerged,
                                                     surf_mom=smerged))

    # --- Schur complement H11' = H11 - H10 H00^-1 H01 over whitened blocks
    pr, b, gps = graph.priors, graph.betweens, graph.gps
    _, Jp = graph_ops._prior_terms(graph.poses, pr)
    _, Ji, Jj = graph_ops._between_terms(graph.poses, b)
    _, Jg = graph_ops._gps_terms(graph.poses, gps)
    wp = (pr.mask & (pr.idx == 0)).to(torch.float32)
    wb = ((b.i == 0) & (b.j == 1) & b.mask).to(torch.float32)
    wb2 = ((b.i == 1) & (b.j == 0) & b.mask).to(torch.float32)   # reversed
    wg = (gps.mask & (gps.idx == 0)).to(torch.float32)

    def info(Ja, w, Jb):
        return torch.einsum("nri,n,nrj->ij", Ja, w, Jb)

    H00 = (info(Jp, wp, Jp) + info(Ji, wb, Ji) + info(Jj, wb2, Jj)
           + info(Jg, wg, Jg))
    H01 = info(Ji, wb, Jj) + info(Jj, wb2, Ji)
    H11 = info(Jj, wb, Jj) + info(Ji, wb2, Ji)
    M = H11 - H01.T @ torch.linalg.solve(
        H00 + 1e-6 * torch.eye(6, device=dev), H01)
    marg_sqrt_info = torch.sqrt(torch.clamp(torch.diagonal(M), 1e-6, 1e8))

    # --- shift everything down one slot (slot i = the i-th oldest)
    def roll1(x):
        return torch.roll(x, -1, dims=0)

    kf = kf._replace(
        pose6=roll1(kf.pose6), time=roll1(kf.time),
        corner_xyz=roll1(kf.corner_xyz), corner_mask=roll1(kf.corner_mask),
        surf_xyz=roll1(kf.surf_xyz), surf_mask=roll1(kf.surf_mask),
        count=torch.tensor(K - 1, dtype=torch.int32, device=dev),
        baked_pose6=roll1(kf.baked_pose6),
        baked=_set(roll1(kf.baked), K - 1, False),
    )
    poses = se3.Pose(roll1(graph.poses.q), roll1(graph.poses.t))
    pr = pr._replace(
        idx=_set(pr.idx, 0, 0),
        meas=se3.Pose(_set(pr.meas.q, 0, poses.q[0]),
                      _set(pr.meas.t, 0, poses.t[0])),
        sqrt_info=_set(pr.sqrt_info, 0, marg_sqrt_info),
        mask=_set(pr.mask, 0, True))

    # loop factors anchored on pose 0 move to pose 1: Z_1j = rel01^-1 Z_0j,
    # Z_i1 = Z_i0 rel01, exact at the linearization point
    B = b.i.shape[0]
    rel01 = se3.Pose(graph.poses.q[0], graph.poses.t[0]).between(
        se3.Pose(graph.poses.q[1], graph.poses.t[1]))
    rel01b = se3.Pose(rel01.q.expand(B, 4), rel01.t.expand(B, 3))
    m_i = rel01b.inverse().compose(b.meas)
    m_j = b.meas.compose(rel01b)
    re_i, re_j = (b.i == 0)[:, None], (b.j == 0)[:, None]
    meas = se3.Pose(
        torch.where(re_i, m_i.q, torch.where(re_j, m_j.q, b.meas.q)),
        torch.where(re_i, m_i.t, torch.where(re_j, m_j.t, b.meas.t)))
    bi = torch.where(b.i == 0, 1, b.i)
    bj = torch.where(b.j == 0, 1, b.j)
    keep = b.mask & (bi != bj)
    chain = K - 1   # rows [0, K-1) hold the odometry chain

    def roll_chain(x):
        return torch.cat([torch.roll(x[:chain], -1, dims=0), x[chain:]])

    b = graph_ops.BetweenFactor(
        i=roll_chain(bi - 1), j=roll_chain(bj - 1),
        meas=se3.Pose(roll_chain(meas.q), roll_chain(meas.t)),
        sqrt_info=roll_chain(b.sqrt_info), mask=roll_chain(keep))
    # a GPS factor of the evicted pose is masked; it (and every unused row)
    # points at pose 0, so that no index leaves the store however often the
    # ring turns (msst_tpu's gathers clamp its negative indices instead)
    gps = gps._replace(idx=torch.where(gps.idx >= 1, gps.idx - 1, 0),
                       mask=gps.mask & (gps.idx >= 1))
    graph = graph._replace(poses=poses, priors=pr, betweens=b, gps=gps)
    return state._replace(kf=kf, graph=graph)


@traced("keyframe")
def _insert_keyframe(state: LioState, pose6: Tensor, scan_time: Tensor,
                     corner: Cloud, surf: Cloud, ps: "PreparedScan",
                     p: LioParams, degenerate: Tensor) -> LioState:
    profiling.count("keyframes")
    K = state.kf.pose6.shape[0]
    slot = to_host(state.kf.count, "keyframe.slot", int)
    if slot >= K:
        # at capacity: evict the oldest keyframe with marginalization
        state = _evict_oldest_keyframe(state, p)
        slot = K - 1
    with span("factors"):
        dev = pose6.device
        kf, graph = state.kf, state.graph
        pose = se3.Pose.from_vec6(pose6)

        corner = compact(corner, p.kf_corner_cap)
        surf = compact(surf, p.kf_surf_cap)
        kf = kf._replace(
            pose6=_set(kf.pose6, slot, pose6),
            time=_set(kf.time, slot, scan_time),
            corner_xyz=_set(kf.corner_xyz, slot, corner.xyz),
            corner_mask=_set(kf.corner_mask, slot, corner.mask),
            surf_xyz=_set(kf.surf_xyz, slot, surf.xyz),
            surf_mask=_set(kf.surf_mask, slot, surf.mask),
            count=torch.tensor(slot + 1, dtype=torch.int32, device=dev),
        )
        graph = graph._replace(
            poses=se3.Pose(_set(graph.poses.q, slot, pose.q),
                           _set(graph.poses.t, slot, pose.t)),
            pose_mask=_set(graph.pose_mask, slot, True))

        if slot == 0:
            # prior on the first keyframe (:1386-1394)
            f = graph.priors
            si = torch.tensor([1.0 / p.prior_sigma_rot] * 3
                              + [1.0 / p.prior_sigma_trans] * 3, device=dev)
            graph = graph._replace(priors=f._replace(
                idx=_set(f.idx, 0, 0),
                meas=se3.Pose(_set(f.meas.q, 0, pose.q),
                              _set(f.meas.t, 0, pose.t)),
                sqrt_info=_set(f.sqrt_info, 0, si),
                mask=_set(f.mask, 0, True)))
        else:
            # odometry factor prev -> slot (:1388-1394); a DEGENERATE match
            # gets a soft translation sigma so absolute fixes can move the
            # chain
            prev = slot - 1
            meas = se3.Pose.from_vec6(kf.pose6[prev]).between(pose)
            b = graph.betweens
            tsig = p.odom_sigma_trans * torch.where(degenerate,
                                                    p.degen_between_scale, 1.0)
            si = torch.cat([torch.full((3,), 1.0 / p.odom_sigma_rot,
                                       device=dev),
                            torch.ones(3, device=dev) / tsig])
            graph = graph._replace(betweens=b._replace(
                i=_set(b.i, prev, prev), j=_set(b.j, prev, slot),
                meas=se3.Pose(_set(b.meas.q, prev, meas.q),
                              _set(b.meas.t, prev, meas.t)),
                sqrt_info=_set(b.sqrt_info, prev, si),
                mask=_set(b.mask, prev, True)))

        # GPS factor (addGPSFactor :1397-1475): fix quality below the
        # threshold, and only while the estimator is uncertain or the match
        # degenerate
        n_gps = state.n_gps
        gps_quality_ok = torch.max(ps.gps_sigma ** 2) < p.gps_cov_threshold
        pos_cov = torch.trace(state.filter.cov[6:9, 6:9])
        pose_uncertain = (pos_cov >= p.pose_cov_threshold) | degenerate
        if to_host(ps.gps_valid & gps_quality_ok & pose_uncertain,
                   "keyframe.gps", bool):
            f = graph.gps
            gslot = min(to_host(n_gps, "keyframe.gps_slot", int),
                        f.idx.shape[0] - 1)
            gxyz, gsig = ps.gps_xyz, ps.gps_sigma
            if not p.use_gps_elevation:
                # useGpsElevation=false (:1436-1441): pin z to the estimate
                gxyz = _set(gxyz, 2, pose.t[2])
                gsig = _set(gsig, 2, 0.01)
            graph = graph._replace(gps=f._replace(
                idx=_set(f.idx, gslot, slot), xyz=_set(f.xyz, gslot, gxyz),
                sqrt_info=_set(f.sqrt_info, gslot,
                               1.0 / torch.clamp(gsig, min=1e-3)),
                mask=_set(f.mask, gslot, True)))
            n_gps = n_gps + 1

    # graph solve, skipped while only the prior + odometry chain exist (it
    # is then at its optimum by construction); GPS frees the full graph
    has_gps = torch.sum(graph.gps.mask) > 0
    free = graph.pose_mask & (
        (torch.arange(K, device=dev) >= kf.count - p.graph_window) | has_gps)
    if not p.graph_lazy_solve or to_host(has_gps | (state.n_loop > 0),
                                         "keyframe.solve", bool):
        graph = _graph_optimize(graph, p, free_mask=free, iters=2)

    # correctPoses: keyframe poses follow the graph
    opt6 = se3.Pose(graph.poses.q, graph.poses.t).to_vec6()
    kf = kf._replace(pose6=torch.where(kf.mask[:, None], opt6, kf.pose6))
    pos = kf.pose6[slot][3:]

    if not _use_incremental(p):
        # rebuild the cached local map around the (optimized) new keyframe
        local_map = _rebuild_local_map(kf, pos, scan_time, p, state.local_map)
        return state._replace(kf=kf, graph=graph, n_gps=n_gps,
                              local_map=local_map, pose6=kf.pose6[slot])

    lm = state.local_map
    # re-bake triggers: no map yet, anchor domain exceeded, or baked poses
    # drifted beyond tolerance since they were merged
    drift = torch.where(
        kf.baked,
        torch.linalg.norm(kf.pose6[:, 3:] - kf.baked_pose6[:, 3:], dim=1)
        + 5.0 * torch.linalg.norm(kf.pose6[:, :3] - kf.baked_pose6[:, :3],
                                  dim=1),
        0.0)
    need_rebake = ((~lm.valid)
                   | (torch.sum((pos - lm.anchor) ** 2) > p.map_anchor_radius ** 2)
                   | (torch.max(drift) > p.map_stale_tolerance))
    if to_host(need_rebake, "keyframe.rebake", bool):
        local_map, baked_pose6, baked = _rebake_local_map(kf, pos, scan_time, p)
    else:
        with span("merge"):
            cmom, smom = _kf_moments(kf, slot, kf.pose6[slot], lm.anchor, p)
            trim_r = p.surrounding_keyframe_search_radius
            ck, sk = _moment_group_bits(p)
            cmerged, c_drop = voxelmap.merge_moments(
                lm.corner_mom, cmom, p.map_corner_cap, trim_center=pos,
                trim_radius=trim_r, leaf=p.mapping_corner_leaf_size,
                origin=lm.anchor, group_bits=ck or 0, return_stats=True)
            smerged, s_drop = voxelmap.merge_moments(
                lm.surf_mom, smom, p.map_surf_cap, trim_center=pos,
                trim_radius=trim_r, leaf=p.mapping_surf_leaf_size,
                origin=lm.anchor, group_bits=sk or 0, return_stats=True)
        local_map = _features_from_moments(
            cmerged, smerged, lm.anchor, p,
            mom_dropped=lm.mom_dropped + torch.stack([c_drop, s_drop]))
        baked_pose6 = _set(kf.baked_pose6, slot, kf.pose6[slot])
        baked = _set(kf.baked, slot, True)
    kf = kf._replace(baked_pose6=baked_pose6, baked=baked)
    return state._replace(kf=kf, graph=graph, n_gps=n_gps,
                          local_map=local_map, pose6=kf.pose6[slot])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


class PreparedScan(NamedTuple):
    """Everything the estimator core needs from one scan, computable without
    estimator state.  Features are rotation-deskewed; each carries its mean
    firing offset ``*_dt`` so the core adds the translation deskew term
    exactly.  ``pre`` is integrated at ZERO bias; the core corrects it to the
    live bias through the preintegration's bias Jacobians."""

    corner_xyz: Tensor   # (scan_corner_cap, 3)
    corner_dt: Tensor    # (scan_corner_cap,)
    corner_mask: Tensor
    surf_xyz: Tensor     # (scan_surf_cap, 3)
    surf_dt: Tensor
    surf_mask: Tensor
    n_corner: Tensor     # pre-downsample feature counts (the `enough` gates)
    n_surf: Tensor
    deskew_on: Tensor    # () bool — rotation deskew ran
    f_mean: Tensor       # (3,) mean specific force over the scan window
    f_ok: Tensor         # () bool — >=2 IMU samples in the window
    rpy_init: Tensor     # (3,)
    imu_available: Tensor
    scan_start: Tensor
    pre: imu_ops.Preintegrated
    gps_xyz: Tensor
    gps_sigma: Tensor
    gps_valid: Tensor
    init_vel_body: Tensor
    init_vel_valid: Tensor


@traced("prepare")
def prepare_scan(inp: StepInput, p: LioParams) -> PreparedScan:
    """The state-independent part: frontend, mapping-leaf downsample
    (``downsampleCurrentScan`` :955-967), zero-bias IMU preintegration."""
    return _prepare_tail(run_frontend(inp.scan, p), inp, p)


@traced("prepare")
def prepare_scan_grid(r_grid: Tensor, az: Tensor, tcol: Tensor, elev: Tensor,
                      aux: Tensor, p: LioParams) -> PreparedScan:
    """:func:`prepare_scan` for a scan shipped as a range image: the grid
    frontend (frontend.run_frontend_grid) replaces reconstruct-then-project.
    aux carries everything else (the layout of unpack_step_input)."""
    inp = unpack_step_input(aux.new_zeros((0, 5)), aux, p)
    sc = inp.scan
    front = run_frontend_grid(r_grid, az, tcol, elev, sc.scan_start,
                              sc.imu_t, sc.imu_gyro, sc.imu_acc, sc.imu_mask,
                              sc.imu_available, p)
    return _prepare_tail(front, inp, p)


def _prepare_tail(front, inp: StepInput, p: LioParams) -> PreparedScan:
    corner_ds = voxel.voxel_downsample(front.corner, p.mapping_corner_leaf_size,
                                       capacity=p.scan_corner_cap,
                                       uniform_overflow=False)
    surf_ds = voxel.voxel_downsample(front.surf, p.mapping_surf_leaf_size,
                                     capacity=p.scan_surf_cap,
                                     uniform_overflow=False)
    dev = inp.pre_t.device
    pre = imu_ops.preintegrate(inp.pre_t, inp.pre_gyro, inp.pre_acc,
                               inp.pre_mask, imu_ops.ImuBias.zero(dev),
                               p.imu_params)
    n_imu = torch.sum(inp.scan.imu_mask.to(torch.int32))
    w = inp.scan.imu_mask.to(torch.float32)
    f_mean = (torch.sum(inp.scan.imu_acc * w[:, None], dim=0)
              / torch.clamp(torch.sum(w), min=1.0))
    return PreparedScan(
        corner_xyz=corner_ds.xyz, corner_dt=corner_ds.attrs[:, 0],
        corner_mask=corner_ds.mask,
        surf_xyz=surf_ds.xyz, surf_dt=surf_ds.attrs[:, 0],
        surf_mask=surf_ds.mask,
        n_corner=front.n_corner, n_surf=front.n_surf,
        deskew_on=inp.scan.imu_available & (n_imu > 1),
        f_mean=f_mean, f_ok=torch.sum(w) > 1,
        rpy_init=inp.scan.imu_rpy_init,
        imu_available=inp.scan.imu_available,
        scan_start=inp.scan.scan_start,
        pre=pre,
        gps_xyz=inp.gps_xyz, gps_sigma=inp.gps_sigma, gps_valid=inp.gps_valid,
        init_vel_body=inp.init_vel_body, init_vel_valid=inp.init_vel_valid,
    )


@traced("core")
def odometry_core(state: LioState, ps: PreparedScan, p: LioParams):
    """The state-dependent estimator step over a prepared scan."""
    dev = ps.scan_start.device
    lm = state.local_map
    enough = (ps.n_corner > p.edge_feature_min_valid_num) & (
        ps.n_surf > p.surf_feature_min_valid_num)
    # the step's branch flags, read back together
    initialized, has_imu, have_map, enough, imu_available = to_host(
        torch.stack([state.initialized, ps.pre.n_used > 0,
                     (state.kf.count > 0) & lm.valid, enough,
                     ps.imu_available]), "core.gates", Tensor.tolist)

    # --- filter propagation through the zero-bias preintegration, corrected
    # to the live bias (first, so the scan-start velocity can deskew)
    fs_prop = state.filter
    if initialized and has_imu:
        fs_prop = imu_fusion.propagate(state.filter, ps.pre, p.imu_params,
                                       bias_ref=imu_ops.ImuBias.zero(dev))

    corner_xyz, surf_xyz = ps.corner_xyz, ps.surf_xyz
    if p.deskew_translation:
        # translation deskew from the ESKF velocity (DEVIATION from the
        # reference, whose findPosition is stubbed): linear in each
        # feature's mean firing offset, plus the second-order term
        q_inv = se3.quat_conj(fs_prop.nav.q)
        if initialized:
            vel_body = se3.quat_rotate(q_inv, fs_prop.nav.v)
        else:
            vel_body = torch.where(ps.init_vel_valid, ps.init_vel_body, 0.0)
        g_b = se3.quat_rotate(q_inv, torch.tensor(
            [0.0, 0.0, -p.imu_gravity], device=dev))
        acc_body = torch.where(
            (state.initialized | ps.init_vel_valid) & ps.f_ok,
            ps.f_mean + g_b, 0.0)

        def shift(xyz, dt):
            d = dt[:, None]
            return xyz + torch.where(
                ps.deskew_on,
                vel_body[None, :] * d + 0.5 * acc_body[None, :] * d * d, 0.0)

        corner_xyz = shift(corner_xyz, ps.corner_dt)
        surf_xyz = shift(surf_xyz, ps.surf_dt)
    corner_ds = Cloud.create(corner_xyz, mask=ps.corner_mask)
    surf_ds = Cloud.create(surf_xyz, mask=ps.surf_mask)

    # --- initial guess (updateInitialGuess :786-845)
    rpy_init = ps.rpy_init
    if initialized:
        init6 = se3.Pose(fs_prop.nav.q, fs_prop.nav.p).to_vec6()
    else:
        init6 = torch.cat([rpy_init, torch.zeros(3, device=dev)])

    # --- scan-to-map against the cached local map
    registered = have_map and enough
    if registered and p.scan2map_method != "voxel":
        res = registration.scan_to_map(
            corner_ds.xyz, corner_ds.mask, surf_ds.xyz, surf_ds.mask,
            lm.corner_grid, lm.corner_xyz, lm.surf_grid, lm.surf_xyz,
            init6, max_iters=p.scan2map_max_iters,
            candidates_per_cell=p.knn_candidates,
            eig_threshold=p.degeneracy_threshold)
        pose6, degenerate, s2m_iters = res.pose, res.degenerate, res.iterations
    elif registered:
        res = registration.scan_to_map_voxel(
            corner_ds.xyz, corner_ds.mask, surf_ds.xyz, surf_ds.mask,
            lm.corner_vox, lm.surf_vox, init6,
            max_iters=p.scan2map_max_iters,
            eig_threshold=p.degeneracy_threshold,
            plateau_rtol=p.plateau_rtol,
            plateau_min_iters=p.plateau_min_iters,
            reassoc_rot=p.s2m_reassoc_rot,
            reassoc_trans=p.s2m_reassoc_trans)
        pose6, degenerate, s2m_iters = res.pose, res.degenerate, res.iterations
    else:
        pose6 = init6
        degenerate = torch.tensor(False, device=dev)
        s2m_iters = torch.tensor(0, dtype=torch.int32, device=dev)

    # --- transformUpdate: slerp-fuse roll/pitch with the IMU attitude
    pose6 = pose6.clone()
    if imu_available:
        w = p.imu_rpy_weight
        pose6[0] = se3.slerp_angle(pose6[0], rpy_init[0], w)
        pose6[1] = se3.slerp_angle(pose6[1], rpy_init[1], w)
    pose6[0] = torch.clamp(pose6[0], -p.rotation_tolerance, p.rotation_tolerance)
    pose6[1] = torch.clamp(pose6[1], -p.rotation_tolerance, p.rotation_tolerance)
    pose6[5] = torch.clamp(pose6[5], -p.z_tolerance, p.z_tolerance)

    # --- keyframe gate (saveFrame :1354-1379)
    last_kf6 = state.kf.pose6[torch.clamp(state.kf.count - 1, min=0)]
    d = se3.Pose.from_vec6(last_kf6).between(se3.Pose.from_vec6(pose6))
    drpy = torch.abs(se3.quat_to_rpy(d.q))
    small = torch.all(drpy < p.surrounding_keyframe_adding_angle_threshold) & (
        torch.linalg.norm(d.t) < p.surrounding_keyframe_adding_dist_threshold)
    is_kf = (state.kf.count == 0) | ~small
    if to_host(is_kf, "core.keyframe", bool):
        state2 = _insert_keyframe(state, pose6, ps.scan_start, corner_ds,
                                  surf_ds, ps, p, degenerate)
    else:
        state2 = state._replace(pose6=pose6)
    pose_out = se3.Pose.from_vec6(state2.pose6)

    # --- ESKF measurement update / (re)initialization; the update applies
    # only when scan-to-map ran (a blind update would shrink the covariance
    # without information)
    def init_filter():
        v0 = torch.where(ps.init_vel_valid,
                         se3.quat_rotate(pose_out.q, ps.init_vel_body), 0.0)
        return imu_fusion.FilterState.initial(pose_out, velocity=v0)

    if not initialized:
        fs_new = init_filter()
    elif registered:
        fs_new = imu_fusion.update_with_pose(
            fs_prop, pose_out, p.odom_sigma_rot * 10, p.odom_sigma_trans * 10,
            degenerate)
        if to_host(imu_fusion.reset_needed(fs_new), "core.reset", bool):
            fs_new = init_filter()
    else:
        fs_new = fs_prop

    # GPS position update at the filter (the navsat-EKF leg,
    # module_navsat.launch:8-19), same gate as the graph factor.  msst_tpu
    # reads these fields from an undefined name `inp` at this point
    # (mapping.py:1295-1301); the prepared scan `ps` is what carries them.
    gps_ok = (ps.gps_valid
              & (torch.max(ps.gps_sigma ** 2) < p.gps_cov_threshold)
              & ((torch.trace(fs_new.cov[6:9, 6:9]) >= p.pose_cov_threshold)
                 | degenerate))
    if initialized and to_host(gps_ok, "core.gps", bool):
        sig = ps.gps_sigma
        if not p.use_gps_elevation:
            sig = _set(sig, 2, 1e3)
        fs_new = imu_fusion.update_with_position(fs_new, ps.gps_xyz, sig)

    new_state = state2._replace(
        filter=fs_new,
        last_scan_time=ps.scan_start,
        initialized=torch.tensor(True, device=dev),
        degenerate=degenerate,
        loop_closed=torch.tensor(False, device=dev),
    )
    occ, dropped = _map_telemetry(new_state.local_map, p)
    out = StepOutput(
        pose=pose_out, pose_matrix=pose_out.to_matrix(),
        pose6=state2.pose6, velocity=fs_new.nav.v, bias=fs_new.bias,
        degenerate=degenerate, is_keyframe=is_kf,
        n_corner=ps.n_corner, n_surf=ps.n_surf,
        kf_count=new_state.kf.count,
        s2m_iterations=s2m_iters,
        map_occupancy=occ, map_dropped=dropped,
    )
    return new_state, out
