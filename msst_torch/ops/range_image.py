"""Range-image projection, IMU deskew and ring extraction (port of
``msst_tpu.ops.range_image``; the reference's ``imageProjection`` stage).

* :func:`imu_rotation_timeline` — gyro integration over the scan window
  (``imuDeskewInfo`` :305-362)
* :func:`deskew` — per-point rotation deskew to scan start
  (``findRotation`` :446-471 + ``deskewPoint`` :489-519)
* :func:`project` — N_SCAN x H range image, first point wins a pixel
  (``projectPointCloud`` :521-572)
* :func:`extract_rings` — dense per-ring prefixes (``cloudExtraction`` :574-598)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import se3
from .numeric import div
from .pointcloud import Cloud

Tensor = torch.Tensor


class ImuWindow(NamedTuple):
    """Fixed-size masked IMU window covering one scan: t (T,), gyro (T, 3)
    rad/s in the lidar frame, acc (T, 3), mask (T,)."""

    t: Tensor
    gyro: Tensor
    acc: Tensor
    mask: Tensor


def imu_rotation_timeline(imu: ImuWindow) -> tuple[Tensor, Tensor]:
    """Per-axis forward-Euler integration of the gyro (the reference treats
    the integrated angles as Euler angles).  Returns (times (T,), rot (T, 3))
    with rot[0] = 0; invalid samples carry the previous value."""
    dt = imu.t - torch.cat([imu.t[:1], imu.t[:-1]])
    dt = torch.where(imu.mask & torch.roll(imu.mask, 1), dt, 0.0)
    dt[0] = 0.0
    inc = torch.where(imu.mask[:, None], imu.gyro * dt[:, None], 0.0)
    return imu.t, torch.cumsum(inc, dim=0)


def _interp_rotation(times: Tensor, rots: Tensor, n_valid: Tensor,
                     t_query: Tensor) -> Tensor:
    """Clamped linear interpolation of the rotation timeline at t_query,
    written as the cumulative sum of per-segment increments weighted by
    clip((q - t_{k-1}) / dt_k, 0, 1) — one (N, T) x (T, 3) matmul."""
    T = times.shape[0]
    valid = torch.arange(T, device=times.device) < n_valid
    t_safe = torch.where(valid, times, math.inf)
    t_prev = torch.cat([t_safe[:1], t_safe[:-1]])
    inc = rots - torch.cat([rots[:1], rots[:-1]])
    inc = torch.where(valid[:, None], inc, 0.0)
    w = torch.clamp((t_query[..., None] - t_prev)
                    / torch.clamp(t_safe - t_prev, min=1e-9), 0.0, 1.0)
    # invalid lanes may hold inf - inf = nan; their increments are zero, but
    # nan * 0 is nan, so zero the weights explicitly
    w = torch.where(valid, w, 0.0)
    return rots[0] + w @ inc


def deskew(xyz: Tensor, point_time: Tensor, imu_times: Tensor,
           imu_rots: Tensor, n_valid: Tensor, t_start: Tensor,
           enabled: Tensor) -> Tensor:
    """Rotate each point into the scan-start frame, composing the integrated
    gyro rotation at its firing time with the inverse of the one at
    `t_start` (``deskewPoint`` :489-519).  Translation deskew is applied
    later, to the downsampled features (mapping.odometry_core)."""
    rot_t = _interp_rotation(imu_times, imu_rots, n_valid, point_time)
    rot_start = _interp_rotation(imu_times, imu_rots, n_valid,
                                 torch.reshape(t_start, (1,)))
    q_t = se3.quat_from_rpy(rot_t)
    q_s = se3.quat_from_rpy(rot_start)
    q_bt = se3.quat_mul(se3.quat_conj(q_s), q_t)
    out = se3.quat_rotate(q_bt, xyz)
    return torch.where(enabled, out, xyz)


class RangeImage(NamedTuple):
    """rng (N_SCAN, H) (inf where empty), xyz (N_SCAN, H, 3),
    attrs (N_SCAN, H, A), valid (N_SCAN, H)."""

    rng: Tensor
    xyz: Tensor
    attrs: Tensor
    valid: Tensor


def project(cloud: Cloud, ring: Tensor, n_scan: int, horizon: int,
            min_range: float, max_range: float, downsample_rate: int = 1,
            column_mode: str = "azimuth") -> RangeImage:
    """Project a masked point set into the range image.

    "azimuth" (Velodyne/Ouster): ``col = -round((atan2(x, y)*180/pi - 90)/res)
    + H/2`` with wraparound (:544-552).  "counter" (Livox, :553-558): the
    column is a per-ring running count of gate-passing points in input
    order.  The first point in input order wins each pixel (:561-562)."""
    dev = cloud.xyz.device
    x, y = cloud.xyz[:, 0], cloud.xyz[:, 1]
    rng = torch.linalg.norm(cloud.xyz, dim=-1)
    ok = cloud.mask & (rng >= min_range) & (rng <= max_range)
    ring = ring.to(torch.int32)
    ok &= (ring >= 0) & (ring < n_scan)
    if downsample_rate > 1:
        ok &= (ring % downsample_rate) == 0

    if column_mode == "counter":
        ring_safe = torch.clamp(ring, 0, n_scan - 1).long()
        onehot = (ring_safe[:, None] == torch.arange(n_scan, device=dev)
                  ) & ok[:, None]
        cum = torch.cumsum(onehot.to(torch.int32), dim=0)
        col = torch.gather(cum, 1, ring_safe[:, None])[:, 0] - 1
    elif column_mode == "azimuth":
        ang_res = 360.0 / horizon
        horizon_angle = torch.arctan2(x, y) * (180.0 / math.pi)
        col = (-torch.round(div(horizon_angle - 90.0, ang_res))).to(
            torch.int32) + horizon // 2
        col = torch.where(col >= horizon, col - horizon, col)
    else:
        raise ValueError(f"unknown column_mode {column_mode!r}")
    ok &= (col >= 0) & (col < horizon)

    n_pix = n_scan * horizon
    flat = torch.where(ok, ring * horizon + col, n_pix).long()
    order_idx = torch.arange(cloud.capacity, device=dev)
    winner = torch.full((n_pix + 1,), cloud.capacity, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(0, flat, order_idx, reduce="amin")
    winner = winner[:n_pix]
    valid = winner < cloud.capacity
    wsafe = torch.clamp(winner, max=cloud.capacity - 1)

    A = cloud.attrs.shape[1]
    wide = torch.cat([cloud.xyz, cloud.attrs, rng[:, None]], dim=1)
    wide_img = wide[wsafe].reshape(n_scan, horizon, 4 + A)
    valid = valid.reshape(n_scan, horizon)
    img_rng = torch.where(valid, wide_img[..., 3 + A], math.inf)
    return RangeImage(img_rng, wide_img[..., :3], wide_img[..., 3:3 + A],
                      valid)


class ExtractedScan(NamedTuple):
    """Per-ring packed dense arrays: xyz (N_SCAN, H, 3), rng (N_SCAN, H),
    col (N_SCAN, H) original column, attrs (N_SCAN, H, A), count (N_SCAN,)."""

    xyz: Tensor
    rng: Tensor
    col: Tensor
    attrs: Tensor
    count: Tensor


def extract_rings(img: RangeImage) -> ExtractedScan:
    """Pack each ring's valid pixels into a prefix, stable by column: the
    key ``(~valid)*H + column`` is unique per ring, so one sort along the
    column axis is the stable partition."""
    n_scan, horizon = img.rng.shape
    iota = torch.arange(horizon, device=img.rng.device).expand(n_scan, horizon)
    key = torch.where(img.valid, iota, iota + horizon)
    key_s, order = torch.sort(key, dim=1)
    xyz = torch.gather(img.xyz, 1, order[..., None].expand(-1, -1, 3))
    rng = torch.gather(torch.where(img.valid, img.rng, math.inf), 1, order)
    A = img.attrs.shape[-1]
    attrs = torch.gather(img.attrs, 1, order[..., None].expand(-1, -1, A))
    col = torch.where(key_s < horizon, key_s, key_s - horizon)
    count = torch.sum(img.valid.to(torch.int32), dim=1)
    return ExtractedScan(xyz, rng, col, attrs, count)
