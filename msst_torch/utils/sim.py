"""Synthetic LiDAR + IMU simulator (host-side NumPy).

Stands in for the reference's rosbag replay datasets (the 8 sample bags of
``liosam_ws/src/LIO-SAM/README.md:129-146`` are external downloads): an
axis-aligned room with box pillars, raycast spinning-LiDAR scans along an
analytic trajectory, and consistent IMU samples — used by the integration
tests, the demo and bench.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial.transform import Rotation as Rs


@dataclasses.dataclass
class World:
    """Interior of a room [xmin,xmax]x[ymin,ymax]x[0,zmax] with box pillars."""

    room: tuple = ((-30.0, 30.0), (-20.0, 20.0), (0.0, 6.0))
    pillars: tuple = (
        ((-12, -10), (-8, -6), (0, 6)),
        ((8, 10), (-12, -10), (0, 6)),
        ((10, 12), (8, 10), (0, 6)),
        ((-15, -13), (9, 11), (0, 6)),
        ((-2, 0), (-2, 0), (0, 6)),
    )


def corridor_world(length=170.0, half_width=3.0, height=5.0):
    """Long featureless corridor (two smooth walls + floor + ceiling, no
    pillars): translation along the corridor axis is unobservable from the
    lidar alone — the scan-to-map degeneracy projection
    (``mapOptmization.cpp:1229-1258``) must fire and the IMU must carry the
    along-axis state (round-3 VERDICT #4 adversarial workload)."""
    return World(room=((-10.0, length), (-half_width, half_width),
                       (0.0, height)),
                 pillars=())


def dumbbell_world(length=150.0, half_width=5.0, height=5.0):
    """Two feature-rich pillar zones joined by a long featureless corridor —
    the loop-closure-under-real-drift workload (round-3 VERDICT #5).

    Driving end-to-end accumulates along-axis drift in the blind mid-span
    (the corridor makes x unobservable; the IMU carries it), which is BAKED
    into the far zone's keyframes; on return, the start zone's old map
    disagrees with the drifted estimate by more than the scan-to-map
    correspondence basin, and only loop closure (ICP over the old submap +
    graph correction, ``performLoopClosure``/``correctPoses``
    ``mapOptmization.cpp:529-608,1583-1614``) can remove it."""
    near = ((-6.0, -4.5), (-3.5, -2.0)), ((-8.0, -6.5), (1.0, 2.5)), \
        ((-3.0, -1.5), (2.0, 3.5))
    far = ((length - 6.0, length - 4.5), (-3.0, -1.5)), \
        ((length - 8.5, length - 7.0), (1.5, 3.0)), \
        ((length - 3.5, length - 2.0), (-1.0, 0.5))
    return World(room=((-12.0, length + 4.0), (-half_width, half_width),
                       (0.0, height)),
                 pillars=tuple((x, y, (0.0, height)) for x, y in near + far))


def _ray_box_interior(o, d, lo, hi):
    """Distance to the inside of a box (exit point); o strictly inside."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    tmax = np.maximum(t1, t2)
    tmax[~np.isfinite(tmax)] = np.inf
    return np.min(tmax, axis=-1)


def _ray_box_exterior(o, d, lo, hi):
    """Distance to the outside of a box; inf if missed."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    tn = np.minimum(t1, t2)
    tf = np.maximum(t1, t2)
    tn[~np.isfinite(tn)] = -np.inf
    tf[~np.isfinite(tf)] = np.inf
    t_near = np.max(tn, axis=-1)
    t_far = np.min(tf, axis=-1)
    hit = (t_near <= t_far) & (t_far > 0) & (t_near > 0)
    return np.where(hit, t_near, np.inf)


def raycast_scan(world: World, pose: np.ndarray, n_scan=16, horizon=360,
                 max_range=80.0, noise=0.01, rng=None,
                 elev_limits=(-15.0, 15.0), spin_period=0.1,
                 traj=None, t0=0.0):
    """One spinning-LiDAR scan from 4x4 pose.  Returns (xyz, ring, time_rel, ri)
    in the SENSOR frame with per-point time offsets over one revolution.

    traj: optional :class:`SimTrajectory` — when given, each azimuth column
    is cast from the sensor pose at its own firing time ``t0 + time_rel``
    (motion-true sweep: points are reported in the INSTANTANEOUS sensor
    frame, like a real spinning lidar, so scans of a moving platform are
    skewed and the pipeline's deskew is exercised for real).  Without it the
    whole scan is a static snapshot from `pose` (the pre-round-3 behavior:
    that snapshot made the gyro-driven deskew CORRUPT sim scans by the
    rotation covered per sweep, ~1.1 deg at the bench's 0.2 rad/s)."""
    rng = rng or np.random.default_rng(0)
    az = np.linspace(-np.pi, np.pi, horizon, endpoint=False)
    elev = np.radians(np.linspace(elev_limits[0], elev_limits[1], n_scan))
    A, E = np.meshgrid(az, elev)  # (n_scan, horizon)
    d_sensor = np.stack(
        [np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], axis=-1
    ).reshape(-1, 3)
    if traj is not None:
        frac_col = (np.pi - az) / (2 * np.pi)
        Rs_col = np.empty((horizon, 3, 3))
        t_col = np.empty((horizon, 3))
        for j in range(horizon):
            Tj = traj.pose(t0 + frac_col[j] * spin_period)
            Rs_col[j] = Tj[:3, :3]
            t_col[j] = Tj[:3, 3]
        # rays grouped (n_scan, horizon, 3): column j uses pose(t_j)
        d_sens_img = d_sensor.reshape(n_scan, horizon, 3)
        d_world = np.einsum("jab,sjb->sja", Rs_col, d_sens_img).reshape(-1, 3)
        o = np.broadcast_to(t_col[None], (n_scan, horizon, 3)).reshape(-1, 3)
    else:
        R, t = pose[:3, :3], pose[:3, 3]
        d_world = d_sensor @ R.T
        o = np.broadcast_to(t, d_world.shape)

    lo = np.array([world.room[0][0], world.room[1][0], world.room[2][0]])
    hi = np.array([world.room[0][1], world.room[1][1], world.room[2][1]])
    rng_hit = _ray_box_interior(o, d_world, lo, hi)
    for p in world.pillars:
        plo = np.array([p[0][0], p[1][0], p[2][0]])
        phi = np.array([p[0][1], p[1][1], p[2][1]])
        rng_hit = np.minimum(rng_hit, _ray_box_exterior(o, d_world, plo, phi))

    rng_hit = np.minimum(rng_hit, max_range)
    rng_hit = rng_hit + rng.normal(scale=noise, size=rng_hit.shape)
    xyz = (d_sensor * rng_hit[:, None]).astype(np.float32)
    ring = np.repeat(np.arange(n_scan, dtype=np.int32), horizon)
    # per-point time: column angle -> fraction of revolution.  CLOCKWISE
    # spin (azimuth decreases over the sweep), matching real Velodynes and
    # the KITTI reader's azimuth-time reconstruction
    # (io_kitti.KittiRawDrive.scan) — a counter-clockwise sim made that
    # reader REVERSE per-point times on synthetic KITTI drives, turning
    # deskew into a skew doubler (round-3 KITTI report regression).
    frac = (np.pi - A.reshape(-1)) / (2 * np.pi)
    time_rel = (frac * spin_period).astype(np.float32)
    # grid structure for the range-image upload path (the pipeline ships
    # ranges + per-column azimuth/time + per-ring elevation and
    # reconstructs xyz in-program — mapping.odometry_window_flat_ri)
    ri = dict(
        ranges=np.maximum(rng_hit, 0.0).astype(np.float32),
        azimuth=az.astype(np.float32),
        col_time=(((np.pi - az) / (2 * np.pi)) * spin_period).astype(
            np.float32),
        elev=elev.astype(np.float32),
    )
    return xyz, ring, time_rel, ri


@dataclasses.dataclass
class SimTrajectory:
    """Analytic smooth trajectory p(t), yaw(t) inside the room."""

    kind: str = "circle"   # circle | line | figure8 | shuttle
    radius: float = 10.0
    speed: float = 2.0     # m/s along the path
    z: float = 1.5
    period: float = 6.0    # shuttle: out-and-back duration [s]
    x0: float = -20.0      # line/shuttle: start x
    y0: float = -10.0      # line/shuttle: fixed y
    ramp: float = 0.0      # line: seconds to accelerate from REST to speed.
    # 0 keeps the legacy instant-velocity drive — note that one is physically
    # information-free for an IMU (constant velocity from t=0 means the
    # accelerometer never sees the motion), so degenerate-geometry drives
    # that rely on inertial dead reckoning should set a ramp.

    def _line_arc(self, t: float) -> float:
        if self.ramp <= 0:
            return self.speed * t
        if t < self.ramp:  # constant acceleration speed/ramp from rest
            return self.speed * t * t / (2.0 * self.ramp)
        return self.speed * (t - self.ramp / 2.0)

    def pose(self, t: float) -> np.ndarray:
        if self.kind == "line":
            p = np.array([self._line_arc(t) + self.x0, self.y0, self.z])
            yaw = 0.0
        elif self.kind == "shuttle":
            # smooth out-and-back along x (returns to start at t=period)
            amp = self.speed * self.period / np.pi
            p = np.array([
                self.x0 + 20.0
                + amp * 0.5 * (1 - np.cos(2 * np.pi * t / self.period)),
                self.y0, self.z,
            ])
            yaw = 0.0
        elif self.kind == "figure8":
            w = self.speed / self.radius
            p = np.array([
                self.radius * np.sin(w * t),
                self.radius * np.sin(w * t) * np.cos(w * t),
                self.z,
            ])
            dp = np.array([
                self.radius * w * np.cos(w * t),
                self.radius * w * np.cos(2 * w * t),
                0.0,
            ])
            yaw = np.arctan2(dp[1], dp[0])
        else:  # circle
            w = self.speed / self.radius
            a = w * t
            p = np.array([self.radius * np.cos(a), self.radius * np.sin(a), self.z])
            yaw = a + np.pi / 2
        T = np.eye(4)
        T[:3, :3] = Rs.from_euler("z", yaw).as_matrix()
        T[:3, 3] = p
        return T


def make_dataset(world: World, traj: SimTrajectory, n_scans=40, scan_dt=0.1,
                 imu_rate=200.0, n_scan=16, horizon=360, noise=0.01,
                 imu_noise_gyr=1e-3, imu_noise_acc=1e-2, gravity=9.80511,
                 imu_bias_gyr=0.0, imu_bias_acc=0.0, imu_bias_ramp=0.0,
                 elev_limits=(-15.0, 15.0),
                 seed=0):
    """Returns a list of per-scan dicts: xyz/ring/time/scan_start/imu_*/gt_pose.

    IMU samples are generated at imu_rate on the same clock, with body rates
    and specific force derived from the trajectory by finite differences.

    IMU degradation knobs (round-3 VERDICT #4 — adversarial drives for the
    robustness machinery): ``imu_bias_gyr``/``imu_bias_acc`` add a constant
    per-axis bias [rad/s, m/s^2]; ``imu_bias_ramp`` scales a linear drift of
    that bias over the run (bias(t) = bias * (1 + ramp * t / total_t)),
    emulating a warming MEMS IMU.  The estimator's bias states / ESKF gates
    must absorb these (the reference's failure gates:
    ``imuPreintegration.cpp:438-456``)."""
    rng = np.random.default_rng(seed)
    g = np.array([0, 0, -gravity])

    # dense pose samples for IMU derivation
    total_t = n_scans * scan_dt
    dt_imu = 1.0 / imu_rate
    ts = np.arange(0.0, total_t + 2 * dt_imu, dt_imu)
    Ts = np.stack([traj.pose(t) for t in ts])
    ps = Ts[:, :3, 3]
    Rsm = Ts[:, :3, :3]

    vs = np.gradient(ps, dt_imu, axis=0)
    accs = np.gradient(vs, dt_imu, axis=0)
    gyros = np.zeros((len(ts), 3))
    for k in range(len(ts) - 1):
        dR = Rsm[k].T @ Rsm[k + 1]
        gyros[k] = Rs.from_matrix(dR).as_rotvec() / dt_imu
    gyros[-1] = gyros[-2]
    f_body = np.einsum("nji,nj->ni", Rsm, accs - g)  # R^T (a - g)

    ramp = (1.0 + imu_bias_ramp * ts / max(total_t, 1e-9))[:, None]
    bias_g = imu_bias_gyr * np.array([1.0, -0.7, 0.5]) * ramp
    bias_a = imu_bias_acc * np.array([0.6, 1.0, -0.4]) * ramp
    gyro_meas = (gyros + bias_g
                 + rng.normal(scale=imu_noise_gyr, size=gyros.shape))
    acc_meas = (f_body + bias_a
                + rng.normal(scale=imu_noise_acc, size=f_body.shape))
    rpys = Rs.from_matrix(Rsm).as_euler("xyz")

    scans = []
    for i in range(n_scans):
        t0 = i * scan_dt
        T = traj.pose(t0)
        xyz, ring, time_rel, ri = raycast_scan(
            world, T, n_scan=n_scan, horizon=horizon, noise=noise, rng=rng,
            spin_period=scan_dt, traj=traj, t0=t0, elev_limits=elev_limits)
        sel = (ts >= t0 - 0.5) & (ts <= t0 + scan_dt + 0.05)
        k0 = int(np.searchsorted(ts, t0))
        scans.append(dict(
            xyz=xyz, ring=ring, time_rel=time_rel, scan_start=t0,
            imu_t=ts[sel].astype(np.float32),
            imu_gyro=gyro_meas[sel].astype(np.float32),
            imu_acc=acc_meas[sel].astype(np.float32),
            imu_rpy=rpys[min(k0, len(rpys) - 1)].astype(np.float32),
            gt_pose=T,
            **ri,
        ))
    return scans
