"""The benchmark's own simulator: synthetic spinning-LiDAR sweeps and IMU
samples along an analytic trajectory inside a room with box pillars.

Frozen copy of ``msst_torch/utils/sim.py`` at commit e686079 (itself a copy
of msst_tpu's), kept here so that a change to the program cannot change the
benchmark's inputs.  Changed from the source, and nothing else:

* every sweep draws its range noise from its own generator, seeded by
  (seed, scan index), and the IMU noise of the samples inside scan period b
  from one seeded by (seed, b, 1): any split of a drive over worker
  processes gives the drive that one process gives;
* the poses of a motion-true sweep's columns and of the IMU samples are
  computed as arrays (``SimTrajectory.poses``), not one call per column;
* a sweep is cast as its ranges alone (``make_sweeps``); the arrays that
  are the same in every sweep (rays, ring, per-point time, the grids) are
  made once (``Sensor``), and the box tests reduce over their three axes
  column by column (the same values in ~40 % less time on a CPU core).

The geometry (rays, room, pillars, the clockwise spin and per-point times,
the range-image grids) is the source's; a CPU test holds the two equal.
"""

from __future__ import annotations

import dataclasses
import functools

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


def _slab(o, d, lo, hi):
    """Per axis, the two distances at which a ray crosses the box's faces
    (the source's ``t1``, ``t2``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    return t1, t2


def _ray_box_interior(o, d, lo, hi):
    """Distance to the inside of a box (exit point); o strictly inside."""
    t1, t2 = _slab(o, d, lo, hi)
    tmax = np.maximum(t1, t2)
    tmax[~np.isfinite(tmax)] = np.inf
    return np.minimum(np.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])


def _ray_box_exterior(o, d, lo, hi):
    """Distance to the outside of a box; inf if missed."""
    t1, t2 = _slab(o, d, lo, hi)
    tn = np.minimum(t1, t2)
    tf = np.maximum(t1, t2)
    tn[~np.isfinite(tn)] = -np.inf
    tf[~np.isfinite(tf)] = np.inf
    t_near = np.maximum(np.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
    t_far = np.minimum(np.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    hit = (t_near <= t_far) & (t_far > 0) & (t_near > 0)
    return np.where(hit, t_near, np.inf)


@dataclasses.dataclass
class SimTrajectory:
    """Analytic smooth trajectory: a circle of `radius` at `speed`, height
    `z`, heading along the path (the source's ``kind="circle"``)."""

    radius: float = 10.0
    speed: float = 2.0     # m/s along the path
    z: float = 1.5

    def poses(self, ts) -> np.ndarray:
        """(N, 4, 4) poses at the times `ts` (N,)."""
        ts = np.asarray(ts, np.float64)
        a = (self.speed / self.radius) * ts
        T = np.zeros(ts.shape + (4, 4))
        T[..., :3, :3] = Rs.from_euler("z", (a.reshape(-1) + np.pi / 2)[:, None]
                                       ).as_matrix().reshape(ts.shape + (3, 3))
        T[..., 0, 3] = self.radius * np.cos(a)
        T[..., 1, 3] = self.radius * np.sin(a)
        T[..., 2, 3] = self.z
        T[..., 3, 3] = 1.0
        return T

    def pose(self, t: float) -> np.ndarray:
        return self.poses(np.asarray([t]))[0]


@dataclasses.dataclass(frozen=True)
class Sensor:
    """A spinning LiDAR: `n_scan` rings over `elev_limits` (deg, evenly
    spaced), `horizon` columns a sweep, one sweep every `scan_dt` s."""

    n_scan: int = 16
    horizon: int = 1800
    elev_limits: tuple = (-15.0, 15.0)
    scan_dt: float = 0.1
    max_range: float = 80.0
    noise: float = 0.01

    def grids(self) -> dict:
        """The per-column azimuth and time and the per-ring elevation: the
        same in every sweep (the range-image upload's grids)."""
        az = np.linspace(-np.pi, np.pi, self.horizon, endpoint=False)
        elev = np.radians(np.linspace(self.elev_limits[0],
                                      self.elev_limits[1], self.n_scan))
        return dict(
            azimuth=az.astype(np.float32),
            col_time=(((np.pi - az) / (2 * np.pi)) * self.scan_dt).astype(
                np.float32),
            elev=elev.astype(np.float32))

    def rays(self):
        """(d_sensor (S*H, 3), ring (S*H,) int32, time_rel (S*H,) float32,
        column fraction of the sweep (H,))."""
        az = np.linspace(-np.pi, np.pi, self.horizon, endpoint=False)
        elev = np.radians(np.linspace(self.elev_limits[0],
                                      self.elev_limits[1], self.n_scan))
        A, E = np.meshgrid(az, elev)
        d_sensor = np.stack(
            [np.cos(E) * np.cos(A), np.cos(E) * np.sin(A), np.sin(E)], axis=-1
        ).reshape(-1, 3)
        ring = np.repeat(np.arange(self.n_scan, dtype=np.int32), self.horizon)
        # clockwise spin: azimuth decreases over the sweep, as a Velodyne's
        frac = (np.pi - A.reshape(-1)) / (2 * np.pi)
        time_rel = (frac * self.scan_dt).astype(np.float32)
        return d_sensor, ring, time_rel, (np.pi - az) / (2 * np.pi)


@functools.lru_cache(maxsize=4)
def _rays(sensor: Sensor):
    """``sensor.rays()``, made once a sensor (read only)."""
    return sensor.rays()


def sweep_ranges(world: World, traj: SimTrajectory, sensor: Sensor, t0: float,
                 rng: np.random.Generator) -> np.ndarray:
    """One motion-true sweep starting at `t0`: each azimuth column is cast
    from the sensor pose at its own firing time.  Returns the (S*H,) float64
    ranges with noise (the source's ``rng_hit``)."""
    S, H = sensor.n_scan, sensor.horizon
    d_sensor, _, _, frac_col = _rays(sensor)
    Tc = traj.poses(t0 + frac_col * sensor.scan_dt)         # (H, 4, 4)
    d_world = np.einsum("jab,sjb->sja", Tc[:, :3, :3],
                        d_sensor.reshape(S, H, 3)).reshape(-1, 3)
    o = np.broadcast_to(Tc[None, :, :3, 3], (S, H, 3)).reshape(-1, 3)
    lo = np.array([world.room[0][0], world.room[1][0], world.room[2][0]])
    hi = np.array([world.room[0][1], world.room[1][1], world.room[2][1]])
    r = _ray_box_interior(o, d_world, lo, hi)
    for p in world.pillars:
        plo = np.array([p[0][0], p[1][0], p[2][0]])
        phi = np.array([p[0][1], p[1][1], p[2][1]])
        r = np.minimum(r, _ray_box_exterior(o, d_world, plo, phi))
    r = np.minimum(r, sensor.max_range)
    return r + rng.normal(scale=sensor.noise, size=r.shape)


def scan_rng(seed: int, i: int) -> np.random.Generator:
    """The generator of sweep `i`'s range noise."""
    return np.random.default_rng([seed % 2**63, i, 0])


def make_sweeps(world: World, traj: SimTrajectory, sensor: Sensor, seed: int,
                first: int, count: int, dtype=np.float32) -> np.ndarray:
    """(count, S*H) ranges of sweeps first .. first+count-1, each from its
    own generator (a worker's share of a drive)."""
    out = np.empty((count, sensor.n_scan * sensor.horizon), dtype)
    for k in range(count):
        i = first + k
        out[k] = sweep_ranges(world, traj, sensor, i * sensor.scan_dt,
                              scan_rng(seed, i))
    return out


def make_imu(traj: SimTrajectory, sensor: Sensor, n_scans: int, seed: int,
             imu_rate: float = 200.0, imu_noise_gyr: float = 1e-3,
             imu_noise_acc: float = 1e-2, gravity: float = 9.80511) -> dict:
    """The IMU stream of an `n_scans` drive (the source's ``make_dataset``
    IMU, with the noise of the samples in scan period b drawn from the
    generator seeded by (seed, b, 1)): times, gyro, accelerometer, attitude
    (roll, pitch, yaw) at every sample."""
    g = np.array([0, 0, -gravity])
    total_t = n_scans * sensor.scan_dt
    dt_imu = 1.0 / imu_rate
    ts = np.arange(0.0, total_t + 2 * dt_imu, dt_imu)
    Ts = traj.poses(ts)
    ps, Rsm = Ts[:, :3, 3], Ts[:, :3, :3]
    vs = np.gradient(ps, dt_imu, axis=0)
    accs = np.gradient(vs, dt_imu, axis=0)
    gyros = np.zeros((len(ts), 3))
    dR = np.einsum("nji,njk->nik", Rsm[:-1], Rsm[1:])
    gyros[:-1] = Rs.from_matrix(dR).as_rotvec() / dt_imu
    gyros[-1] = gyros[-2]
    f_body = np.einsum("nji,nj->ni", Rsm, accs - g)  # R^T (a - g)
    blk = np.minimum((ts / sensor.scan_dt + 1e-9).astype(np.int64),
                     n_scans)
    ng = np.empty((len(ts), 3))
    na = np.empty((len(ts), 3))
    for b in np.unique(blk):
        sel = blk == b
        r = np.random.default_rng([seed % 2**63, int(b), 1])
        k = int(sel.sum())
        ng[sel] = r.normal(scale=imu_noise_gyr, size=(k, 3))
        na[sel] = r.normal(scale=imu_noise_acc, size=(k, 3))
    return dict(t=ts, gyro=(gyros + ng).astype(np.float32),
                acc=(f_body + na).astype(np.float32),
                rpy=Rs.from_matrix(Rsm).as_euler("xyz").astype(np.float32),
                gt=Ts)


def scan_sensors(imu: dict, sensor: Sensor, i: int) -> dict:
    """Scan i's IMU slice, as the source's ``make_dataset`` cuts it: the
    samples from 0.5 s before the sweep to 0.05 s after it, and the
    attitude at the sweep's start."""
    ts = imu["t"]
    t0 = i * sensor.scan_dt
    lo = int(np.searchsorted(ts, t0 - 0.5 - 1e-9))
    hi = int(np.searchsorted(ts, t0 + sensor.scan_dt + 0.05 + 1e-9,
                             side="right"))
    sel = slice(lo, hi)
    # the source selects by (ts >= t0 - 0.5) & (ts <= t0 + dt + 0.05)
    sel_mask = (ts[sel] >= t0 - 0.5) & (ts[sel] <= t0 + sensor.scan_dt + 0.05)
    k0 = min(int(np.searchsorted(ts, t0)), len(ts) - 1)
    return dict(imu_t=ts[sel][sel_mask].astype(np.float32),
                imu_gyro=imu["gyro"][sel][sel_mask],
                imu_acc=imu["acc"][sel][sel_mask],
                imu_rpy=imu["rpy"][k0])
