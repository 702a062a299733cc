"""KITTI raw-dataset reader (the kitti2bag role, host-side).

Rebuild of ``liosam_ws/src/LIO-SAM/config/doc/kitti2bag/kitti2bag.py``: reads
KITTI raw drives (velodyne .bin scans + OXTS IMU/GPS text files + timestamps)
and yields the per-scan dicts the LIO pipeline consumes — without going
through rosbag.  Ring indices are reconstructed from the vertical angle (the
HDL-64E has no ring field in the .bin files).

The port's own copy of ``msst_tpu.utils.io_kitti``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import datetime as _dt
import glob
import os

import numpy as np

# OXTS packet layout (kitti2bag.py save_imu_data_raw / save_gps_fix_data)
OXTS_FIELDS = [
    "lat", "lon", "alt", "roll", "pitch", "yaw",
    "vn", "ve", "vf", "vl", "vu",
    "ax", "ay", "az", "af", "al", "au",
    "wx", "wy", "wz", "wf", "wl", "wu",
    "pos_accuracy", "vel_accuracy", "navstat", "numsats",
    "posmode", "velmode", "orimode",
]


def read_velodyne_bin(path: str) -> np.ndarray:
    """(N, 4) x, y, z, intensity float32."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def rings_from_elevation(xyz: np.ndarray, n_rings: int = 64,
                         elev_limits: tuple | None = None) -> np.ndarray:
    """Assign ring ids by elevation-angle binning.

    ``elev_limits`` (lo_deg, hi_deg) defaults to the HDL-64E span
    (-24.9..2.0) only for 64-ring data; for other ring counts the span is
    inferred from the data (robust percentiles) — a fixed HDL-64 span fed
    with e.g. VLP-16 geometry (+-15 deg) collapses everything above +2 deg
    into the top ring and leaves the bottom rings empty, scrambling the
    range image's row structure."""
    el = np.degrees(np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1)))
    if elev_limits is None:
        if n_rings == 64:
            elev_limits = (-24.9, 2.0)
        else:
            fin = el[np.isfinite(el) & (np.linalg.norm(xyz[:, :2], axis=1)
                                        > 1e-3)]
            if len(fin) == 0:
                elev_limits = (-24.9, 2.0)
            else:
                elev_limits = (float(np.percentile(fin, 0.2)),
                               float(np.percentile(fin, 99.8)))
    lo, hi = elev_limits
    hi = max(hi, lo + 1e-3)
    ring = ((el - lo) / (hi - lo) * (n_rings - 1)).round().astype(np.int32)
    return np.clip(ring, 0, n_rings - 1)


def _read_timestamps(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # 2011-09-30 12:40:59.442522 (kitti format, ns precision trimmed)
            d = _dt.datetime.fromisoformat(line[:26])
            out.append(d.timestamp())
    return np.asarray(out)


def latlon_to_enu(lat, lon, alt, lat0, lon0, alt0):
    """Small-area equirectangular ENU (adequate for drive-length scales)."""
    re = 6378137.0
    d_lat = np.radians(lat - lat0)
    d_lon = np.radians(lon - lon0)
    x = d_lon * re * np.cos(np.radians(lat0))
    y = d_lat * re
    z = alt - alt0
    return np.stack([x, y, z], axis=-1)


class KittiRawDrive:
    """Reader for an extracted KITTI raw drive directory
    (``<base>/<date>/<date>_drive_<id>_sync`` layout)."""

    def __init__(self, drive_dir: str, n_rings: int = 64,
                 imu_extrinsics=None):
        """imu_extrinsics: :class:`~msst_torch.utils.imu_adapter.ImuExtrinsics`
        applied to every IMU sample (the reference's ``imuConverter``,
        ``utility.h:252-282``).  When None, ``calib_imu_to_velo.txt`` is
        auto-loaded from the date directory (KITTI ships the IMU->velodyne
        extrinsic there; ``kitti2bag.py`` carries it as a /tf instead)."""
        from .imu_adapter import ImuExtrinsics, load_kitti_imu_extrinsics

        self.dir = drive_dir
        self.n_rings = n_rings
        if imu_extrinsics is None:
            calib = os.path.join(os.path.dirname(os.path.abspath(drive_dir)),
                                 "calib_imu_to_velo.txt")
            imu_extrinsics = (load_kitti_imu_extrinsics(calib)
                              if os.path.exists(calib)
                              else ImuExtrinsics.identity())
        self.imu_extrinsics = imu_extrinsics
        self._elev_limits = None  # pinned from the first scan: per-scan
        # percentile inference would jitter the ring bin edges across scans
        self.velo_files = sorted(
            glob.glob(os.path.join(drive_dir, "velodyne_points", "data", "*.bin")))
        self.velo_times = _read_timestamps(
            os.path.join(drive_dir, "velodyne_points", "timestamps.txt"))
        oxts_files = sorted(
            glob.glob(os.path.join(drive_dir, "oxts", "data", "*.txt")))
        self.oxts_times = _read_timestamps(
            os.path.join(drive_dir, "oxts", "timestamps.txt"))
        self.oxts = np.stack([np.loadtxt(f) for f in oxts_files]) if oxts_files else None

    def __len__(self):
        return len(self.velo_files)

    def imu_samples(self):
        """(T,), (T, 3) gyro [rad/s], (T, 3) acc [m/s^2], (T, 3) rpy."""
        o = self.oxts
        idx = {k: i for i, k in enumerate(OXTS_FIELDS)}
        gyro = o[:, [idx["wx"], idx["wy"], idx["wz"]]]
        acc = o[:, [idx["ax"], idx["ay"], idx["az"]]]
        rpy = o[:, [idx["roll"], idx["pitch"], idx["yaw"]]]
        return self.oxts_times, gyro, acc, rpy

    def gps_enu(self):
        o = self.oxts
        idx = {k: i for i, k in enumerate(OXTS_FIELDS)}
        lat, lon, alt = o[:, idx["lat"]], o[:, idx["lon"]], o[:, idx["alt"]]
        return latlon_to_enu(lat, lon, alt, lat[0], lon[0], alt[0])

    def scan(self, i: int):
        pts = read_velodyne_bin(self.velo_files[i])
        xyz = pts[:, :3]
        if self._elev_limits is None:
            if self.n_rings == 64:
                self._elev_limits = (-24.9, 2.0)
            else:
                el = np.degrees(np.arctan2(
                    xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1)))
                fin = el[np.isfinite(el)
                         & (np.linalg.norm(xyz[:, :2], axis=1) > 1e-3)]
                self._elev_limits = (
                    (float(np.percentile(fin, 0.2)),
                     float(np.percentile(fin, 99.8)))
                    if len(fin) else (-24.9, 2.0))
        ring = rings_from_elevation(xyz, self.n_rings,
                                    elev_limits=self._elev_limits)
        # per-point time from azimuth (KITTI scans are motion-compensated to
        # the scan center; this reconstructs approximate per-point times)
        az = np.arctan2(xyz[:, 1], xyz[:, 0])
        time_rel = ((np.pi - az) / (2 * np.pi) * 0.1).astype(np.float32)
        return dict(xyz=xyz.astype(np.float32), ring=ring,
                    time_rel=time_rel, intensity=pts[:, 3],
                    scan_start=float(self.velo_times[i]))

    def iter_scans(self, with_imu=True, imu_window=0.5, with_gps=False,
                   gps_max_age=0.2):
        """Yield per-scan dicts; ``with_gps`` additionally attaches the OXTS
        GNSS fix nearest each scan as ``gps_xyz`` (ENU, first fix = origin)
        + ``gps_sigma`` (per-axis m, from ``pos_accuracy``) — the reference's
        ``gpsHandler``/``addGPSFactor`` input (``mapOptmization.cpp:96-120,
        1397-1475``; kitti2bag publishes the same fix as /gps/fix).  A fix
        older than ``gps_max_age`` s is dropped (no ``gps_xyz`` key)."""
        t_imu, gyro, acc, rpy = self.imu_samples() if with_imu else (None,) * 4
        if with_imu and t_imu is not None \
                and not self.imu_extrinsics.is_identity():
            from .imu_adapter import convert_imu
            gyro, acc, rpy = convert_imu(self.imu_extrinsics, gyro, acc,
                                         rpy=rpy)
        enu = pos_acc = None
        if with_gps and self.oxts is not None:
            enu = self.gps_enu()
            ia = OXTS_FIELDS.index("pos_accuracy")
            pos_acc = (self.oxts[:, ia] if self.oxts.shape[1] > ia
                       else np.full(len(enu), 2.0))
        for i in range(len(self)):
            s = self.scan(i)
            if with_imu and t_imu is not None:
                t0 = s["scan_start"]
                sel = (t_imu >= t0 - imu_window) & (t_imu <= t0 + 0.15)
                k0 = int(np.searchsorted(t_imu, t0))
                s.update(
                    # times stay float64: absolute stamps in float32 collapse
                    # dt to zero (LioSam rebases to its session epoch)
                    imu_t=t_imu[sel],
                    imu_gyro=gyro[sel].astype(np.float32),
                    imu_acc=acc[sel].astype(np.float32),
                    imu_rpy=rpy[min(k0, len(rpy) - 1)].astype(np.float32),
                )
            if enu is not None:
                t0 = s["scan_start"]
                k = int(np.clip(np.searchsorted(self.oxts_times, t0),
                                0, len(enu) - 1))
                if k > 0 and (t0 - self.oxts_times[k - 1]
                              < self.oxts_times[k] - t0):
                    k -= 1
                if abs(self.oxts_times[k] - t0) <= gps_max_age:
                    s.update(
                        gps_xyz=enu[k].astype(np.float32),
                        gps_sigma=np.full(3, max(float(pos_acc[k]), 1e-2),
                                          np.float32),
                    )
            yield s
