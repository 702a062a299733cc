"""GPS -> odometry-frame alignment (the robot_localization navsat role).

The reference launches robot_localization's navsat_transform + EKF
(``launch/include/module_navsat.launch:8-19``, params.yaml:98-161) to convert
GPS fixes into the odometry frame before ``addGPSFactor`` consumes them.
Here: lat/lon -> local ENU, then an incrementally re-estimated 4-dof
(yaw + translation) Umeyama alignment between the ENU track and the odometry
track; aligned fixes feed LioSam's gps_xyz input.

The port's own copy of ``msst_tpu.utils.navsat``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import numpy as np

from .io_kitti import latlon_to_enu


class NavsatAligner:
    def __init__(self, min_pairs: int = 10, max_pairs: int = 2000):
        self.enu: list = []
        self.odom: list = []
        self.datum = None
        self.min_pairs = min_pairs
        self.max_pairs = max_pairs
        self._R = np.eye(3)
        self._t = np.zeros(3)
        self._valid = False

    def add_fix(self, lat: float, lon: float, alt: float,
                odom_xyz: np.ndarray):
        if self.datum is None:
            self.datum = (lat, lon, alt)
        enu = latlon_to_enu(np.asarray([lat]), np.asarray([lon]),
                            np.asarray([alt]), *self.datum)[0]
        self.enu.append(enu)
        self.odom.append(np.asarray(odom_xyz, np.float64))
        if len(self.enu) > self.max_pairs:
            self.enu.pop(0)
            self.odom.pop(0)
        if len(self.enu) >= self.min_pairs:
            self._fit()
        return enu

    def _fit(self):
        A = np.stack(self.enu)     # gps ENU
        B = np.stack(self.odom)    # odometry frame
        # yaw-only rotation (gravity-aligned frames): fit in 2D
        a2, b2 = A[:, :2] - A[:, :2].mean(0), B[:, :2] - B[:, :2].mean(0)
        H = a2.T @ b2
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R2 = Vt.T @ np.diag([1.0, d]) @ U.T
        R = np.eye(3)
        R[:2, :2] = R2
        t = B.mean(0) - R @ A.mean(0)
        self._R, self._t = R, t
        self._valid = True

    @property
    def is_aligned(self) -> bool:
        return self._valid

    def gps_to_map(self, lat: float, lon: float, alt: float) -> np.ndarray | None:
        """Transform a fix into the odometry/map frame (or None before
        alignment converges)."""
        if self.datum is None or not self._valid:
            return None
        enu = latlon_to_enu(np.asarray([lat]), np.asarray([lon]),
                            np.asarray([alt]), *self.datum)[0]
        return (self._R @ enu + self._t).astype(np.float32)

    def covariance_gate(self, gps_cov: np.ndarray, threshold: float = 2.0) -> bool:
        """The reference's gpsCovThreshold gate (``addGPSFactor`` :1430)."""
        return float(gps_cov[0]) < threshold and float(gps_cov[4] if gps_cov.size > 4 else gps_cov[1]) < threshold
