"""Single-ring LaserScan extraction.

Rebuild of ``timoo/src/timoo_laserscan`` (``timoo_laserscan.cpp:39-249``):
extract one ring (the middle one by default) from a cloud with ring indices
into a fixed-resolution polar range array (sensor_msgs/LaserScan layout).

The port's own copy of ``msst_tpu.utils.laserscan``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import numpy as np


def extract_laserscan(xyz: np.ndarray, ring: np.ndarray,
                      ring_index: int = -1, n_rings: int = 16,
                      angle_increment_deg: float = 0.2,
                      range_max: float = 130.0) -> dict:
    """ring_index=-1 picks the middle ring, like the reference default."""
    if ring_index < 0:
        ring_index = n_rings // 2
    sel = ring == ring_index
    pts = xyz[sel]
    n_bins = int(round(360.0 / angle_increment_deg))
    ranges = np.full(n_bins, np.inf, np.float32)
    if len(pts):
        az = np.arctan2(pts[:, 1], pts[:, 0])        # [-pi, pi)
        r = np.linalg.norm(pts[:, :2], axis=1)
        bins = ((az + np.pi) / (2 * np.pi) * n_bins).astype(np.int64) % n_bins
        # nearest return wins per bin
        np.minimum.at(ranges, bins, r.astype(np.float32))
    ranges[ranges > range_max] = np.inf
    return {
        "angle_min": -np.pi,
        "angle_max": np.pi,
        "angle_increment": np.radians(angle_increment_deg),
        "range_max": range_max,
        "ranges": ranges,
        "ring": ring_index,
    }
