"""Offline visualization exports (the RViz-dashboard role).

The reference's primary "observability UI" is RViz fed by visualization
topics (global map at 0.2 Hz, loop-closure MarkerArrays, paths —
``mapOptmization.cpp:421-490,723-774``).  Headless equivalents: matplotlib
figures for trajectories/maps and PLY exports viewable in any point-cloud
tool.

The port's own copy of ``msst_tpu.utils.viz``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, xyz: np.ndarray, color: np.ndarray | None = None):
    """ASCII PLY point cloud (color (N,3) uint8 optional)."""
    n = len(xyz)
    has_c = color is not None
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "w") as f:
        f.write("\n".join(header) + "\n")
        for i in range(n):
            row = f"{xyz[i, 0]:.4f} {xyz[i, 1]:.4f} {xyz[i, 2]:.4f}"
            if has_c:
                row += f" {int(color[i, 0])} {int(color[i, 1])} {int(color[i, 2])}"
            f.write(row + "\n")


def plot_trajectory(path: str, est_xyz: np.ndarray,
                    gt_xyz: np.ndarray | None = None,
                    map_xyz: np.ndarray | None = None,
                    title: str = "trajectory"):
    """Top-down trajectory (+ optional ground truth and map) to a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if map_xyz is not None and len(map_xyz):
        sub = map_xyz[:: max(1, len(map_xyz) // 50000)]
        ax.scatter(sub[:, 0], sub[:, 1], s=0.2, c="#c8c8c8", label="map")
    if gt_xyz is not None:
        ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], "g--", lw=1.5, label="ground truth")
    ax.plot(est_xyz[:, 0], est_xyz[:, 1], "b-", lw=1.5, label="estimate")
    ax.plot(est_xyz[0, 0], est_xyz[0, 1], "k^", ms=8)
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def export_session(lio, directory: str, gt_xyz: np.ndarray | None = None):
    """One-call session export: map PCDs + PLY + trajectory plot."""
    import os

    os.makedirs(directory, exist_ok=True)
    m = lio.save_map(directory)
    est = lio.trajectory.as_matrices()[:, :3, 3]
    both = np.concatenate([m["corner_map"], m["surf_map"]]) \
        if len(m["corner_map"]) or len(m["surf_map"]) else np.zeros((0, 3))
    if len(both):
        write_ply(os.path.join(directory, "global_map.ply"), both)
    plot_trajectory(os.path.join(directory, "trajectory.png"), est, gt_xyz,
                    both if len(both) else None)
    return m
