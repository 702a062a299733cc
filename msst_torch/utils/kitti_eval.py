"""KITTI odometry evaluation metrics.

The standard KITTI benchmark protocol (translational % / rotational deg/m
drift averaged over trajectory segments of 100..800 m) plus ATE/RPE — the
quantitative harness the reference lacks (SURVEY.md §4: validation there is
rosbag replay + RViz eyeballing; accuracy numbers live in the LIO-SAM paper).

The port's own copy of ``msst_tpu.utils.kitti_eval``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.zeros(len(poses))
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    d[1:] = np.cumsum(steps)
    return d


def _rot_error_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def kitti_segment_errors(est: np.ndarray, gt: np.ndarray,
                         lengths=SEGMENT_LENGTHS, step: int = 10) -> list[dict]:
    """Per-segment relative errors, KITTI protocol.

    est, gt: (N, 4, 4) aligned pose arrays (same timestamps).
    Returns list of {length, t_err (%), r_err (deg/m)} entries."""
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    dist = _trajectory_distances(gt)
    errors = []
    for first in range(0, n, step):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[last]
            est_rel = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(est_rel) @ gt_rel
            t_err = np.linalg.norm(err[:3, 3]) / length * 100.0
            r_err = _rot_error_deg(err[:3, :3]) / length
            errors.append({"length": length, "first": first,
                           "t_err_pct": t_err, "r_err_deg_per_m": r_err})
    return errors


def kitti_summary(est: np.ndarray, gt: np.ndarray) -> dict:
    errs = kitti_segment_errors(est, gt)
    if not errs:
        return {"t_err_pct": float("nan"), "r_err_deg_per_m": float("nan"),
                "n_segments": 0}
    return {
        "t_err_pct": float(np.mean([e["t_err_pct"] for e in errs])),
        "r_err_deg_per_m": float(np.mean([e["r_err_deg_per_m"] for e in errs])),
        "n_segments": len(errs),
    }


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error of positions after Umeyama alignment."""
    e, g = est[:, :3, 3], gt[:, :3, 3]
    n = min(len(e), len(g))
    e, g = e[:n], g[:n]
    if align and n >= 3:
        mu_e, mu_g = e.mean(0), g.mean(0)
        H = (e - mu_e).T @ (g - mu_g)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        e = (e - mu_e) @ R.T + mu_g
    return float(np.sqrt(np.mean(np.sum((e - g) ** 2, axis=1))))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> dict:
    """Relative pose error over a fixed frame delta (TUM protocol)."""
    n = min(len(est), len(gt)) - delta
    terr, rerr = [], []
    for i in range(n):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + delta]
        est_rel = np.linalg.inv(est[i]) @ est[i + delta]
        err = np.linalg.inv(est_rel) @ gt_rel
        terr.append(np.linalg.norm(err[:3, 3]))
        rerr.append(_rot_error_deg(err[:3, :3]))
    return {
        "rpe_trans_rmse_m": float(np.sqrt(np.mean(np.square(terr)))),
        "rpe_rot_rmse_deg": float(np.sqrt(np.mean(np.square(rerr)))),
    }
