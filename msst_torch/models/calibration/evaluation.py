"""Calibration accuracy evaluation: RMSE vs ground-truth extrinsics.

Rebuild of ``Multi_LiCa/evaluation/evaluation.py:40-105`` (absolute) and
``evaluation_rel.py:10-60`` (relative): translation RMSE [m] and rotation
RMSE [deg] between estimated and ground-truth poses, absolute (per sensor vs
GT) and relative (between sensor pairs).  A copy of msst_tpu's numpy module
that also takes the port's poses (tensors on any device).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_matrix(p) -> np.ndarray:
    if hasattr(p, "to_matrix"):
        return _as_numpy(p.to_matrix())
    return _as_numpy(p)


def _rot_angle_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def calibration_rmse(estimated: Sequence, ground_truth: Sequence) -> dict:
    """Absolute translation/rotation RMSE over matched pose lists."""
    terr, rerr = [], []
    for e, g in zip(estimated, ground_truth):
        Te, Tg = _as_matrix(e), _as_matrix(g)
        terr.append(np.linalg.norm(Te[:3, 3] - Tg[:3, 3]))
        rerr.append(_rot_angle_deg(Te[:3, :3].T @ Tg[:3, :3]))
    terr, rerr = np.asarray(terr), np.asarray(rerr)
    return {
        "translation_rmse_m": float(np.sqrt(np.mean(terr**2))),
        "rotation_rmse_deg": float(np.sqrt(np.mean(rerr**2))),
        "translation_errors_m": terr.tolist(),
        "rotation_errors_deg": rerr.tolist(),
    }


def relative_calibration_rmse(estimated: Sequence, ground_truth: Sequence) -> dict:
    """Pairwise-relative RMSE (``evaluation_rel.py``): errors of T_i^-1 T_j."""
    n = len(estimated)
    terr, rerr = [], []
    for i in range(n):
        for j in range(i + 1, n):
            Ei = _as_matrix(estimated[i])
            Ej = _as_matrix(estimated[j])
            Gi = _as_matrix(ground_truth[i])
            Gj = _as_matrix(ground_truth[j])
            Re = np.linalg.inv(Ei) @ Ej
            Rg = np.linalg.inv(Gi) @ Gj
            D = np.linalg.inv(Re) @ Rg
            terr.append(np.linalg.norm(D[:3, 3]))
            rerr.append(_rot_angle_deg(D[:3, :3]))
    terr, rerr = np.asarray(terr), np.asarray(rerr)
    return {
        "rel_translation_rmse_m": float(np.sqrt(np.mean(terr**2))),
        "rel_rotation_rmse_deg": float(np.sqrt(np.mean(rerr**2))),
    }
