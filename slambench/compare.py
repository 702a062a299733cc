"""What decides ``correct``: the program's outputs of the window against the
plain reference (``slambench/ref``) driven over the same inputs.

The reference repeats the program's calls on its own state: the set-up's
boot, fast-forward and flush, then the first ``compare_scans`` scans of the
window, a window at a time where the cell feeds windows (the synchronous
``process_window`` in place of the asynchronous one, which steps the same
scans on another thread).  It runs after the window, once the program's
state is freed, in float32 with TF32 off as the configuration states.

The numbers compared, each against the cell's limit
(``limits/<cell>.json``):

* ``pose_gap_m``, ``rot_gap_rad``: the widest gap over the compared scans
  between the program's pose and the reference's, in position and in
  rotation angle;
* ``kf_gap_m``: the widest position gap between the keyframe stores once
  the compared scans are through (the poses the graph leaves after loop
  closures), where the cell feeds scan by scan; a different keyframe count
  reads inf;
* ``loops_diff``: the loops closed by then, program less reference, as an
  absolute count.

A compared pose that is missing or not finite reads inf.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np

# the ground-truth gates of bench.py, reported beside `correct`
DRIFT_GATE_PCT_PER_M = 0.5
FINAL_GATE_M = 0.10


@contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for every float32 matmul while the context lasts."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def reference_run(cell: dict, drive, n_cmp: int, device, tf32: bool = False):
    """The reference's poses of the first `n_cmp` window scans (n, 4, 4)
    and its keyframe snapshot after them; with `tf32` the control."""
    import torch

    from . import cell as cell_mod
    from .ref.models import liosam as L
    t = cell["traffic"]
    with matmul_precision(tf32):
        lio = cell_mod.make_lio(L, cell, device)
        cell_mod.feed_setup(lio, drive, cell)
        start = cell_mod.setup_scans(cell)
        outs = cell_mod.feed(lio, drive.scans[start:start + n_cmp],
                             t["window"])
        rows = cell_mod.pose_rows(outs)
        poses = (torch.stack(rows).cpu().numpy() if rows
                 else np.zeros((0, 4, 4), np.float32))
        snap = {k: v.cpu().numpy()
                for k, v in cell_mod.keyframe_snapshot(lio).items()}
    del lio, outs, rows
    return poses, snap


def _rot_angle(Ra, Rb) -> np.ndarray:
    """The angle between two rotations, from their chord: for rotation
    matrices ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2), which reads 0 for
    equal float32 matrices (arccos of the trace does not)."""
    d = np.linalg.norm((Ra.astype(np.float64) - Rb).reshape(len(Ra), -1),
                       axis=1)
    return 2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def gaps(prog_poses, ref_poses, prog_snap: dict, ref_snap: dict) -> dict:
    """The numbers compared (module docstring)."""
    n = len(ref_poses)
    out = {"pose_gap_m": math.inf, "rot_gap_rad": math.inf}
    if len(prog_poses) >= n > 0:
        P, R = prog_poses[:n], ref_poses
        if np.isfinite(P).all() and np.isfinite(R).all():
            out["pose_gap_m"] = float(np.max(np.linalg.norm(
                P[:, :3, 3].astype(np.float64) - R[:, :3, 3], axis=1)))
            out["rot_gap_rad"] = float(np.max(_rot_angle(P[:, :3, :3],
                                                         R[:, :3, :3])))
    if ref_snap and prog_snap:
        k = int(ref_snap["kf_count"])
        if int(prog_snap["kf_count"]) != k:
            out["kf_gap_m"] = math.inf
        else:
            a = prog_snap["kf_pose6"][:k, 3:].astype(np.float64)
            b = ref_snap["kf_pose6"][:k, 3:].astype(np.float64)
            out["kf_gap_m"] = (float(np.max(np.linalg.norm(a - b, axis=1)))
                               if np.isfinite(a).all() else math.inf)
        out["loops_diff"] = float(abs(int(prog_snap["n_loop"])
                                      - int(ref_snap["n_loop"])))
    return out


def compared_scans(cell: dict, n_window: int) -> int:
    """The window scans compared: the cell's ``compare_scans``, fewer where
    the window fed fewer, in whole windows."""
    W = cell["traffic"]["window"]
    n = min(int(cell["traffic"]["compare_scans"]), n_window)
    return n - n % W


def check(cell: dict, drive, prog_poses, prog_snap: dict, n_window: int,
          device):
    """({number: {value, limit}} for every number compared, correct, the
    scans compared and the reference's seconds): correct where every number
    is within its limit and at least one scan was compared."""
    import time

    n_cmp = compared_scans(cell, n_window)
    t0 = time.perf_counter()
    if n_cmp:
        ref_poses, ref_snap = reference_run(cell, drive, n_cmp, device)
    else:
        ref_poses, ref_snap = np.zeros((0, 4, 4)), {}
    if not prog_snap:
        ref_snap = {}
    numbers = gaps(prog_poses, ref_poses, prog_snap, ref_snap)
    limits = cell["limits"]
    out = {name: {"value": v, "limit": float(limits[name])}
           for name, v in numbers.items()}
    correct = n_cmp > 0 and all(c["value"] <= c["limit"]
                                for c in out.values())
    return out, correct, {"compared_scans": n_cmp,
                          "reference_s": time.perf_counter() - t0}


def gates(drive, traj: np.ndarray) -> dict:
    """bench.py's accuracy against the simulator's truth over every scan
    the program fed (set-up and window): drift (the largest position error
    over the path length, %/m) and the final position error (m)."""
    n = min(len(traj), drive.n)
    if n < 2:
        return {}
    gt = drive.gt[:n, :3, 3] - drive.gt[0, :3, 3]
    est = traj[:n, :3, 3]
    errs = np.linalg.norm(est - gt, axis=1)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return {"drift_pct_per_m": {"value": 100.0 * float(np.nanmax(errs))
                                / max(path, 1e-6),
                                "limit": DRIFT_GATE_PCT_PER_M},
            "final_err_m": {"value": float(errs[-1]), "limit": FINAL_GATE_M}}
