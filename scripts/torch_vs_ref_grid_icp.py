#!/usr/bin/env python3
"""Run msst_tpu's and the port's grid ``registration.icp_point2point`` on
the CPU over chip_smoke.py phase 14c's inputs, and print one JSON line per
(package, offset).

    python3 scripts/torch_vs_ref_grid_icp.py [--offset R P Y X Y Z ...]

The inputs are phase 14c's: phase 11's master sweep after Multi_LiCa's
prep (the 20 m crop, the 0.35 m voxel filter into 16384 slots), a hash
grid of 1.4 m cells over 16384 buckets, and the same cloud moved by the
inverse of the offset as the source; 50 iterations at most, a 1.0 m
correspondence gate, 16 candidates a cell.  Each line: the package, the
offset (roll, pitch, yaw in rad, x, y, z in m), the iterations, whether
it converged, the fitness, the recovered offset's largest error in
degrees and metres, and the pose (vec6).  By default both of phase 14c's
offsets run: chip_smoke.ICP14_OFFSET and the first one it held,
(0, 0, 0.03, 0.15, -0.10, 0.05).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_OFFSET = (0.0, 0.0, 0.03, 0.15, -0.10, 0.05)
MAX_ITERS = 50
MAX_CORR_DIST = 1.0
CELL_M = 1.4
TABLE = 16384


def run_msst_torch(tq, tm, offset):
    import torch

    from msst_torch.ops import knn, registration, se3

    tq, tm = torch.from_numpy(tq), torch.from_numpy(tm)
    off = se3.Pose.from_vec6(torch.tensor(offset, dtype=torch.float32))
    src = off.inverse().apply(tq)
    grid = knn.build(tq, tm, CELL_M, TABLE)
    res = registration.icp_point2point(
        src, tm, grid, tq, se3.Pose.identity(device="cpu"),
        max_iters=MAX_ITERS, max_corr_dist=MAX_CORR_DIST)
    return (res.pose.to_vec6().numpy(), int(res.iters), bool(res.converged),
            float(res.fitness))


def run_msst_tpu(tq, tm, offset):
    import jax.numpy as jnp

    from msst_tpu.ops import knn, registration, se3

    tq, tm = jnp.asarray(tq), jnp.asarray(tm)
    off = se3.Pose.from_vec6(jnp.asarray(offset, jnp.float32))
    src = off.inverse().apply(tq)
    grid = knn.build(tq, tm, CELL_M, TABLE)
    res = registration.icp_point2point(
        src, tm, grid, tq, se3.Pose.identity(),
        max_iters=MAX_ITERS, max_corr_dist=MAX_CORR_DIST)
    return (np.asarray(res.pose.to_vec6()), int(res.iters),
            bool(res.converged), float(res.fitness))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--offset", type=float, nargs=6, action="append",
                    metavar=("R", "P", "Y", "X", "Y_", "Z"))
    ap.add_argument("--packages", default="msst_tpu,msst_torch")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import chip_smoke

    packages = args.packages.split(",")
    if "msst_tpu" in packages:
        import jax

        jax.config.update("jax_platforms", "cpu")
    offsets = args.offset or [chip_smoke.ICP14_OFFSET, FIRST_OFFSET]
    tq, tm = chip_smoke._prepped(chip_smoke._calib_scene()[0], "cpu")
    tq, tm = tq.numpy(), tm.numpy()
    runs = {"msst_tpu": run_msst_tpu, "msst_torch": run_msst_torch}
    for offset in offsets:
        offset = tuple(float(v) for v in offset)
        for name in packages:
            pose, iters, conv, fit = runs[name](tq, tm, offset)
            print(json.dumps({
                "package": name, "offset": offset, "iters": iters,
                "converged": conv, "fitness": fit,
                "err_deg": float(np.rad2deg(np.abs(pose[:3]
                                                   - offset[:3]).max())),
                "err_m": float(np.abs(pose[3:] - offset[3:]).max()),
                "pose": [float(v) for v in pose]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
