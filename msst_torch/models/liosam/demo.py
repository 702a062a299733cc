"""Runnable LIO-SAM demo on the port: a simulated drive replayed through
``LioSam``, printing per-scan status and an ATE report.

    python -m msst_torch.models.liosam.demo [--scans 40] [--loop] [--cpu]
                                            [--horizon 720]

It runs on the GPU unless ``--cpu`` is given.  Stands in for the
reference's rosbag-replay validation
(``liosam_ws/src/LIO-SAM/README.md:129-146``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    """Run the demo; returns the LioSam it drove (for ``save_map``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--loop", action="store_true", help="enable loop closure")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    ap.add_argument("--horizon", type=int, default=720)
    args = ap.parse_args(argv)

    from msst_torch.models.liosam import LioSam
    from msst_torch.models.liosam.params import tiny_params
    from msst_torch.utils import sim

    world = sim.World()
    traj = sim.SimTrajectory(kind="circle", radius=10.0, speed=2.0)
    data = sim.make_dataset(world, traj, n_scans=args.scans, scan_dt=0.1,
                            n_scan=16, horizon=args.horizon, seed=1)

    p = tiny_params(loop_closure_enabled=args.loop, horizon_scan=args.horizon,
                    max_points=16 * args.horizon + 8)
    lio = LioSam(p, device="cpu" if args.cpu else "cuda")

    t0 = time.perf_counter()
    for i, s in enumerate(data):
        out = lio.process_scan(
            s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
            imu_t=s["imu_t"], imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
            imu_rpy=s["imu_rpy"],
        )
        if i % 10 == 0:
            pose = out.pose6.cpu().numpy()
            print(f"scan {i:3d}: pos=({pose[3]:+.2f},{pose[4]:+.2f},"
                  f"{pose[5]:+.2f}) kf={int(out.kf_count)} "
                  f"corners={int(out.n_corner)} surf={int(out.n_surf)} "
                  f"degen={bool(out.degenerate)}")
    wall = time.perf_counter() - t0
    lio.flush()

    gt0 = data[0]["gt_pose"][:3, 3]
    gt = np.stack([s["gt_pose"][:3, 3] - gt0 for s in data])
    est = lio.trajectory.as_matrices()[:, :3, 3]
    err = np.linalg.norm(est - gt, axis=1)
    ate = lio.trajectory.ate_rmse(np.stack([s["gt_pose"][:3, 3]
                                            for s in data]))
    print(f"\n{args.scans} scans in {wall:.1f}s "
          f"({args.scans / wall:.2f} scans/s incl. warm-up)")
    print(f"ATE RMSE: {ate * 100:.2f} cm   max abs err: {err.max() * 100:.2f} cm")
    print(f"keyframes: {int(lio.state.kf.count)}  loops: {int(lio.state.n_loop)}")
    return lio


if __name__ == "__main__":
    main()
