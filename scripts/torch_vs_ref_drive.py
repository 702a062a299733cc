#!/usr/bin/env python3
"""Drive msst_tpu and the port (msst_torch) on the CPU over the bench drive
at a reduced ring width, with the same parameter overrides, and print each
package's accuracy against ground truth under bench.py's definitions.

    python3 scripts/torch_vs_ref_drive.py [--horizon 900] [--scans 256]
        [--boot 64] [--set key=value ...] [--steps K] [--window W]
        [--packages msst_tpu,msst_torch] [--perturb SEED] [--reference-sums]

The drive is chip_smoke.py's bench drive (circle r = 10 m at 2 m/s, seed 7,
16 rings, loop closure off, max_keyframes = 256) at `--horizon` columns;
both packages boot on `--boot` scans.  msst_tpu's step reads an undefined
name (``inp``) in ``odometry_core``; as tests/test_torch_slice.py does, the
script binds it to the prepared scan while the step traces, through a
jitted step of its own, and edits nothing of msst_tpu.  One JSON line per
package.  With ``--steps K`` every K-th step of msst_tpu's drive (its state
before the step and the packed scan) also goes through the port's step,
and a last JSON line gives the largest pose gap of those single steps and
how many keyframe decisions and Gauss-Newton iteration counts differ: the
packages' agreement without the drive's own amplification.

``--window W`` (W > 1) feeds each package's ``process_window`` with
windows of W scans as bench.py does (the range-image grids attached, so
under the default ``quantized_upload`` the hoisted range-image upload);
msst_tpu's window program runs through a ``_window_core`` that binds
``inp`` the same way.  ``--steps`` compares single steps only at W = 1.

``--kitti DIR`` drives each package's ``lio-kitti`` command instead, in
this process, at its own HDL-64 profile (64 x 1800, 150,000 points, the
default 8-scan boot) over chip_smoke.py's synthetic KITTI raw drive (phase
13a; written into DIR unless it is there, ``--kitti-motion`` for
motion-true sweeps instead of static snapshots), for its first ``--scans``
sweeps; each line holds the command's ATE line and the trajectory's
errors against the simulator's truth under bench.py's definitions.

``--bag DIR`` runs each package's ``lio-bag`` loop (its CLI's ``_lio_run``
at the command's profile, ``LioParams(loop_closure_enabled=False)``) over
the bench drive (16 rings at ``--horizon`` columns, seed 7, ``--scans``
sweeps) written as chip_smoke.py's Ouster rosbag (phase 13b; into DIR
unless it is there) and read back by the port's ``iter_lio_inputs``
(equal to msst_tpu's); each line holds the errors against the truth
(chip_smoke.py phase 13b's: bench.py's, and the ATE) and the yaw of the attitude the reader gave the first scan against the
truth's.  ``--perturb SEED`` applies to the read scans, ``--threads N``
sets the port's torch threads (its CPU sums depend on them), and
``--attitude stamp`` gives every scan the attitude of the bag's IMU
message nearest its stamp instead of the reader's (the last of its
window); ``--steps K`` compares single steps as on the bench drive.

``--packages`` drives only the packages named.  ``--perturb SEED`` scales
every input point coordinate by 1 + 2^-23 N(0, 1) (numpy's generator,
seeded), a rounding-level change of the input.  ``--reference-sums``
replaces the port's ``segments.segment_sum`` (each segment's rows added on
their own) by msst_tpu's ``sorted_segment_sum(compensated=False)``, the
difference of float32 prefix sums over all the rows that msst_tpu's voxel
map builds use: with it the port runs msst_tpu's arithmetic.  Runs on the
CPU: keep the width reduced.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _value(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _accuracy(traj, data):
    gt0 = data[0]["gt_pose"][:3, 3]
    gt = np.stack([s["gt_pose"][:3, 3] - gt0 for s in data])
    est = traj[:, :3, 3]
    n = min(len(est), len(gt))
    errs = np.linalg.norm(est[:n] - gt[:n], axis=1)
    path = float(np.linalg.norm(np.diff(gt[:n], axis=0), axis=1).sum())
    return {"max_err_m": float(errs.max()), "final_err_m": float(errs[-1]),
            "drift_pct_per_m": 100.0 * float(errs.max()) / max(path, 1e-6),
            "path_len_m": path}


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


def _use_reference_sums():
    """The port's segment sums done as msst_tpu's voxel builds do them."""
    import jax
    import jax.numpy as jnp
    import torch

    import msst_torch.ops.segments as tseg
    from msst_tpu.ops import segments as jseg

    jsum = jax.jit(jseg.sorted_segment_sum,
                   static_argnames=("num_segments", "compensated"))

    def segment_sum(vals, seg, num_segments):
        out = jsum(jnp.asarray(vals.numpy()),
                   jnp.asarray(seg.numpy().astype(np.int32)),
                   num_segments=num_segments, compensated=False)
        return torch.from_numpy(np.array(out))

    tseg.segment_sum = segment_sum


def _reference_binding(jax, steps=0):
    """msst_tpu's step through a jitted step that binds ``inp`` while it
    traces (msst_tpu's ``odometry_core`` reads that undefined name).  With
    `steps` K, every K-th step's state before it, packed scan and output
    go into the returned list, as numpy."""
    from msst_tpu.models.liosam import mapping as jmap
    from msst_tpu.models.liosam import pipeline as jpipe

    def reference_step(state, points, aux, p):
        ps = jmap.prepare_scan(jmap.unpack_step_input(points, aux, p), p)
        jmap.inp = ps
        try:
            return jmap.odometry_core(state, ps, p)
        finally:
            del jmap.inp

    jstep = jax.jit(reference_step, static_argnames=("p",))
    recorded, n_calls = [], [0]

    def recording_step(state, points, aux, p):
        out = jstep(state, points, aux, p)
        n_calls[0] += 1
        if steps and n_calls[0] % steps == 0:
            recorded.append(jax.tree.map(np.asarray, (state, points, aux,
                                                      out[1])))
        return out

    def window_core(state, preps, valid_w, p):
        def body(st, pv):
            ps, valid = pv

            def core(s):
                jmap.inp = ps
                try:
                    return jmap.odometry_core(s, ps, p)
                finally:
                    del jmap.inp

            return jax.lax.cond(
                valid, core, lambda s: (s, jmap._passthrough_output(s, p)),
                st)

        return jax.lax.scan(body, state, (preps, valid_w))

    jpipe.odometry_step_packed = recording_step
    jmap._window_core = window_core
    return recorded


def _single_steps(recorded, p):
    """The port's step from each recorded msst_tpu state and scan: one
    JSON line with the largest and median pose gap to msst_tpu's output
    and how many keyframe decisions and iteration counts differ."""
    import torch

    from msst_torch import convert
    from msst_torch.models.liosam import mapping as tmap

    gaps, kf_diff, it_diff = [], 0, 0
    for state, points, aux, want in recorded:
        _, got = tmap.odometry_step_packed(
            convert.from_numpy(state, "cpu"), torch.from_numpy(points.copy()),
            torch.from_numpy(aux.copy()), p)
        gaps.append(float(np.abs(got.pose6.numpy() - want.pose6).max()))
        kf_diff += bool(got.is_keyframe) != bool(want.is_keyframe)
        it_diff += int(got.s2m_iterations) != int(want.s2m_iterations)
    print(json.dumps({"steps_compared": len(gaps),
                      "max_pose_gap": max(gaps),
                      "median_pose_gap": float(np.median(gaps)),
                      "keyframe_decisions_differ": kf_diff,
                      "iterations_differ": it_diff}), flush=True)


def _bag(args) -> int:
    """Each package's lio-bag loop over the reader's scans of the bag."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch
    from scipy.spatial.transform import Rotation as Rs

    import chip_smoke
    from msst_torch import cli as tcli
    from msst_torch.utils import io_rosbag, sim
    from msst_tpu import cli as jcli

    if args.threads:
        torch.set_num_threads(args.threads)
    bag = os.path.join(args.bag, "bench.bag")
    data = sim.make_dataset(sim.World(), chip_smoke._bench_trajectory(),
                            n_scans=args.scans, scan_dt=0.1, n_scan=16,
                            horizon=args.horizon, seed=7)
    if not os.path.exists(bag):
        os.makedirs(args.bag, exist_ok=True)
        chip_smoke._write_ouster_bag(bag, data)
    scans = list(io_rosbag.iter_lio_inputs(bag, "/points", "/imu"))
    if args.attitude == "stamp":
        imu = [io_rosbag.decode_imu(raw) for _, _, _, raw in
               io_rosbag.RosbagReader(bag).messages({"/imu"})]
        t = np.array([m["stamp"] for m in imu])
        for s in scans:
            q = imu[int(np.argmin(np.abs(t - s["scan_start"])))]["orientation"]
            s["imu_rpy"] = Rs.from_quat([q[1], q[2], q[3], q[0]]).as_euler(
                "xyz").astype(np.float32)
    if args.perturb is not None:
        scans = chip_smoke._perturbed(scans, args.perturb)
    gt = np.stack([s["gt_pose"][:3, 3] for s in data])
    heading0 = float(np.arctan2(data[0]["gt_pose"][1, 0],
                                data[0]["gt_pose"][0, 0]))
    recorded = _reference_binding(jax, args.steps)
    for name in args.packages.split(","):
        t0 = time.perf_counter()
        if name == "msst_tpu":
            lio = jcli._lio_run(iter(scans), progress=False)
        else:
            lio = tcli._lio_run(iter(scans), progress=False, device="cpu")
        res = {"package": name, "command": "lio-bag", "scans": len(scans),
               "perturb": args.perturb, "attitude": args.attitude,
               "torch_threads": torch.get_num_threads(),
               "reader_yaw_offset_rad": float(scans[0]["imu_rpy"][2])
               - heading0,
               "keyframes": int(lio.state.kf.count),
               "seconds": time.perf_counter() - t0}
        est = lio.trajectory.as_matrices()
        keys = ("max_err_m", "final_err_m", "drift_pct_per_m", "path_len_m")
        res.update(zip(keys, chip_smoke._errors(est, gt)))
        res["ate_m"] = chip_smoke._bag_ate(est, gt)
        print(json.dumps(res), flush=True)
    if recorded:
        from msst_torch.models.liosam.params import LioParams

        _single_steps(recorded, LioParams(loop_closure_enabled=False))
    return 0


def _kitti(args) -> int:
    """Each package's lio-kitti command over the synthetic KITTI drive."""
    import contextlib
    import io

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from msst_torch import cli as tcli
    from msst_tpu import cli as jcli

    traj = chip_smoke._bench_trajectory()
    root = args.kitti
    drive = os.path.join(root, "2011_09_26", "2011_09_26_drive_0001_sync")
    if not os.path.isdir(drive):
        chip_smoke._write_kitti_drive(root, n_scans=args.scans,
                                      motion=args.kitti_motion)
    gt = np.stack([traj.pose(i * 0.1)[:3, 3] for i in range(args.scans)])
    argv = ["lio-kitti", drive, "--scans", str(args.scans)]
    _reference_binding(jax)
    for name in args.packages.split(","):
        out = os.path.join(root, f"trajectory_{name}.txt")
        if name == "msst_tpu":
            main_fn, cmd = jcli.main, argv + ["--output", out]
        else:
            main_fn, cmd = tcli.main, argv + ["--output", out, "--device",
                                             "cpu"]
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            main_fn(cmd)
        est = chip_smoke._kitti_poses(out)
        res = {"package": name, "command": argv[0], "input": argv[1],
               "scans": args.scans, "seconds": time.perf_counter() - t0,
               "ate_line": [ln for ln in text.getvalue().splitlines()
                            if ln.startswith("ATE")]}
        keys = ("max_err_m", "final_err_m", "drift_pct_per_m", "path_len_m")
        res.update(zip(keys, chip_smoke._errors(est, gt)))
        print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--horizon", type=int, default=900)
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--boot", type=int, default=64)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--packages", default="msst_tpu,msst_torch")
    ap.add_argument("--perturb", type=int, default=None)
    ap.add_argument("--reference-sums", action="store_true")
    ap.add_argument("--kitti", default=None, metavar="DIR")
    ap.add_argument("--kitti-motion", action="store_true")
    ap.add_argument("--bag", default=None, metavar="DIR")
    ap.add_argument("--attitude", choices=("reader", "stamp"),
                    default="reader")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--window", type=int, default=1)
    args = ap.parse_args(argv)
    if args.kitti:
        return _kitti(args)
    if args.bag:
        return _bag(args)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from msst_torch.models.liosam import LioSam as TLioSam
    from msst_torch.models.liosam.params import LioParams as TParams
    from msst_tpu.models.liosam import pipeline as jpipe
    from msst_tpu.models.liosam.params import LioParams as JParams
    from msst_tpu.utils import sim

    over = dict(n_scan=16, horizon_scan=args.horizon,
                max_points=16 * args.horizon + 64, loop_closure_enabled=False,
                max_keyframes=256)
    over.update({k: _value(v) for k, v in (a.split("=", 1) for a in args.set)})
    data = sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=args.scans, scan_dt=0.1, n_scan=16,
                            horizon=args.horizon, seed=7)
    if args.perturb is not None:
        import chip_smoke

        data = chip_smoke._perturbed(data, args.perturb)
    if args.reference_sums:
        _use_reference_sums()

    recorded = _reference_binding(jax, args.steps)
    W = args.window
    import chip_smoke

    windows = chip_smoke._windows_of(data, W)
    for name in args.packages.split(","):
        if name == "msst_tpu":
            lio = jpipe.LioSam(JParams(**over), window=W)
            lio._boot_n = args.boot
        else:
            lio = TLioSam(TParams(**over), device="cpu", window=W,
                          boot_scans=args.boot)
        t0 = time.perf_counter()
        if W > 1:
            for batch in windows:
                lio.process_window(batch)
        else:
            for s in data:
                _feed(lio, s)
        res = {"package": name, "overrides": over, "window": W,
               "perturb": args.perturb, "reference_sums": args.reference_sums,
               "keyframes": int(lio.state.kf.count),
               "seconds": time.perf_counter() - t0}
        res.update(_accuracy(lio.trajectory.as_matrices(), data))
        print(json.dumps(res), flush=True)
    if recorded:
        _single_steps(recorded, TParams(**over))
    return 0


if __name__ == "__main__":
    sys.exit(main())
