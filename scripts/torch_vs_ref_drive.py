#!/usr/bin/env python3
"""Drive msst_tpu and the port (msst_torch) on the CPU over the bench drive
at a reduced ring width, with the same parameter overrides, and print each
package's accuracy against ground truth under bench.py's definitions.

    python3 scripts/torch_vs_ref_drive.py [--horizon 900] [--scans 256]
        [--boot 64] [--set key=value ...] [--steps K]
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
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from msst_torch.models.liosam import LioSam as TLioSam
    from msst_torch.models.liosam.params import LioParams as TParams
    from msst_tpu.models.liosam import mapping as jmap
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
        rng = np.random.default_rng(args.perturb)
        for s in data:
            s["xyz"] = (s["xyz"] * (1.0 + 2.0 ** -23 * rng.standard_normal(
                s["xyz"].shape))).astype(s["xyz"].dtype)
    if args.reference_sums:
        _use_reference_sums()

    def reference_step(state, points, aux, p):
        ps = jmap.prepare_scan(jmap.unpack_step_input(points, aux, p), p)
        jmap.inp = ps
        try:
            return jmap.odometry_core(state, ps, p)
        finally:
            del jmap.inp

    jstep = jax.jit(reference_step, static_argnames=("p",))
    recorded = []

    def recording_step(state, points, aux, p):
        out = jstep(state, points, aux, p)
        n_calls[0] += 1
        if args.steps and n_calls[0] % args.steps == 0:
            recorded.append(jax.tree.map(np.asarray, (state, points, aux,
                                                      out[1])))
        return out

    n_calls = [0]
    jpipe.odometry_step_packed = recording_step
    for name in args.packages.split(","):
        if name == "msst_tpu":
            lio = jpipe.LioSam(JParams(**over))
            lio._boot_n = args.boot
        else:
            lio = TLioSam(TParams(**over), device="cpu", boot_scans=args.boot)
        t0 = time.perf_counter()
        for s in data:
            _feed(lio, s)
        res = {"package": name, "overrides": over,
               "perturb": args.perturb, "reference_sums": args.reference_sums,
               "keyframes": int(lio.state.kf.count),
               "seconds": time.perf_counter() - t0}
        res.update(_accuracy(lio.trajectory.as_matrices(), data))
        print(json.dumps(res), flush=True)
    if recorded:
        import torch

        from msst_torch import convert
        from msst_torch.models.liosam import mapping as tmap

        p = TParams(**over)
        gaps, kf_diff, it_diff = [], 0, 0
        for state, points, aux, want in recorded:
            _, got = tmap.odometry_step_packed(
                convert.from_numpy(state, "cpu"), torch.from_numpy(points),
                torch.from_numpy(aux), p)
            gaps.append(float(np.abs(got.pose6.numpy() - want.pose6).max()))
            kf_diff += bool(got.is_keyframe) != bool(want.is_keyframe)
            it_diff += int(got.s2m_iterations) != int(want.s2m_iterations)
        print(json.dumps({"steps_compared": len(gaps),
                          "max_pose_gap": max(gaps),
                          "median_pose_gap": float(np.median(gaps)),
                          "keyframe_decisions_differ": kf_diff,
                          "iterations_differ": it_diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
