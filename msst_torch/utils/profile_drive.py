"""Where a scan's time goes: the bench drive on one GPU, layer by layer.

    python3 -m msst_torch.utils.profile_drive [--method voxel|knn|both]
                                              [--scans 256] [--out DIR]

Three drives of ``LioSam(params, device="cuda", boot_scans=64)`` over the
simulated 16x1800 bench drive (circle r=10 m at 2 m/s, seed 7, loop closure
off) for each method, in one process so that they share one card:

A. unchanged: scans/s and per-scan p50/p99 with the pose read to the host,
   steady state (after the boot window and its re-feed);
B. with a ``torch.cuda.synchronize()`` before and after each layer's entry
   point (the spans nest: a child's time is part of its parent's), giving
   ms per scan and calls per scan for every span;
C. ``torch.profiler`` over 40 steady scans: device kernel time per scan
   (the busy share of run A's mean step), and launches, synchronisations
   and copies per scan.

The spans are put on by replacing module attributes while run B lasts; the
port's code is not changed and runs A and C are not instrumented.  One
JSON object per method is printed, and written to DIR with --out.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from ..models.liosam import LioSam, imu_fusion, mapping, pipeline
from ..models.liosam.params import LioParams
from ..ops import imu as imu_ops
from ..ops import knn, linalg, registration, voxel, voxelmap
from . import sim

BOOT_SCANS = 64
N_SCAN, HORIZON = 16, 1800
N_PROFILED = 40

# (module, attribute): spans of run B, parents before children
SPANS = [
    (pipeline, "odometry_step_packed"),
    (mapping, "prepare_scan"),
    (mapping, "run_frontend"),
    (imu_ops, "preintegrate"),
    (imu_fusion, "propagate"),
    (registration, "scan_to_map_voxel"),
    (registration, "scan_to_map"),
    (voxelmap, "lookup_cat"),
    (knn, "query"),
    (linalg, "sym3x3_eigh"),
    (imu_fusion, "update_with_pose"),
    (mapping, "_insert_keyframe"),
    (mapping, "_rebuild_local_map"),
    (voxel, "voxel_downsample_packed"),
    (knn, "build"),
    (voxelmap, "build"),
]


def _params(method: str) -> LioParams:
    return LioParams(n_scan=N_SCAN, horizon_scan=HORIZON,
                     max_points=N_SCAN * HORIZON + 64,
                     loop_closure_enabled=False, max_keyframes=256,
                     scan2map_method=method)


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


@contextmanager
def _synced_spans(totals: dict):
    """Replace every span's entry point by a version that synchronises the
    device before and after and adds its time and one call to `totals`."""
    saved = []
    for mod, name in SPANS:
        fn = getattr(mod, name)
        key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

        def timed(*args, _fn=fn, _key=key, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec = totals.setdefault(_key, [0.0, 0])
            rec[0] += 1000.0 * (time.perf_counter() - t0)
            rec[1] += 1
            return out

        # the wrappers of the kernels count their launches on the module
        # attribute, which is now this function
        timed.launches = getattr(fn, "launches", 0)
        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _drive(method, data, totals=None, profiled=None):
    """One drive; per-scan ms of the steady scans.  `totals` turns the
    synced spans on for the steady scans, `profiled` (a dict) takes the
    profiler's sums over N_PROFILED of them."""
    lio = LioSam(_params(method), device="cuda", boot_scans=BOOT_SCANS)
    boot = BOOT_SCANS + 1
    for s in data[:boot]:
        _feed(lio, s)
    torch.cuda.synchronize()
    steady = data[boot:]
    step_ms = []

    def run(scans):
        for s in scans:
            t0 = time.perf_counter()
            _feed(lio, s).pose_matrix.cpu()
            step_ms.append(1000.0 * (time.perf_counter() - t0))

    if totals is not None:
        with _synced_spans(totals):
            run(steady)
    elif profiled is not None:
        from torch.profiler import ProfilerActivity, profile

        run(steady[:20])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steady[20:20 + N_PROFILED])
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the device's own events only: a host op's row repeats the time of
        # the kernels it launched
        on_device = [ev for ev in events
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
        profiled["device_kernel_ms_per_scan"] = sum(
            ev.self_device_time_total for ev in on_device) / 1000.0 / N_PROFILED
        profiled["device_ops_per_scan"] = sum(
            ev.count for ev in on_device) / N_PROFILED
        for name in ("cudaLaunchKernel", "cudaStreamSynchronize",
                     "cudaMemcpyAsync", "cudaDeviceSynchronize"):
            profiled[f"{name}_per_scan"] = sum(
                ev.count for ev in events if ev.key == name) / N_PROFILED
        top = sorted(on_device,
                     key=lambda ev: -ev.self_device_time_total)[:8]
        profiled["top_device_ms_per_scan"] = [
            [ev.key[:80], ev.self_device_time_total / 1000.0 / N_PROFILED]
            for ev in top]
        profiled["wall_ms_per_scan"] = float(np.mean(step_ms[20:]))
    else:
        run(steady)
    torch.cuda.synchronize()
    return np.asarray(step_ms), int(lio.state.kf.count)


def profile_method(method, data):
    n_steady = len(data) - BOOT_SCANS - 1
    ms, keyframes = _drive(method, data)
    res = {"method": method, "scans": len(data), "steady_scans": n_steady,
           "keyframes": keyframes,
           "A": {"scans_per_s": 1000.0 * len(ms) / ms.sum(),
                 "mean_ms": float(ms.mean()),
                 "p50_ms": float(np.percentile(ms, 50)),
                 "p99_ms": float(np.percentile(ms, 99))}}
    totals: dict = {}
    ms_b, _ = _drive(method, data, totals=totals)
    res["B"] = {"synced_step_ms": float(ms_b.mean()),
                "spans": {k: {"ms_per_scan": v[0] / n_steady,
                              "calls_per_scan": v[1] / n_steady}
                          for k, v in totals.items()}}
    prof: dict = {}
    _drive(method, data, profiled=prof)
    prof["busy_share_of_run_A"] = (prof["device_kernel_ms_per_scan"]
                                   / res["A"]["mean_ms"])
    res["C"] = prof
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="both",
                    choices=["voxel", "knn", "both"])
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_drive: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    data = sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=args.scans, scan_dt=0.1, n_scan=N_SCAN,
                            horizon=HORIZON, seed=7)
    methods = ["voxel", "knn"] if args.method == "both" else [args.method]
    for method in methods:
        res = profile_method(method, data)
        res["card"] = card
        print(json.dumps(res), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"profile_{method}.json"),
                      "w") as f:
                json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
