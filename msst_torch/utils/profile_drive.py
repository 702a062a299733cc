"""Where a scan's time goes: the bench drives on one GPU, layer by layer.

    python3 -m msst_torch.utils.profile_drive [--cell voxel|knn|loop|all]
                                              [--scans 256] [--out DIR]

The cells, each a drive of ``LioSam(params, device="cuda", boot_scans=64)``
over a simulated 16x1800 drive (circle r=10 m at 2 m/s):

* ``voxel`` and ``knn``: the bench drive (seed 7, `--scans` scans, loop
  closure off), once per scan-to-map method;
* ``loop``: bench.py's loop-on drive (seed 8, 340 scans, the voxel method,
  loop closure on: an attempt every 10 scans behind the host pre-gate).

Each cell is driven three times in one process, so that the drives share
one card (the loop cell four times):

A. unchanged: scans/s and per-scan p50/p99 with the pose read to the host,
   steady state (after the boot window and its re-feed);
B. under ``profiling.tracing()``: the program's own spans (the spans nest:
   a child's time is part of its parent's), giving per scan the calls and
   the host and device ms of every span, each with its self time (the
   device's from the spans' CUDA-event intervals, with no synchronisation
   added); a span inside a loop attempt is keyed ``loop/<span>``, the host
   reads are counted by site, and the loop cell records each attempt
   (the ``loop_attempt`` span's args and device ms);
C. ``torch.profiler`` over 40 steady scans (the loop cell: the last 40,
   which hold its attempts with candidates): device kernel time per scan
   (the busy share of run A's mean step), and launches, synchronisations
   and copies per scan;
D. the loop cell only: ``torch.profiler`` around each loop attempt alone:
   its wall and device time, kernel launches, host synchronisations and
   copies, and the device time of the 3x3 SVDs (cuSOLVER) in it.

The attempt records of run D (``watched_attempts``, which chip_smoke.py's
loop phases use too) are put on by replacing a module attribute while the
run lasts; run A records nothing, run C the program's spans as every
profiled run does.  One
JSON object per cell is printed, and written to DIR with --out.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from ..models.liosam import LioSam, pipeline
from ..models.liosam.params import LioParams
from . import profiling, sim

BOOT_SCANS = 64
N_SCAN, HORIZON = 16, 1800
N_PROFILED = 40
LOOP_SCANS, LOOP_SEED = 340, 8   # bench.py's loop-on phase

def _params(cell: str) -> LioParams:
    return LioParams(n_scan=N_SCAN, horizon_scan=HORIZON,
                     max_points=N_SCAN * HORIZON + 64,
                     loop_closure_enabled=cell == "loop", max_keyframes=256,
                     scan2map_method="knn" if cell == "knn" else "voxel")


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


def _device_events(prof):
    """(on-device events, all events) of a finished profiler."""
    events = prof.key_averages()
    return ([ev for ev in events
             if ev.device_type == torch.autograd.DeviceType.CUDA], events)


def _api_counts(events, n):
    return {f"{name}_per_scan" if n > 1 else name:
            sum(ev.count for ev in events if ev.key == name) / n
            for name in ("cudaLaunchKernel", "cudaStreamSynchronize",
                         "cudaMemcpyAsync", "cudaMemcpy",
                         "cudaDeviceSynchronize")}


@contextmanager
def watched_attempts(records: list, counters: dict | None = None,
                     profile: bool = False):
    """While the context lasts, every loop attempt the pipeline dispatches
    (``pipeline.loop_closure_step``) appends a record to `records`: its
    wall time to the end of its device work (``ms``), its LoopResult's
    fields (``tried``: the candidates it registered against, 0 where the
    candidate search found none), and for each entry of `counters` (name ->
    function returning a running count, such as a kernel wrapper's
    launches) how much the count grew in the attempt.  With `profile` the
    attempt runs under its own torch.profiler, and the record adds its
    device time, the 3x3 SVDs' share of it, and its launches,
    synchronisations and copies."""
    from torch.profiler import ProfilerActivity, profile as profiler

    fn = pipeline.loop_closure_step
    counters = counters or {}

    def watched(*args, **kwargs):
        before = {name: count() for name, count in counters.items()}
        torch.cuda.synchronize()
        prof = (profiler(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
                if profile else nullcontext())
        with prof:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = 1000.0 * (time.perf_counter() - t0)
        res = out[1]
        rec = {"ms": ms, "found": bool(res.found), "cur": int(res.cur),
               "cand": int(res.cand), "fitness": float(res.fitness),
               "icp_iters": int(res.icp_iters), "tried": int(res.tried),
               "counts": {name: count() - before[name]
                          for name, count in counters.items()}}
        if profile:
            on_device, events = _device_events(prof)
            rec["device_ms"] = sum(ev.self_device_time_total
                                   for ev in on_device) / 1000.0
            rec["svd_device_ms"] = sum(
                ev.self_device_time_total for ev in on_device
                if any(k in ev.key.lower()
                       for k in ("svd", "syevj", "cusolver", "jacobi"))
            ) / 1000.0
            rec.update(_api_counts(events, 1))
        records.append(rec)
        return out

    pipeline.loop_closure_step = watched
    try:
        yield
    finally:
        pipeline.loop_closure_step = fn


@contextmanager
def counted_calls(targets):
    """Count the calls of each (module, attribute) of `targets` while the
    context lasts (the attribute is replaced, as the spans of run B
    replace theirs); yields {"<module>.<attribute>": calls so far}."""
    counts = {}
    saved = []
    for mod, name in targets:
        fn = getattr(mod, name)
        key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        counts[key] = 0

        def counted(*args, _fn=fn, _key=key, **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _drive(cell, data, traced=None, profiled=None, attempt_records=None):
    """One drive; per-scan ms of the steady scans.  `traced` (a dict)
    takes the program's log of the steady scans, `profiled` (a dict) the
    profiler's sums over N_PROFILED of them, `attempt_records` profiles
    each loop attempt."""
    lio = LioSam(_params(cell), device="cuda", boot_scans=BOOT_SCANS)
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

    if traced is not None:
        profiling.drain()
        with profiling.tracing():
            run(steady)
            lio.flush()
        traced.update(profiling.drain())
    elif attempt_records is not None:
        with watched_attempts(attempt_records, profile=True):
            run(steady)
    elif profiled is not None:
        from torch.profiler import ProfilerActivity, profile

        # the loop cell's attempts with candidates come at its end
        lead = (len(steady) - N_PROFILED) if cell == "loop" else 20
        run(steady[:lead])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steady[lead:lead + N_PROFILED])
            torch.cuda.synchronize()
        profiling.drain()   # the spans the profile recorded
        # the device's own events only: a host op's row repeats the time of
        # the kernels it launched
        on_device, events = _device_events(prof)
        profiled["device_kernel_ms_per_scan"] = sum(
            ev.self_device_time_total for ev in on_device) / 1000.0 / N_PROFILED
        profiled["device_ops_per_scan"] = sum(
            ev.count for ev in on_device) / N_PROFILED
        profiled.update(_api_counts(events, N_PROFILED))
        top = sorted(on_device,
                     key=lambda ev: -ev.self_device_time_total)[:8]
        profiled["top_device_ms_per_scan"] = [
            [ev.key[:80], ev.self_device_time_total / 1000.0 / N_PROFILED]
            for ev in top]
        profiled["wall_ms_per_scan"] = float(np.mean(step_ms[lead:]))
    else:
        run(steady)
    torch.cuda.synchronize()
    lio.flush()
    return np.asarray(step_ms), lio


def profile_cell(cell, data):
    n_steady = len(data) - BOOT_SCANS - 1
    ms, lio = _drive(cell, data)
    res = {"cell": cell, "scans": len(data), "steady_scans": n_steady,
           "keyframes": int(lio.state.kf.count),
           "loops_closed": int(lio.state.n_loop),
           "A": {"scans_per_s": 1000.0 * len(ms) / ms.sum(),
                 "mean_ms": float(ms.mean()),
                 "p50_ms": float(np.percentile(ms, 50)),
                 "p99_ms": float(np.percentile(ms, 99))}}
    lg: dict = {}
    ms_b, _ = _drive(cell, data, traced=lg)
    attempts = [dict(r["args"], scan=r["scans"][0],
                     ms=(r["t1"] - r["t0"]) / 1e6,
                     device_ms=(r["d1"] - r["d0"]) / 1e6
                     if r["d0"] is not None else None)
                for r in lg["spans"] if r["name"] == "loop_attempt"]
    res["B"] = {"traced_step_ms": float(ms_b.mean()),
                "spans": {k: dict(v, **{f"{q}_per_scan": v[q] / n_steady
                                        for q in ("calls", "host_ms",
                                                  "device_ms",
                                                  "self_device_ms")})
                          for k, v in profiling.summary(lg).items()},
                "host_reads_per_scan": {
                    k: n / n_steady
                    for k, n in profiling.host_reads(lg).items()},
                "attempts": attempts}
    prof: dict = {}
    _drive(cell, data, profiled=prof)
    prof["busy_share_of_run_A"] = (prof["device_kernel_ms_per_scan"]
                                   / res["A"]["mean_ms"])
    res["C"] = prof
    if cell == "loop":
        records: list = []
        _drive(cell, data, attempt_records=records)
        res["D"] = records
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="all",
                    choices=["voxel", "knn", "loop", "all"])
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

    def drive(n, seed):
        return sim.make_dataset(sim.World(),
                                sim.SimTrajectory(kind="circle", radius=10.0,
                                                  speed=2.0),
                                n_scans=n, scan_dt=0.1, n_scan=N_SCAN,
                                horizon=HORIZON, seed=seed)

    cells = ["voxel", "knn", "loop"] if args.cell == "all" else [args.cell]
    bench_data = drive(args.scans, 7) if set(cells) - {"loop"} else None
    for cell in cells:
        data = drive(LOOP_SCANS, LOOP_SEED) if cell == "loop" else bench_data
        res = profile_cell(cell, data)
        res["card"] = card
        print(json.dumps(res), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"profile_{cell}.json"),
                      "w") as f:
                json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
