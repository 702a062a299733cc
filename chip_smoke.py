#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msst_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, one line each; any failure exits non-zero:

1. the card: nvidia-smi name and power limit, torch's device name
   (no CUDA device -> exit 1).
2. build the CUDA kernels from msst_torch/csrc with nvcc.
3. each kernel against its plain PyTorch twin on the card, at the shapes
   the odometry step gives it, on a map built from the simulated drive.
4. the main path: ``LioSam(params, device="cuda").process_scan`` over the
   256-scan 16x1800 bench drive (circle r=10 m at 2 m/s, seed 7, loop
   closure off, max_keyframes=256), with the kernel launch counters reset
   just before and read just after; the accuracy gates of bench.py (drift
   <= 0.5 %/m, final error <= 0.10 m); scans/s and per-scan p50/p99.
5. the port on the CPU and on the card over the first 24 scans:
   positions within 1 cm of each other.

Then one JSON line describing the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  --out DIR also writes the per-scan
times and the result there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

DRIFT_GATE_PCT = 0.5
FINAL_GATE_M = 0.10
CPU_AGREE_M = 0.01
N_SCANS = 256          # the bench drive
N_CPU_SCANS = 24
# dynamic-init boot window of the main-path run: bench.py's protocol boots
# on its first 64-scan window; at window=1 msst_tpu (and LioSam's default)
# boots on 8 scans, which on this drive leaves a ~0.19 m start offset that
# fails the final-error gate in both packages alike (see PERF.md)
BOOT_SCANS = 64
SCAN_DT = 0.1
N_SCAN, HORIZON = 16, 1800


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _params():
    from msst_torch.models.liosam.params import LioParams

    return LioParams(n_scan=N_SCAN, horizon_scan=HORIZON,
                     max_points=N_SCAN * HORIZON + 64,
                     loop_closure_enabled=False, max_keyframes=256)


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


def _cuda_ms(fn, n=100, warm=5):
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _lookup_inputs(data, p, dev):
    """A corner and a surf voxel-feature map at the step's capacities, built
    from the first scans' features placed at their true poses, and one later
    scan's features (2048 + 8192 query slots) as queries."""
    import torch

    from msst_torch.models.liosam import mapping
    from msst_torch.models.liosam.pipeline import LioSam
    from msst_torch.ops import se3, voxelmap

    packer = LioSam(p, device=dev)
    gt0 = data[0]["gt_pose"][:3, 3]

    def features(s):
        pts, aux = packer._make_input_np(
            s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
            imu_t=s["imu_t"], imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
            imu_rpy=s["imu_rpy"])
        packer._last_scan_time = float(s["scan_start"])
        ps = mapping.prepare_scan(mapping.unpack_step_input(
            torch.from_numpy(pts).to(dev), torch.from_numpy(aux).to(dev), p), p)
        T = torch.as_tensor(s["gt_pose"], dtype=torch.float32, device=dev)
        R, t = T[:3, :3], T[:3, 3] - torch.as_tensor(gt0, dtype=torch.float32,
                                                    device=dev)
        return (ps.corner_xyz @ R.T + t, ps.corner_mask,
                ps.surf_xyz @ R.T + t, ps.surf_mask)

    feats = [features(s) for s in data[:12]]
    anchor = torch.zeros(3, device=dev)
    cmap = voxelmap.build(torch.cat([f[0] for f in feats]),
                          torch.cat([f[1] for f in feats]), p.vox_corner_leaf,
                          p.vox_corner_cap, "line",
                          table_size=2 * p.vox_corner_cap, origin=anchor)
    smap = voxelmap.build(torch.cat([f[2] for f in feats]),
                          torch.cat([f[3] for f in feats]), p.vox_surf_leaf,
                          p.vox_surf_cap, "plane",
                          table_size=2 * p.vox_surf_cap, origin=anchor,
                          plane_min_spread=p.vox_plane_min_spread)
    cq, cm, sq, sm = features(data[14])
    # a small pose error, as the first Gauss-Newton iteration sees it
    d = se3.Pose.from_vec6(torch.tensor([0.01, -0.01, 0.02, 0.05, -0.03, 0.02],
                                        device=dev))
    q = d.apply(torch.cat([cq, sq]))
    return cmap, smap, q.contiguous(), torch.cat([cm, sm]), cq.shape[0]


def phase_kernels(data, p, dev):
    """Phase 3: every kernel of the path against its twin on the card."""
    import torch

    from msst_torch.ops import voxelmap

    cmap, smap, q, qm, n_a = _lookup_inputs(data, p, dev)
    got = voxelmap.lookup_cat(cmap, smap, q, qm, n_a)
    want = voxelmap.lookup_cat_plain(cmap, smap, q, qm, n_a)
    torch.cuda.synchronize()
    if not (torch.equal(got.idx, want.idx) and torch.equal(got.found, want.found)):
        raise AssertionError(
            "voxel_lookup_cat: idx/found differ from the twin in "
            f"{int((got.idx != want.idx).sum())}/"
            f"{int((got.found != want.found).sum())} of {q.shape[0]} queries")
    f = want.found
    err = 0.0
    for name in ("mean", "direction", "d"):
        a, b = getattr(got, name)[f], getattr(want, name)[f]
        if not torch.equal(a, b):
            raise AssertionError(f"voxel_lookup_cat: {name} not bit-equal "
                                 "to the twin where found")
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    runs = [("kernel", lambda: voxelmap.lookup_cat(cmap, smap, q, qm, n_a)),
            ("plain", lambda: voxelmap.lookup_cat_plain(cmap, smap, q, qm, n_a))]
    times = {"kernel": [], "plain": []}
    for name, fn in runs + runs[::-1]:   # kernel, plain, plain, kernel
        times[name].append(_cuda_ms(fn))
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    print(f"phase 3: voxel_lookup_cat == twin on {q.shape[0]} queries "
          f"({int(f.sum())} found; probe tables {cmap.table_size} + "
          f"{smap.table_size} rows; max_abs_err {err}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per call (CUDA events, 100 calls)",
          flush=True)
    return {"name": "voxel_lookup_cat", "route": "cuda",
            "source": "msst_torch/csrc/voxel_lookup.cu",
            "replaces": "msst_tpu/ops/voxelmap_pallas.py:115",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _accuracy(traj, data):
    """(max_err, final_err, drift_pct_per_m, path_len) against ground truth
    (bench.py's definition)."""
    gt0 = data[0]["gt_pose"][:3, 3]
    gt = np.stack([s["gt_pose"][:3, 3] - gt0 for s in data])
    est = traj.as_matrices()[:, :3, 3]
    n = min(len(est), len(gt))
    errs = np.linalg.norm(est[:n] - gt[:n], axis=1)
    path_len = float(np.linalg.norm(np.diff(gt[:n], axis=0), axis=1).sum())
    return (float(errs.max()), float(errs[-1]),
            100.0 * float(errs.max()) / max(path_len, 1e-6), path_len)


def phase_main_path(data, p, card):
    """Phase 4: the port's main path on the card, counters reset around it."""
    import torch

    from msst_torch.models.liosam import LioSam
    from msst_torch.ops import voxelmap

    lio = LioSam(p, device="cuda", boot_scans=BOOT_SCANS)
    voxelmap.lookup_cat.launches = 0
    step_ms = []
    t_all = time.perf_counter()
    for s in data:
        t0 = time.perf_counter()
        out = _feed(lio, s)
        out.pose_matrix.cpu()   # scan-to-pose: the pose is on the host
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = voxelmap.lookup_cat.launches
    if launches == 0:
        raise AssertionError("main path never launched voxel_lookup_cat")
    traj = lio.trajectory
    max_err, final_err, drift, path_len = _accuracy(traj, data)
    # steady state: drop the dynamic-init boot window and its re-feed
    boot = BOOT_SCANS + 1
    steady = np.asarray(step_ms[boot:])
    res = {
        "scans": len(data), "wall_s": wall, "launches": launches,
        "scans_per_s": len(steady) / (steady.sum() / 1000.0),
        "p50_ms": float(np.percentile(steady, 50)),
        "p99_ms": float(np.percentile(steady, 99)),
        "max_err_m": max_err, "final_err_m": final_err,
        "drift_pct_per_m": drift, "path_len_m": path_len,
        "keyframes": int(lio.state.kf.count),
        "map_health": lio.map_health, "step_ms": step_ms,
    }
    print(f"phase 4: LioSam cuda over {len(data)} scans x {N_SCAN}x{HORIZON}: "
          f"{launches} voxel_lookup_cat launches, {res['keyframes']} "
          f"keyframes; max err {max_err:.4f} m, final err {final_err:.4f} m, "
          f"drift {drift:.4f} %/m over {path_len:.1f} m; "
          f"{res['scans_per_s']:.2f} scans/s, per-scan p50 "
          f"{res['p50_ms']:.2f} ms p99 {res['p99_ms']:.2f} ms "
          f"(W=1, pose on host, scans {boot}+) [{card}]", flush=True)
    if drift > DRIFT_GATE_PCT or final_err > FINAL_GATE_M:
        raise AssertionError(
            f"accuracy gate: drift {drift:.4f} %/m (<= {DRIFT_GATE_PCT}), "
            f"final err {final_err:.4f} m (<= {FINAL_GATE_M})")
    return res


def phase_cpu(data, p):
    """Phase 5: the port on the CPU agrees with the port on the card (both
    with the default 8-scan boot, so both re-feed inside the window)."""
    from msst_torch.models.liosam import LioSam

    pos = []
    for dev in ("cuda", "cpu"):
        lio = LioSam(p, device=dev)
        for s in data[:N_CPU_SCANS]:
            _feed(lio, s)
        pos.append(lio.trajectory.as_matrices()[:, :3, 3])
    gap = float(np.linalg.norm(pos[0] - pos[1], axis=1).max())
    print(f"phase 5: LioSam cpu vs cuda over {N_CPU_SCANS} scans: max "
          f"position gap {gap:.6f} m (limit {CPU_AGREE_M})", flush=True)
    if gap > CPU_AGREE_M:
        raise AssertionError(f"cpu and cuda runs differ by {gap:.4f} m")
    return gap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the per-scan times and the result")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(f"phase 1: nvidia-smi '{card}'; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}",
          flush=True)

    from msst_torch import kernels

    t0 = time.perf_counter()
    cached = kernels.library_path("voxel_lookup").exists()
    kernels.load("voxel_lookup")
    build_s = time.perf_counter() - t0
    print(f"phase 2: built voxel_lookup with nvcc in {build_s:.2f} s"
          + (" (already built)" if cached else ""), flush=True)

    from msst_torch.utils import sim

    t0 = time.perf_counter()
    data = sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=N_SCANS, scan_dt=SCAN_DT,
                            n_scan=N_SCAN, horizon=HORIZON, seed=7)
    print(f"        simulated {N_SCANS} scans in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    p = _params()
    kern = phase_kernels(data, p, torch.device("cuda"))
    res = phase_main_path(data, p, card)
    kern["launches"] = res["launches"]
    res["cpu_gap_m"] = phase_cpu(data, p)
    res.update(card=card, build_s=build_s, kernels=[kern])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(res, f, indent=1)

    print(json.dumps({"kernels": [kern]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
