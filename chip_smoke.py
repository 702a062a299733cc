#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msst_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, one line each; any failure exits non-zero:

1. the card: nvidia-smi name and power limit, torch's device name
   (no CUDA device -> exit 1).
2. build the CUDA kernels from msst_torch/csrc with nvcc, one nvcc per
   source, all started together (the drives' scans are simulated in two
   worker processes meanwhile); each kernel's registers and spills as
   ``nvcc -Xptxas -v`` reports them.
3. each kernel against its plain PyTorch twin on the card, bit for bit, at
   the shapes its path gives it: B1 (3a) on the step's corner and surf
   voxel maps, and on two maps built for ties (voxel means at cell centres,
   queries at cell corners: up to 8 equidistant candidates across octants;
   masked queries; n_a splitting a warp); B2 (3b) as one ``query_cat`` of
   the step's corner and surf map clouds (the one launch of a Gauss-Newton
   iteration), equal to two ``query`` calls too, on a small case with a
   64-bucket table and 4 candidates a bucket (collisions, overflow, masked
   queries, short rows; k = 1, 5, 16), on a lattice whose candidates tie
   across probes out of point-index order (k = 5, 16), and on the two in
   one ``query_cat`` with n_a = 333, and at the calibration path's
   shapes (k, C, max_sqdist) = (1, 16, 1), (1, 16, 4), (10, 24, inf),
   (16, 24, inf), (48, 64, 1.4^2) and (11, 32, inf) on a 16384-slot cloud
   of phase 11's scene, and k = 48 on the lattice, ties at the 48th slot,
   and at the tracker's (8, 16, 0.2^2) on a 2048-bucket table over phase
   12b's first frame (1024 slots);
   B3, the row gather (3c), at
   pallas_bench's shapes and at every gather the loop makes from the
   keyframe store (256 and 1024 keyframes), and on clamped indices with the
   scalar path.  Then each kernel's time beside its twin's, the host's
   microseconds per call (1000 calls without a sync), its time for one
   query (B1, B2: the launch floor), its time on the device alone
   (torch.profiler), the least time the card
   could take for the same bytes and operations (each distinct probe row,
   bucket entry, point and row read once: msst_torch/utils/kernel_work.py
   for B1 and B2), and for B3 the time of ``torch.index_select``.
4. the main paths: ``LioSam(params, device="cuda").process_scan`` over the
   256-scan 16x1800 bench drive (circle r=10 m at 2 m/s, seed 7, loop
   closure off, max_keyframes=256), once with scan2map_method="voxel"
   (4a) and once with "knn" (4b, one B2 launch per Gauss-Newton
   iteration, checked against the iterations run); over bench.py's
   loop-on drive (340 scans, seed 8, loop closure on, 4c), which must
   close a loop.  Each
   drive's kernel launch counters are set to 0 just before it and read
   just after; the accuracy gates of bench.py (drift <= 0.5 %/m, final
   error <= 0.10 m); scans/s and per-scan p50/p99 (a loop attempt counts
   in the scan that dispatched it).  4d: the dense and the CG pose-graph
   solvers on bench.py's 512- and 1024-pose ring graphs, ms per
   Gauss-Newton iteration and their agreement.  4e: ``LioParams`` with its
   own defaults at 16x1800 (1024 keyframes, so the CG solver) over the
   loop-on drive, under the same gates, closing a loop, and solving by CG
   in ``_insert_keyframe`` and in each closing attempt.
5. the port on the CPU and on the card over the first scans of each path
   (24 voxel, 12 knn): the CPU drive within 1 cm of the mean of five
   drives on the card; each drive's gap and the drives' spread are
   printed.  Then one loop attempt from 4c's final state, on
   the card and on a CPU copy: the same outcome and candidate, keyframe
   poses within 1 cm.

6. 4a, 4b and 4c driven again: keyframe count, keyframe poses, loop
   events and trajectory bit-identical to the first drive (the port's
   sums add in a fixed order).
7. the bench drive with max_keyframes=16 per scan-to-map method (7a, 7b):
   ~30 keyframe evictions each, bench.py's gates, and on the incremental
   map the moment tables consistent with the stored keyframes.
8. map_update="rebuild" per vox_source (8a downsampled, 8b direct): the
   gates, the rebuild's ms per keyframe.  8b's final error is held to
   msst_tpu's own on that drive (DIRECT_FINAL_GATE_M), which misses
   bench.py's 0.10 m.
9. feature_method="exact": the gates, the frontend's ms per scan.
10. ``python -m msst_torch.models.liosam.demo``'s ``main`` over 40 scans,
   and ``save_map`` into a temporary directory: three PCDs holding the
   map's points.
11. the calibration path on the card at its defaults' sizes, on two
   64x1024 sweeps of sim.World() from a level master and a side mount
   (90 deg yaw, 45 deg pitch, ~0.5 m lever arm): 11a
   ``multi_lica.calibrate_pair`` with ``MultiLicaConfig()`` (and the port
   on the CPU beside it), 11b ``auto_calibrate`` from a lever-arm guess,
   11c ``NdtCalibrator.process_pair`` over 3 frames, each within 2 deg and
   0.2 m of the true mount and counted in B2 launches; 11d
   ``AllanCalibrator`` over a 2 h x 200 Hz log, the card against the CPU
   twin (the Allan variances and bias instabilities of the gyro axes
   within 1 %); 11e ``python -m msst_torch.cli calibrate`` by each method, its
   JSON equal to the library's.
12. the estimators beside LIO-SAM on the card: 12a ``heading_step`` with
   ``HeadingConfig()`` (16384 points after the voxel filter) over 50
   corridor frames of 28,800 points at 10 Hz (roll 3 deg, pitch -2 deg,
   yaw ramping 0 -> 20 deg), gated from the second frame on at roll and
   pitch within 1 deg, yaw (mod 180) within 2 deg, the four wall distances
   within 0.2 m and confidence 2, one B2 launch a frame, and the port on
   the CPU over the first 5 frames under the same gates; 12b
   ``track_step`` with ``TargetConfig()`` over 50 frames of a 0.1 m post
   moving at 2 m/s among background and clutter: detected every frame,
   centre within 0.05 m, the track within 0.2 m at the end, one B2 launch
   a frame; 12c ``PointCloudFusion`` (2 LiDARs, 131072 slots) of phase
   11's sweeps with their true mounts, equal in count and order to a
   float64 numpy reference and within 1e-4 m; 12d ``python -m
   msst_torch.cli heading`` and ``track`` on PCDs of 5 frames each, their
   JSON lines equal to the library's.
13. the LIO host commands on the card.  13a: ``msst_torch.cli.main(
   ["lio-kitti", DIR, ...])`` in this process at its own HDL-64 profile
   (64 x 1800, max_points 150,000, the default 8-scan boot) over a
   synthetic KITTI raw drive written in phase 2's worker pool (128 static
   sweeps of sim.World() on the bench circle, 64 rings over HDL-64E's
   -24.9..2.0 deg, 115,200 points each; OXTS rows at 100 Hz with the
   simulator's gyro, specific force, attitude and GNSS fix): drift <= 0.5
   %/m against the truth and the command's own ATE line <= 0.10 m, B1
   launched and at most once per Gauss-Newton iteration, scans/s and p50 /
   p99 ms a scan, keyframes; the port on the CPU over the first 8 scans
   (``--device cpu``, its own process, run during 13b) within 1 cm of the
   card; a ``--gps`` run of 48 scans through the command's ``_lio_run``
   (the covariance gate opened): the datum locks after 30 fixes, GPS
   factors enter the graph, and the ms of each keyframe after the first.
   13b: the bench drive (4a's scans) as a rosbag 2.0 of Ouster-layout
   clouds in recording order; ``iter_lio_inputs`` gives back the
   simulator's points and IMU, and as attitude the last IMU message's of
   its window (msst_tpu's reader); ``lio-bag`` within 1 cm of ``LioSam``
   fed those scans directly, seeded by that attitude; its accuracy
   printed, not gated (that attitude turns the map frame by 0.03 rad, and
   neither package meets bench.py's gates after it).  13c: ``python -m
   msst_torch.cli decode-pcap`` on tests/data/golden_packets.bin as a pcap,
   its PCD within 2e-3 of the numpy decoder with the native rings equal;
   ``packets_to_fixed_frame`` on the card within 1e-4 m of float64 numpy.
   13d: 13a's viewer files served by ``viz_html.make_server`` on
   127.0.0.1 with caching off, an overwrite seen on the next fetch.
14. multi-session mapping, 8 sessions as 8 slots of one card
   (``msst_torch.parallel``): ``multisession_drive`` over 56 scans with
   the frame offsets injected at scan 24 and ``cross_session_align`` every
   6 scans, and a control drive without it: 14a at ``drive_params()`` (16
   x 360) under tests/test_parallel.py's gates, 14b at bench.py's profile
   (16 x 1800, 256 keyframes) over 4 rounding-level perturbed feeds of the
   same drive (the control over the first): the speed, rendezvous and
   datum gates on every feed, the
   median of each ratio gate under the gate or, where msst_tpu misses it
   on one of the same feeds on the CPU, msst_tpu's largest (MS_REFERENCE);
   then one
   ``cooperative_map_merge`` and one ``cooperative_map_merge_selective``
   (budget 8) of 14b's final states and the peak device memory.  Fleet ms
   per step (p50, p99), scans/s over the sessions (the aligned drive's
   wall time, aligns included, and its steps alone), ms, host syncs
   (``torch.cuda.set_sync_debug_mode``) and ICP iterations per align, B1
   and B3 launches per drive.  The sessions' scans are simulated in phase
   2's workers.  14c: the grid ``registration.icp_point2point`` (B2 at
   k = 1, C = 16, phase 3b's first shape) on phase 11's master sweep
   recovers a known offset and agrees with the CPU twin.
15. windowed dispatch at bench.py's protocol (``LioSam(window=64)``):
   15a bench.py's phase 1, the 256-scan bench drive (seed 7) with the
   range-image grids attached, the first window synchronously (the boot
   and its re-feed of that whole window) and the other 192 scans through
   ``process_window_async``: every window in the hoisted range-image
   layout, B1 once per lookup, bench.py's gates; scans/s over the async
   part, ms a window (p50, p99; CUDA events on the dispatching stream),
   the host stages' seconds (pack, dispatch, flush_get).  15b bench.py's
   loop phase the same way (340 scans, seed 8, loop on): the gates, a
   loop closed, B3 launched.  15c W = 64 with ``quantized_upload=False``
   and no grids over 4a's drive: keyframe poses and trajectory
   bit-identical to 4a's W = 1 drive (both boot on 64 scans), and the
   host syncs a scan (``torch.cuda.set_sync_debug_mode``).  15d bench.py's
   live latency windows 1 (96 windows) and 4 (24), seed 9: process_window
   to the poses on the host and the scan-to-pose latency at 10 Hz, p50
   and p99.
Each of 6-15 drives the card and fails the run when its check fails.

Then one JSON line describing the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  --out DIR also writes the per-scan
times and the result there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

DRIFT_GATE_PCT = 0.5
FINAL_GATE_M = 0.10
CPU_AGREE_M = 0.01
N_SCANS = 256          # the bench drive
N_LOOP_SCANS = 340     # bench.py's loop-on drive: 34 s, past the 30 s age gate
N_CPU_SCANS = {"voxel": 24, "knn": 12}
N_CARD_DRIVES = 5      # drives on the card that phase 5 averages
# the card's published peaks (H100 SXM data sheet): device memory rate and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# dynamic-init boot window of the main-path run: bench.py's protocol boots
# on its first 64-scan window; at window=1 msst_tpu (and LioSam's default)
# boots on 8 scans, which on this drive leaves a ~0.19 m start offset that
# fails the final-error gate in both packages alike (see PERF.md)
BOOT_SCANS = 64
SCAN_DT = 0.1
N_SCAN, HORIZON = 16, 1800
# B3's inputs: scripts/pallas_bench.py's two shapes with random rows; then
# each gather the loop makes from the keyframe store, at bench-loop's
# max_keyframes (256) and at the default (1024): pose6 (6 floats a row) and
# the corner and surf clouds, by the newest keyframe (N = 1), the pair
# (newest, candidate) (N = 2, pose6 only) and the history window of 2 x 25 +
# 1 rows around the candidate, clamped to the store as the loop clamps it.
# The rows are those of bench-loop's closures: 60 keyframes, candidates 0-3.
GATHER_BENCH = [(131072, 24, 81920), (2048, 24, 10240)]
GATHER_LOOP_K = (256, 1024)
LOOP_CUR, LOOP_CAND = 59, 2
GATHER_TIMED = "loop surf K=256 window"   # the case of the kernels line
RING_SIZES = (512, 1024)
RING_ITERS = 9
RING_AGREE_M = 2e-2    # tests/test_graph.py:137 holds CG to dense so
# keyframe store of phase 7: the bench drive keeps ~46 keyframes, so the
# oldest is evicted ~30 times
EVICT_KEYFRAMES = 16
# final-error gate of phase 8b (map_update="rebuild", vox_source="direct"):
# msst_tpu's own final error on that drive at 16x1800, 0.15356 m on the CPU
# (scripts/torch_vs_ref_drive.py --horizon 1800 --packages msst_tpu --set
# map_update=rebuild --set vox_source=direct).  msst_tpu does not meet
# bench.py's FINAL_GATE_M in that mode; its drift gate holds as it is.
DIRECT_FINAL_GATE_M = 0.1536


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _params(method, loop=False):
    from msst_torch.models.liosam.params import LioParams

    return LioParams(n_scan=N_SCAN, horizon_scan=HORIZON,
                     max_points=N_SCAN * HORIZON + 64,
                     loop_closure_enabled=loop, max_keyframes=256,
                     scan2map_method=method)


def _simulate(n_scans, seed):
    """The bench drive's scans (runs in a worker process)."""
    from msst_torch.utils import sim

    return sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=n_scans, scan_dt=SCAN_DT, n_scan=N_SCAN,
                            horizon=HORIZON, seed=seed)


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


def _kernel_and_plain_ms(kernel, plain):
    """Least of two timings each, taken in turns: kernel, plain, plain,
    kernel."""
    runs = [("kernel", kernel), ("plain", plain)]
    times = {"kernel": [], "plain": []}
    for name, fn in runs + runs[::-1]:
        times[name].append(_cuda_ms(fn))
    return min(times["kernel"]), min(times["plain"])


def _device_ms(fn, kernel, n=20):
    """Device time of one call of `fn`, summed over the kernels whose name
    contains `kernel`, from a torch.profiler trace of n calls: what the
    card spends, without the host's share of a launch.  None where the
    trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time_total for ev in prof.key_averages()
                   if kernel in ev.key)
    return total_us / 1000.0 / n if total_us else None


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of its bytes over the memory rate and its operations
    over the float32 rate."""
    by_bytes = 1000.0 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1000.0 * n_ops / PEAK_F32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _step_features(data, p, dev):
    """The first 12 scans' corner and surf features at their true poses (the
    material of a local map), and a later scan's features (2048 + 8192
    slots) under a small pose error, as the first Gauss-Newton iteration
    sees them."""
    import torch

    from msst_torch.models.liosam import mapping
    from msst_torch.models.liosam.pipeline import LioSam
    from msst_torch.ops import se3

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
    cq, cm, sq, sm = features(data[14])
    d = se3.Pose.from_vec6(torch.tensor([0.01, -0.01, 0.02, 0.05, -0.03, 0.02],
                                        device=dev))
    q = d.apply(torch.cat([cq, sq])).contiguous()
    return feats, (q, torch.cat([cm, sm]), cq.shape[0])


def _host_us(fn, n=1000):
    """Host microseconds per call of `fn` over n calls without a sync: what
    the wrapper costs the caller's thread."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


# queries in the cell (INT32_MIN, 0, 0) of a 1 m grid at the origin: its
# hash is INT32_MIN itself (the multiplier of x is odd), the one value whose
# abs() stays negative, and its neighbours' x coordinates wrap
_EXTREME_Q = np.array([[-2.0 ** 31, 0.5, 0.5], [-2.0 ** 31, 0.25, 0.75]],
                      np.float32)


def _lookup_equal(label, vmap_a, vmap_b, q, qm, n_a):
    """voxelmap.lookup_cat (the kernel) against lookup_cat_plain on the card:
    idx and found everywhere, mean, direction and d where found, bit for
    bit.  Returns (result, max_abs_err)."""
    import torch

    from msst_torch.ops import voxelmap

    got = voxelmap.lookup_cat(vmap_a, vmap_b, q, qm, n_a)
    want = voxelmap.lookup_cat_plain(vmap_a, vmap_b, q, qm, n_a)
    torch.cuda.synchronize()
    if not (torch.equal(got.idx, want.idx) and torch.equal(got.found, want.found)):
        raise AssertionError(
            f"voxel_lookup_cat ({label}): idx/found differ from the twin in "
            f"{int((got.idx != want.idx).sum())}/"
            f"{int((got.found != want.found).sum())} of {q.shape[0]} queries")
    f = want.found
    err = 0.0
    for name in ("mean", "direction", "d"):
        x, y = getattr(got, name)[f], getattr(want, name)[f]
        if not torch.equal(x, y):
            raise AssertionError(f"voxel_lookup_cat ({label}): {name} not "
                                 "bit-equal to the twin where found")
        err = max(err, float((x - y).abs().max()) if x.numel() else 0.0)
    return got, err


def _tie_voxel_maps(dev):
    """Two voxel-feature maps whose voxel means sit exactly at their cell
    centres (4 points at +-1/4 leaf about each centre: a plane map at leaf
    1 m and a line map at leaf 0.5 m off the origin), ~30 % of the cells
    left empty; and queries at cell corners and edge midpoints, so that up
    to 8 candidate means across octants are equidistant.  ~10 % of the
    queries are masked, and n_a = 701 splits a warp's four queries."""
    import torch

    from msst_torch.ops import voxelmap

    gen = np.random.default_rng(5)
    maps, queries = [], []
    for kind, leaf, origin, n_q in (("plane", 1.0, (0.0, 0.0, 0.0), 701),
                                    ("line", 0.5, (0.25, -0.5, 0.0), 400)):
        o = np.asarray(origin, np.float32)
        cells = np.stack(np.meshgrid(*[np.arange(-4, 4)] * 3, indexing="ij"),
                         -1).reshape(-1, 3)
        cells = cells[gen.random(len(cells)) < 0.7]
        off = (np.array([[1, 1, 0], [1, -1, 0], [-1, 1, 0], [-1, -1, 0]])
               if kind == "plane" else
               np.array([[2, 0, 0], [-2, 0, 0], [1, 0, 0], [-1, 0, 0]]))
        off = off.astype(np.float32) * (0.25 if kind == "plane" else 0.125)
        centre = o + (cells + 0.5) * leaf
        pts = (centre[:, None] + off[None] * leaf).reshape(-1, 3)
        maps.append(voxelmap.build(
            torch.from_numpy(pts.astype(np.float32)).to(dev),
            torch.ones(len(pts), dtype=torch.bool, device=dev), leaf, 512,
            kind, table_size=1024, origin=torch.from_numpy(o).to(dev)))
        corner = gen.integers(-3, 4, (n_q, 3)).astype(np.float32)
        corner[n_q // 2:, 0] += 0.5                 # edge midpoints
        queries.append(o + corner * leaf)
    queries[0][:2] = _EXTREME_Q   # the cell (INT32_MIN, 0, 0) and its hash
    q = torch.from_numpy(np.concatenate(queries).astype(np.float32)).to(dev)
    qm = torch.from_numpy(gen.random(q.shape[0]) > 0.1).to(dev)
    return maps, q, qm, 701


def phase_voxel_lookup(feats, queries, p):
    """Phase 3, kernel B1: voxel_lookup_cat against its twin on the card, on
    a corner and a surf voxel-feature map at the step's capacities, and on
    two maps built for ties (``_tie_voxel_maps``)."""
    import torch

    from msst_torch.ops import voxelmap
    from msst_torch.utils.kernel_work import voxel_lookup_work

    q, qm, n_a = queries
    anchor = torch.zeros(3, device=q.device)
    cmap = voxelmap.build(torch.cat([f[0] for f in feats]),
                          torch.cat([f[1] for f in feats]), p.vox_corner_leaf,
                          p.vox_corner_cap, "line",
                          table_size=2 * p.vox_corner_cap, origin=anchor)
    smap = voxelmap.build(torch.cat([f[2] for f in feats]),
                          torch.cat([f[3] for f in feats]), p.vox_surf_leaf,
                          p.vox_surf_cap, "plane",
                          table_size=2 * p.vox_surf_cap, origin=anchor,
                          plane_min_spread=p.vox_plane_min_spread)
    got, err = _lookup_equal("the step's maps", cmap, smap, q, qm, n_a)
    (ta, tb), tq, tqm, tn_a = _tie_voxel_maps(q.device)
    tie, tie_err = _lookup_equal("ties", ta, tb, tq, tqm, tn_a)
    octants = torch.unique(tie.idx[tie.found] // voxelmap.PROBE_C).numel()
    if octants < 4 or bool(tie.found[~tqm].any()):
        raise AssertionError(f"voxel_lookup_cat: the tie case's winners lie "
                             f"on {octants} octants, or a masked query found")
    err = max(err, tie_err)

    def call():
        voxelmap.lookup_cat(cmap, smap, q, qm, n_a)

    ms, plain_ms = _kernel_and_plain_ms(
        call, lambda: voxelmap.lookup_cat_plain(cmap, smap, q, qm, n_a))
    floor_ms = _cuda_ms(lambda: voxelmap.lookup_cat(cmap, smap, q[:1], qm[:1], 1))
    host_us = _host_us(call)
    device_ms = _device_ms(call, "voxel_lookup_cat_kernel")
    work = voxel_lookup_work(cmap, smap, q, qm, n_a)
    bound_ms, bound_by = _bound(work["bytes"], work["ops"])
    print(f"phase 3a: voxel_lookup_cat == twin on {q.shape[0]} queries "
          f"({int(got.found.sum())} found; probe tables {cmap.table_size} + "
          f"{smap.table_size} rows) and on {tq.shape[0]} tie queries "
          f"({int(tie.found.sum())} found, winners on {octants} octants, "
          f"{int((~tqm).sum())} masked, n_a={tn_a}); max_abs_err {err}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call (CUDA "
          f"events, 100 calls); host {host_us:.1f} us per call (1000 calls, "
          f"no sync); one query {floor_ms:.4f} ms; on the device alone "
          f"{_fmt_ms(device_ms)} (torch.profiler); bound {bound_ms:.6f} ms "
          f"by {bound_by} ({work['bytes']} B: {work['rows']} distinct rows; "
          f"{work['ops']} operations)", flush=True)
    return {"name": "voxel_lookup_cat", "route": "cuda",
            "source": "msst_torch/csrc/voxel_lookup.cu",
            "replaces": "msst_tpu/ops/voxelmap_pallas.py:115",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "floor_ms": floor_ms, "device_ms": device_ms, "host_us": host_us,
            "distinct_rows": work["rows"], "bytes": work["bytes"]}


def _knn_equal(label, grid_a, grid_b, q, qm, n_a, k, cand,
               max_sqdist=float("inf")):
    """knn.query_cat (the kernel) against query_cat_plain on the card: every
    slot of idx, valid and sqdist bit-equal.  With grid_b None (and n_a
    None), knn.query against query_plain on grid_a.  Returns (result,
    max_abs_err)."""
    import torch

    from msst_torch.ops import knn

    if grid_b is None:
        got = knn.query(grid_a, q, qm, k=k, candidates_per_cell=cand,
                        max_sqdist=max_sqdist)
        want = knn.query_plain(grid_a, q, qm, k=k, candidates_per_cell=cand,
                               max_sqdist=max_sqdist)
    else:
        got = knn.query_cat(grid_a, grid_b, q, qm, n_a, k=k,
                            candidates_per_cell=cand)
        want = knn.query_cat_plain(grid_a, grid_b, q, qm, n_a, k=k,
                                   candidates_per_cell=cand)
    torch.cuda.synchronize()
    for name in ("idx", "valid", "sqdist"):
        a, b = getattr(got, name), getattr(want, name)
        if not torch.equal(a, b):
            raise AssertionError(
                f"knn_query ({label}): {name} differs from the twin in "
                f"{int((a != b).sum())} of {a.numel()} slots")
    n = max(g.xyz.shape[0] for g in (grid_a, grid_b) if g is not None)
    if int(got.idx.min()) < 0 or int(got.idx.max()) >= n:
        raise AssertionError(f"knn_query ({label}): index outside [0, {n})")
    fin = torch.isfinite(want.sqdist)
    err = float((got.sqdist[fin] - want.sqdist[fin]).abs().max()) if fin.any() else 0.0
    return got, err


def _lattice_grid(dev):
    """Points on a 0.5 m lattice (16^3, 5 % masked) in a 1 m grid of 1024
    buckets (8 points a cell, so C = 8 never overflows; 512 cells, so
    buckets collide), and queries at lattice-symmetric positions: cell
    corners + 0.75 (8 equidistant points in 8 cells), lattice points and
    edge points; 10 % masked.  Many candidates across probes tie."""
    import torch

    from msst_torch.ops import knn

    gen = np.random.default_rng(6)
    ax = np.arange(-8, 8) * 0.5
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[gen.permutation(len(pts))].astype(np.float32)
    mask = gen.random(len(pts)) > 0.05
    grid = knn.build(torch.from_numpy(pts).to(dev),
                     torch.from_numpy(mask).to(dev), 1.0, 1024)
    base = gen.integers(-3, 3, (900, 3)).astype(np.float32)
    q = np.concatenate([base[:300] + 0.75, base[300:600] * 0.5,
                        base[600:] + np.array([0.25, 0.75, 0.5], np.float32)])
    return (grid, torch.from_numpy(q.astype(np.float32)).to(dev),
            torch.from_numpy(gen.random(len(q)) > 0.1).to(dev))


def _ties_out_of_index_order(grid, res):
    """Adjacent equal finite distances whose sorted point positions
    descend: what a merge ordering ties by point index would get wrong."""
    import torch

    inv = torch.empty_like(grid.orig_idx, dtype=torch.long)
    inv[grid.orig_idx.long()] = torch.arange(grid.xyz.shape[0],
                                             device=inv.device)
    pos, d = inv[res.idx.long()], res.sqdist
    tie = (d[:, 1:] == d[:, :-1]) & torch.isfinite(d[:, 1:])
    return int((tie & (pos[:, 1:] < pos[:, :-1])).sum())


def phase_knn_query(feats, queries, p):
    """Phase 3, kernel B2: knn.query_cat against its twin on the card, on a
    corner and a surf map cloud at the step's capacities (the one launch of
    a Gauss-Newton iteration), and equal to two knn.query calls; on a small
    colliding case (k = 1, 5, 16), on a lattice whose candidates tie across
    probes (k = 5, 16), and on the two in one query_cat with n_a not a
    multiple of the lane group (16).  Then the times."""
    import torch

    from msst_torch.ops import knn, voxel
    from msst_torch.ops.pointcloud import Cloud
    from msst_torch.utils.kernel_work import knn_query_work

    q, qm, n_a = queries
    dev = q.device
    origin = torch.zeros(3, device=dev)
    cand = p.knn_candidates

    def grid_of(i, leaf, cap):
        cloud = voxel.voxel_downsample_packed(
            Cloud.create(torch.cat([f[i] for f in feats]),
                         mask=torch.cat([f[i + 1] for f in feats])),
            leaf, origin, capacity=cap)
        return knn.build(cloud.xyz, cloud.mask, 1.0, p.knn_table_size), cloud

    cgrid, ccloud = grid_of(0, p.mapping_corner_leaf_size, p.map_corner_cap)
    sgrid, scloud = grid_of(2, p.mapping_surf_leaf_size, p.map_surf_cap)
    res, err = _knn_equal("the step's maps", cgrid, sgrid, q, qm, n_a, 5, cand)
    cq, cqm = q[:n_a].contiguous(), qm[:n_a].contiguous()
    sq, sqm = q[n_a:].contiguous(), qm[n_a:].contiguous()
    cres = knn.query(cgrid, cq, cqm, k=5, candidates_per_cell=cand)
    sres = knn.query(sgrid, sq, sqm, k=5, candidates_per_cell=cand)
    for name in ("idx", "valid", "sqdist"):
        two = torch.cat([getattr(cres, name), getattr(sres, name)])
        if not torch.equal(getattr(res, name), two):
            raise AssertionError(f"knn_query: query_cat's {name} differs "
                                 "from two query calls")
    gated = int((res.valid.all(dim=1) & (res.sqdist[:, 4] < 1.0)).sum())

    # the small case: 64 buckets and 4 candidates a bucket, so that most of
    # the 27 probes collide, buckets overflow, and rows come up short
    gen = np.random.default_rng(3)
    pts = torch.from_numpy(gen.uniform(-6, 6, (3000, 3)).astype(np.float32)).to(dev)
    pmask = torch.from_numpy(gen.random(3000) < 0.9).to(dev)
    tq = gen.uniform(-8, 8, (1000, 3)).astype(np.float32)
    tq[:2] = _EXTREME_Q   # probe 13 hashes the cell (INT32_MIN, 0, 0)
    tq = torch.from_numpy(tq).to(dev)
    tqm = torch.from_numpy(gen.random(1000) < 0.8).to(dev)
    tiny = knn.build(pts, pmask, 1.0, 64)
    tres, terr = _knn_equal("64 buckets, 4 candidates", tiny, None, tq, tqm,
                            None, 5, 4)
    short = int((~tres.valid).any(dim=1).sum())
    if short == 0 or bool(tres.valid[~tqm].any()):
        raise AssertionError("knn_query: the small case has no short rows, "
                             "or a masked query came back valid")
    for k in (1, 16):
        _, e = _knn_equal(f"64 buckets, k={k}", tiny, None, tq, tqm, None,
                          k, 4)
        terr = max(terr, e)
    lgrid, lq, lqm = _lattice_grid(dev)
    ties = {}
    for k in (5, 16):
        lres, e = _knn_equal(f"lattice ties, k={k}", lgrid, None, lq, lqm,
                             None, k, 8)
        ties[k] = _ties_out_of_index_order(lgrid, lres)
        terr = max(terr, e)
    if min(ties.values()) == 0:
        raise AssertionError(f"knn_query: the lattice case has no ties out "
                             f"of point-index order ({ties})")
    mixed_q = torch.cat([tq[:333], lq]).contiguous()
    mixed_m = torch.cat([tqm[:333], lqm]).contiguous()
    for k in (5, 16):
        _, e = _knn_equal(f"query_cat of the small case and the lattice, "
                          f"k={k}", tiny, lgrid, mixed_q, mixed_m, 333, k,
                          4 if k == 5 else 8)
        terr = max(terr, e)
    err = max(err, terr)

    def call():
        knn.query_cat(cgrid, sgrid, q, qm, n_a, k=5, candidates_per_cell=cand)

    ms, plain_ms = _kernel_and_plain_ms(
        call, lambda: knn.query_cat_plain(cgrid, sgrid, q, qm, n_a, k=5,
                                          candidates_per_cell=cand))
    floor_ms = _cuda_ms(lambda: knn.query(sgrid, sq[:1], sqm[:1], k=5,
                                          candidates_per_cell=cand))
    host_us = _host_us(call)
    device_ms = _device_ms(call, "knn_query_kernel")
    work = knn_query_work(cgrid, sgrid, q, qm, n_a, cand, res.idx)
    bound_ms, bound_by = _bound(work["bytes"], work["ops"])
    print(f"phase 3b: knn_query == twin, all slots: one query_cat of {n_a} "
          f"corner queries on {int(ccloud.mask.sum())} of "
          f"{cgrid.xyz.shape[0]} map points and {q.shape[0] - n_a} surf "
          f"queries on {int(scloud.mask.sum())} of {sgrid.xyz.shape[0]} "
          f"(k=5, C={cand}, H={cgrid.table_size}; {gated} rows pass the 1 m "
          f"gate; {work['candidates']} candidates measured), equal to two "
          f"query calls; small case 1000 queries, H=64, C=4, k=1/5/16: "
          f"{short} short rows; lattice 900 queries, k=5/16: {ties} ties out "
          f"of point-index order; query_cat of the two with n_a=333; "
          f"max_abs_err {err}; one launch {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (CUDA events, 100 calls); host {host_us:.1f} "
          f"us per call (1000 calls, no sync); one query {floor_ms:.4f} ms; "
          f"on the device alone {_fmt_ms(device_ms)} (torch.profiler); "
          f"bound {bound_ms:.6f} ms by {bound_by} ({work['bytes']} B: "
          f"{work['bucket_entries']} bucket entries, {work['points']} "
          f"points, {work['winners']} winners; {work['ops']} operations)",
          flush=True)
    return {"name": "knn_query", "route": "cuda",
            "source": "msst_torch/csrc/knn_query.cu",
            "replaces": "msst_tpu/ops/knn_pallas.py:86",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "floor_ms": floor_ms, "device_ms": device_ms, "host_us": host_us,
            "work": work}


def _gather_cases(gen):
    """(label, H, W, idx) of every B3 case of phase 3c but the clamped one."""
    p = _params("voxel", loop=True)
    cases = [("pallas_bench", H, W, gen.integers(0, H, N))
             for H, W, N in GATHER_BENCH]
    n = p.history_keyframe_search_num
    for K in GATHER_LOOP_K:
        window = np.clip(np.arange(LOOP_CAND - n, LOOP_CAND + n + 1), 0, K - 1)
        for table, W in (("pose6", 6), ("corner", 3 * p.kf_corner_cap),
                         ("surf", 3 * p.kf_surf_cap)):
            rows = {"newest": [LOOP_CUR], "window": window}
            if table == "pose6":
                rows["pair"] = [LOOP_CUR, LOOP_CAND]
            for what, idx in rows.items():
                cases.append((f"loop {table} K={K} {what}", K, W,
                              np.asarray(idx)))
    return cases


def phase_gather_rows(dev):
    """Phase 3c, kernel B3: gather_rows against gather_rows_plain on the
    card, bit for bit, on pallas_bench's shapes and every gather the loop
    makes from the keyframe store (``_gather_cases``), and on a table whose
    rows are neither a multiple of 4 floats nor 16-byte aligned (the scalar
    path) with indices below 0 and at or above H (clamped).  Each case's
    time with the wrapper, on the device alone, the twin's, and
    ``torch.index_select`` of the clamped indices (one library call); its
    bound counts each distinct row read once."""
    import torch

    from msst_torch.ops import gather

    gen = np.random.default_rng(11)

    def check(label, table, idx):
        got = gather.gather_rows(table, idx)
        want = gather.gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"gather_rows ({label}): not bit-equal to "
                                 "the twin")
        return float((got - want).abs().max()) if got.numel() else 0.0

    cases, err = [], 0.0
    for label, H, W, rows in _gather_cases(gen):
        table = torch.from_numpy(
            gen.standard_normal((H, W), dtype=np.float32)).to(dev)
        idx = torch.from_numpy(rows.astype(np.int32)).to(dev)
        N = idx.shape[0]
        err = max(err, check(f"{label} {H}x{W}", table, idx))
        ms, plain_ms = _kernel_and_plain_ms(
            lambda: gather.gather_rows(table, idx),
            lambda: gather.gather_rows_plain(table, idx))
        library_ms = _cuda_ms(
            lambda: torch.index_select(table, 0, idx.clamp(0, H - 1)))
        device_ms = _device_ms(lambda: gather.gather_rows(table, idx),
                               "gather_rows_kernel")
        # each distinct row read once, each output float written once, each
        # index read once
        distinct = int(idx.clamp(0, H - 1).unique().numel())
        n_bytes = distinct * W * 4 + N * W * 4 + N * 4
        bound_ms, bound_by = _bound(n_bytes, 0)
        cases.append({"case": label, "H": H, "W": W, "N": N,
                      "distinct_rows": distinct, "ms": ms,
                      "device_ms": device_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": n_bytes})
        print(f"phase 3c: gather_rows == twin on ({H}, {W}) x {N} rows, "
              f"{distinct} distinct ({label}); kernel {ms:.4f} ms, on the "
              f"device alone {_fmt_ms(device_ms)}, plain {plain_ms:.4f} ms, "
              f"index_select {library_ms:.4f} ms per call (CUDA events, 100 "
              f"calls); bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} B)",
              flush=True)
        del table
    # the scalar path (130 floats a row, a 4-byte offset) on clamped indices
    H, W = 300, 130
    flat = torch.from_numpy(gen.normal(size=H * W + 1).astype(np.float32)).to(dev)
    table = flat[1:].view(H, W)
    idx = torch.from_numpy(gen.integers(-50, H + 50, 400).astype(np.int32)).to(dev)
    idx[:4] = torch.tensor([-1, -2**31, H, 2**31 - 1], dtype=torch.int32)
    clamped_err = check("clamped, scalar path", table, idx)
    err = max(err, clamped_err)
    print(f"phase 3c: gather_rows == twin on ({H}, {W}) x 400 rows at a "
          f"4-byte offset, {int((idx < 0).sum())} indices below 0 and "
          f"{int((idx >= H).sum())} at or above H; max_abs_err "
          f"{clamped_err}; over all {len(cases) + 1} cases {err}", flush=True)
    timed = next(c for c in cases if c["case"] == GATHER_TIMED)
    return {"name": "gather_rows", "route": "cuda",
            "source": "msst_torch/csrc/gather_rows.cu",
            "replaces": "msst_tpu/ops/gather_pallas.py:59",
            "max_abs_err": err, "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": timed["library_ms"],
            "device_ms": timed["device_ms"],
            "timed_case": f"{GATHER_TIMED}: ({timed['H']}, {timed['W']}) x "
                          f"{timed['N']}", "cases": cases}


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


def _record(lio, attempts=()):
    """What phase 6 holds a second drive to, bit for bit: the keyframe
    poses (their count with them), the loop events (found, current and
    candidate keyframe of each attempt) and the trajectory."""
    n = int(lio.state.kf.count)
    return {"pose6": lio.state.kf.pose6[:n].cpu().numpy(),
            "events": [(a["found"], a["cur"], a["cand"]) for a in attempts],
            "traj": lio.trajectory.as_matrices()}


def _check_lookups(tag, launches, runs, gn_total):
    """B1 on the voxel path: one launch for each lookup the Gauss-Newton
    loops took (`runs`: their ``ScanToMapResult``s; a loop looks up on its
    first iteration and again after each iteration whose pose moved past
    the re-association gate), some re-associations among them, and no more
    lookups than iterations.  Returns (lookups, re-associations)."""
    lookups = sum(r.lookups for r in runs)
    reassoc = lookups - len(runs)
    if launches != lookups or reassoc <= 0 or lookups > gn_total:
        raise AssertionError(
            f"{tag}: {launches} B1 launches for {lookups} lookups "
            f"({len(runs)} Gauss-Newton loops, {reassoc} re-associations) "
            f"in {gn_total} iterations")
    return lookups, reassoc


def phase_main_path(tag, method, kernel, data, card, records=None):
    """Phase 4: one main path of the port on the card.  Every kernel's
    launch count is set to 0 just before the drive and read just after;
    `kernel` is the one this path must have launched.  `records` takes the
    drive's ``_record`` under `tag`."""
    import torch

    from msst_torch.models.liosam import LioSam
    from msst_torch.ops import knn, registration, voxelmap

    counters = {"voxel_lookup_cat": voxelmap.lookup_cat, "knn_query": knn.query}
    lio = LioSam(_params(method), device="cuda", boot_scans=BOOT_SCANS)
    # every Gauss-Newton iteration of the drive (the boot re-feed's too),
    # kept on the device and summed after it
    entry = "scan_to_map" if method == "knn" else "scan_to_map_voxel"
    inner, gn_runs, s2m_runs = getattr(registration, entry), [], []

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        gn_runs.append(out.iterations)
        s2m_runs.append(out)
        return out

    setattr(registration, entry, counted)
    try:
        for fn in counters.values():
            fn.launches = 0
        step_ms, iters = [], []
        t_all = time.perf_counter()
        for s in data:
            t0 = time.perf_counter()
            out = _feed(lio, s)
            out.pose_matrix.cpu()   # scan-to-pose: the pose is on the host
            step_ms.append(1000.0 * (time.perf_counter() - t0))
            iters.append(out.s2m_iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
        launched = {name: fn.launches for name, fn in counters.items()}
    finally:
        setattr(registration, entry, inner)
    launches = launched[kernel]
    gn_total = int(torch.stack(gn_runs).sum()) if gn_runs else 0
    if launches == 0:
        raise AssertionError(f"the {method} path never launched {kernel}")
    # the knn path launches B2 once per iteration; the voxel path re-uses a
    # lookup while the pose has not moved past its re-association gate
    if method == "knn" and launches != gn_total:
        raise AssertionError(f"{launches} {kernel} launches for {gn_total} "
                             f"Gauss-Newton iterations ({method})")
    lookups = (_check_lookups(tag, launches, s2m_runs, gn_total)[0]
               if method == "voxel" else None)
    traj = lio.trajectory
    max_err, final_err, drift, path_len = _accuracy(traj, data)
    if records is not None:
        records[tag] = _record(lio)
    # steady state: drop the dynamic-init boot window and its re-feed
    boot = BOOT_SCANS + 1
    steady = np.asarray(step_ms[boot:])
    gn = torch.stack(iters).cpu().numpy()
    res = {
        "method": method, "scans": len(data), "wall_s": wall,
        "launches": launches, "launched": launched,
        "gn_iterations": gn_total, "lookups": lookups,
        "steps": len(data) + BOOT_SCANS,
        "gn_iterations_per_scan": float(gn[boot:].mean()),
        "scans_per_s": len(steady) / (steady.sum() / 1000.0),
        "p50_ms": float(np.percentile(steady, 50)),
        "p99_ms": float(np.percentile(steady, 99)),
        "max_err_m": max_err, "final_err_m": final_err,
        "drift_pct_per_m": drift, "path_len_m": path_len,
        "keyframes": int(lio.state.kf.count),
        "map_health": lio.map_health, "step_ms": step_ms,
    }
    print(f"phase {tag}: LioSam cuda, scan2map_method={method}, over "
          f"{len(data)} scans x {N_SCAN}x{HORIZON}: {launches} {kernel} "
          f"launches for {gn_total} GN iterations in {res['steps']} steps, "
          f"{res['gn_iterations_per_scan']:.2f} GN iterations per scan, "
          f"{res['keyframes']} keyframes; max err {max_err:.4f} m, final err "
          f"{final_err:.4f} m, drift {drift:.4f} %/m over {path_len:.1f} m; "
          f"{res['scans_per_s']:.2f} scans/s, per-scan p50 "
          f"{res['p50_ms']:.2f} ms p99 {res['p99_ms']:.2f} ms "
          f"(W=1, pose on host, scans {boot}+) [{card}]", flush=True)
    if drift > DRIFT_GATE_PCT or final_err > FINAL_GATE_M:
        raise AssertionError(
            f"accuracy gate ({method}): drift {drift:.4f} %/m (<= "
            f"{DRIFT_GATE_PCT}), final err {final_err:.4f} m (<= "
            f"{FINAL_GATE_M})")
    return res


def _loop_drive(tag, what, params, data, card, solvers=False, records=None):
    """One loop-on drive of ``LioSam(params, device="cuda")`` over `data`:
    the kernel launch counters are set to 0 just before it and read just
    after; every loop attempt is timed to the end of its device work, with
    its launches (and with `solvers`, its calls of the dense and the CG
    pose-graph solver) counted apart (profile_drive.watched_attempts).
    The drive must pass bench.py's gates and close at least one loop, and
    its attempts must launch B1 and B3."""
    import torch

    from msst_torch.models.liosam import LioSam
    from msst_torch.ops import gather, graph, knn, voxelmap
    from msst_torch.utils.profile_drive import counted_calls, watched_attempts

    kernels = {"voxel_lookup_cat": voxelmap.lookup_cat,
               "knn_query": knn.query, "gather_rows": gather.gather_rows}
    targets = [(graph, "optimize"), (graph, "optimize_cg")] if solvers else []
    attempts = []
    lio = LioSam(params, device="cuda", boot_scans=BOOT_SCANS)
    with counted_calls(targets) as calls:
        counters = {name: (lambda fn=fn: fn.launches)
                    for name, fn in kernels.items()}
        counters.update({name: (lambda name=name: calls[name])
                         for name in calls})
        with watched_attempts(attempts, counters):
            for fn in kernels.values():
                fn.launches = 0
            step_ms = []
            for s in data:
                t0 = time.perf_counter()
                _feed(lio, s).pose_matrix.cpu()
                step_ms.append(1000.0 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            launched = {name: fn.launches for name, fn in kernels.items()}
    max_err, final_err, drift, path_len = _accuracy(lio.trajectory, data)
    if records is not None:
        records[tag] = _record(lio, attempts)
    steady = np.asarray(step_ms[BOOT_SCANS + 1:])
    in_loop = {name: sum(a["counts"][name] for a in attempts)
               for name in counters}
    with_cand = [a for a in attempts if a["tried"]]
    att_ms = np.asarray([a["ms"] for a in with_cand]) if with_cand else None
    loops = int(lio.state.n_loop)
    res = {
        "scans": len(data), "launched": launched, "in_attempts": in_loop,
        "calls": dict(calls), "attempts": attempts, "loops_closed": loops,
        "scans_per_s": len(steady) / (steady.sum() / 1000.0),
        "p50_ms": float(np.percentile(steady, 50)),
        "p99_ms": float(np.percentile(steady, 99)),
        "max_err_m": max_err, "final_err_m": final_err,
        "drift_pct_per_m": drift, "path_len_m": path_len,
        "keyframes": int(lio.state.kf.count), "step_ms": step_ms,
        "attempt_p50_ms": float(np.percentile(att_ms, 50)) if with_cand else None,
        "attempt_max_ms": float(att_ms.max()) if with_cand else None,
    }
    solved = ""
    if solvers:
        res["solver_calls_outside_attempts"] = {
            name: calls[name] - in_loop[name] for name in calls}
        solved = (f"; pose-graph solves in attempts {{dense "
                  f"{in_loop['graph.optimize']}, CG "
                  f"{in_loop['graph.optimize_cg']}}}, outside them (in "
                  f"_insert_keyframe) {res['solver_calls_outside_attempts']}")
    print(f"phase {tag}: LioSam cuda, {what}, over {len(data)} scans x "
          f"{N_SCAN}x{HORIZON} (seed 8): {len(attempts)} attempts "
          f"dispatched, {len(with_cand)} with a candidate, {loops} loops "
          f"closed; per attempt with a candidate p50 "
          f"{_fmt_ms(res['attempt_p50_ms'])} max "
          f"{_fmt_ms(res['attempt_max_ms'])}; launches in attempts: B1 "
          f"{in_loop['voxel_lookup_cat']}, B3 {in_loop['gather_rows']}, B2 "
          f"{in_loop['knn_query']} (drive {launched}){solved}; "
          f"{res['keyframes']} keyframes; max err {max_err:.4f} m, final err "
          f"{final_err:.4f} m, drift {drift:.4f} %/m over {path_len:.1f} m; "
          f"{res['scans_per_s']:.2f} scans/s, per-scan p50 "
          f"{res['p50_ms']:.2f} ms p99 {res['p99_ms']:.2f} ms (W=1, pose on "
          f"host, scans {BOOT_SCANS + 1}+) [{card}]", flush=True)
    for a in attempts:
        print(f"        attempt: {a}", flush=True)
    if drift > DRIFT_GATE_PCT or final_err > FINAL_GATE_M:
        raise AssertionError(
            f"accuracy gate ({what}): drift {drift:.4f} %/m (<= "
            f"{DRIFT_GATE_PCT}), final err {final_err:.4f} m (<= "
            f"{FINAL_GATE_M})")
    if loops < 1:
        raise AssertionError(f"the drive ({what}) closed no loop")
    if in_loop["gather_rows"] == 0 or in_loop["voxel_lookup_cat"] == 0:
        raise AssertionError(f"the loop attempts launched {in_loop}")
    return res, lio.state


def phase_loop_path(data, card, records=None):
    """Phase 4c: the loop-on main path on the card, bench.py's loop phase
    (bench-voxel's configuration with loop closure on: an attempt every 10
    scans behind the host pre-gate, the dense solver at 256 keyframes)."""
    return _loop_drive("4c", "loop closure on", _params("voxel", loop=True),
                       data, card, records=records)


def phase_defaults_path(data, card):
    """Phase 4e: ``LioSam(LioParams(...))`` with the package's own defaults
    but the sensor's size (16 x 1800), so 1024 keyframes and the CG solver,
    over the loop-on drive: the CG solver must run in _insert_keyframe and
    in a closing attempt's re-solve, and the dense one never."""
    from msst_torch.models.liosam.params import LioParams

    p = LioParams(n_scan=N_SCAN, horizon_scan=HORIZON,
                  max_points=N_SCAN * HORIZON + 64)
    res, _ = _loop_drive(
        "4e", f"LioParams defaults (max_keyframes {p.max_keyframes}, "
        f"cg_threshold {p.cg_threshold}, loop closure "
        f"{p.loop_closure_enabled})", p, data, card, solvers=True)
    outside = res["solver_calls_outside_attempts"]
    closing = [a for a in res["attempts"] if a["found"]]
    if (res["calls"]["graph.optimize"] or outside["graph.optimize_cg"] == 0
            or not all(a["counts"]["graph.optimize_cg"] for a in closing)):
        raise AssertionError(
            f"the defaults' drive did not solve by CG alone: {res['calls']}, "
            f"outside attempts {outside}")
    return res


def phase_graph_solvers(card):
    """Phase 4d: the dense and the CG pose-graph solvers on bench.py's ring
    graphs at RING_SIZES poses, on the card: ms per Gauss-Newton iteration
    as bench.py takes it ((wall of RING_ITERS - wall of 1) / (RING_ITERS -
    1), each the best of two), and the largest gap between their poses
    after RING_ITERS iterations."""
    import torch

    from msst_torch.ops import graph
    from msst_torch.utils.ring_graph import make_ring_graph

    res = {}
    for K in RING_SIZES:
        g = make_ring_graph(K, device="cuda")

        def ms_per_iter(solve):
            def wall(iters):
                best = float("inf")
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = solve(g, iters=iters)
                    torch.cuda.synchronize()
                    best = min(best, time.perf_counter() - t0)
                return best, out

            w1, _ = wall(1)
            wk, out = wall(RING_ITERS)
            return 1000.0 * (wk - w1) / (RING_ITERS - 1), out

        dense_ms, dense = ms_per_iter(graph.optimize)
        cg_ms, cg = ms_per_iter(graph.optimize_cg)
        gap = float((dense.poses.t - cg.poses.t).abs().max())
        rot = float(1.0 - (dense.poses.q * cg.poses.q).sum(-1).abs().min())
        res[K] = {"dense_ms_per_iter": dense_ms, "cg_ms_per_iter": cg_ms,
                  "gap_m": gap, "rot_gap_1_minus_dot": rot}
        print(f"phase 4d: ring graph of {K} poses on the card: dense "
              f"{dense_ms:.3f} ms, CG {cg_ms:.3f} ms per GN iteration; after "
              f"{RING_ITERS} iterations the poses differ by at most "
              f"{gap:.6f} m (limit {RING_AGREE_M}), 1 - |q.q| {rot:.2e} "
              f"[{card}]", flush=True)
        if not gap <= RING_AGREE_M:
            raise AssertionError(f"dense and CG differ by {gap} m at K={K}")
    return res


def phase_cpu_loop(state, card):
    """Phase 5, loop closure: one forced attempt from the loop drive's final
    state on the card and on a CPU copy of that state: the same outcome,
    the same candidate where found, keyframe poses within CPU_AGREE_M."""
    import torch

    from msst_torch import convert
    from msst_torch.models.liosam import loop

    p = _params("voxel", loop=True)
    cpu_state = convert.from_numpy(convert.to_numpy(state), "cpu")
    t0 = time.perf_counter()
    card_new, card_res = loop.loop_closure_step(state, p)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_new, cpu_res = loop.loop_closure_step(cpu_state, p)
    cpu_s = time.perf_counter() - t0
    a, b = convert.to_numpy(card_res), convert.to_numpy(cpu_res)
    n = int(cpu_new.kf.count)
    gap = float(np.abs(card_new.kf.pose6[:n].cpu().numpy()
                       - cpu_new.kf.pose6[:n].numpy()).max())
    print(f"phase 5: one loop attempt from the loop drive's final state: "
          f"cuda found={bool(a.found)} cur={int(a.cur)} cand={int(a.cand)} "
          f"fitness={float(a.fitness):.6f} icp_iters={int(a.icp_iters)} "
          f"({card_s:.2f} s); cpu found={bool(b.found)} cur={int(b.cur)} "
          f"cand={int(b.cand)} fitness={float(b.fitness):.6f} "
          f"icp_iters={int(b.icp_iters)} ({cpu_s:.2f} s); largest keyframe "
          f"pose gap {gap:.6f} (limit {CPU_AGREE_M}) over {n} keyframes "
          f"[{card}]", flush=True)
    if bool(a.found) != bool(b.found) or int(a.cur) != int(b.cur) or (
            bool(a.found) and int(a.cand) != int(b.cand)):
        raise AssertionError("the loop attempt differs between cpu and cuda")
    if not gap <= CPU_AGREE_M:
        raise AssertionError(f"loop attempt keyframe poses differ by {gap}")
    return {"found": bool(a.found), "cand": int(a.cand),
            "fitness_cuda": float(a.fitness), "fitness_cpu": float(b.fitness),
            "pose_gap": gap, "cuda_s": card_s, "cpu_s": cpu_s}


def phase_cpu(method, data):
    """Phase 5: the port on the CPU agrees with the port on the card (both
    with the default 8-scan boot, so both re-feed inside the window).

    The card is driven N_CARD_DRIVES times and the CPU drive is held
    against the mean of those trajectories (the limit kept from before the
    port's sums added in a fixed order, when one drive on the card was a
    noisy sample); the CPU adds in another order than the card, and the
    knn path turns the last bits into millimetres while the map is one
    keyframe old (neighbours along one lidar ring are collinear, and the
    normal of a plane through them is set by rounding).  Every drive's own
    gap and the drives' spread about their mean are printed beside the
    gated number."""
    from msst_torch.models.liosam import LioSam

    n = N_CPU_SCANS[method]

    def positions(dev):
        lio = LioSam(_params(method), device=dev)
        for s in data[:n]:
            _feed(lio, s)
        return lio.trajectory.as_matrices()[:, :3, 3]

    def far(a, b):
        return float(np.linalg.norm(a - b, axis=1).max())

    cpu = positions("cpu")
    cards = [positions("cuda") for _ in range(N_CARD_DRIVES)]
    mean = np.mean(cards, axis=0)
    gap = far(cpu, mean)
    each = [far(cpu, c) for c in cards]
    spread = max(far(c, mean) for c in cards)
    print(f"phase 5: LioSam cpu vs cuda, scan2map_method={method}, over {n} "
          f"scans: max position gap {gap:.6f} m between the cpu drive and "
          f"the mean of {N_CARD_DRIVES} cuda drives (limit {CPU_AGREE_M}); "
          f"each cuda drive against the cpu drive "
          f"{', '.join(f'{g:.6f}' for g in each)} m; the cuda drives lie "
          f"within {spread:.6f} m of their mean", flush=True)
    if gap > CPU_AGREE_M:
        raise AssertionError(
            f"cpu and cuda runs ({method}) differ by {gap:.4f} m")
    return {"cpu_gap_m": gap, "cpu_gap_each_m": each,
            "cuda_spread_m": spread}


def _drive_record(params, data):
    """One drive of ``LioSam(params, device="cuda")`` over `data`, and its
    ``_record`` (loop attempts included)."""
    import torch

    from msst_torch.models.liosam import LioSam
    from msst_torch.utils.profile_drive import watched_attempts

    attempts = []
    lio = LioSam(params, device="cuda", boot_scans=BOOT_SCANS)
    with watched_attempts(attempts):
        for s in data:
            _feed(lio, s)
        torch.cuda.synchronize()
    return _record(lio, attempts)


def _repeat_gaps(a, b):
    """How far two drives' ``_record``s lie apart, and whether they are
    bit-identical."""
    n = min(len(a["pose6"]), len(b["pose6"]))
    m = min(len(a["traj"]), len(b["traj"]))
    gaps = {
        "keyframes": [len(a["pose6"]), len(b["pose6"])],
        "loop_events": [a["events"], b["events"]],
        "pose6_max_abs_gap": float(np.abs(a["pose6"][:n]
                                          - b["pose6"][:n]).max()),
        "trajectory_max_gap_m": float(np.linalg.norm(
            a["traj"][:m, :3, 3] - b["traj"][:m, :3, 3], axis=1).max()),
    }
    gaps["bit_identical"] = (a["pose6"].shape == b["pose6"].shape
                             and np.array_equal(a["pose6"], b["pose6"])
                             and a["events"] == b["events"]
                             and a["traj"].shape == b["traj"].shape
                             and np.array_equal(a["traj"], b["traj"]))
    return gaps


def phase_repeat(cases, records, card):
    """Phase 6: each of 4a, 4b and 4c driven once more on the card: the
    keyframe count, the keyframe poses, the loop events and the trajectory
    must equal the first drive's bit for bit (the port's sums add in a fixed
    order).  `cases`: tag -> (params, data)."""
    res = {}
    for tag, (params, data) in cases.items():
        gaps = res[tag] = _repeat_gaps(records[tag],
                                       _drive_record(params, data))
        first, second = gaps["loop_events"]
        print(f"phase 6: {tag} driven again on the card: keyframes "
              f"{gaps['keyframes']}, loop events {first} then {second}; "
              f"largest keyframe pose6 gap {gaps['pose6_max_abs_gap']}, "
              f"trajectory gap {gaps['trajectory_max_gap_m']} m; "
              f"bit-identical {gaps['bit_identical']} [{card}]", flush=True)
        if not gaps["bit_identical"]:
            raise AssertionError(f"the second drive of {tag} differs from "
                                 f"the first: {gaps}")
    return res


@contextmanager
def _synced_ms(mod, name, ms):
    """While the context lasts, each call of mod.name synchronises the
    device before and after and appends its milliseconds to `ms`."""
    import torch

    fn = getattr(mod, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        ms.append(1000.0 * (time.perf_counter() - t0))
        return out

    setattr(mod, name, timed)
    try:
        yield ms
    finally:
        setattr(mod, name, fn)


def _option_drive(tag, what, params, data, card, span=None,
                  final_gate_m=FINAL_GATE_M):
    """One drive of the 256-scan bench drive with `params` on the card under
    bench.py's drift gate and the final-error gate `final_gate_m`; the
    kernel launch counters are set to 0 just before it and read just after,
    keyframe evictions counted, and `span` (module, attribute) timed per
    call with the device synchronised around it.  Returns (result, the
    LioSam)."""
    import torch

    from msst_torch.models.liosam import LioSam, mapping
    from msst_torch.ops import knn, voxelmap
    from msst_torch.utils.profile_drive import counted_calls

    kernels = {"voxel_lookup_cat": voxelmap.lookup_cat,
               "knn_query": knn.query}
    span_ms: list = []
    lio = LioSam(params, device="cuda", boot_scans=BOOT_SCANS)
    timing = _synced_ms(*span, span_ms) if span else contextlib.nullcontext()
    with counted_calls([(mapping, "_evict_oldest_keyframe")]) as calls, \
            timing:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for s in data:
            _feed(lio, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {name: fn.launches for name, fn in kernels.items()}
    max_err, final_err, drift, path_len = _accuracy(lio.trajectory, data)
    res = {"what": what, "scans": len(data), "wall_s": wall,
           "launched": launched,
           "evictions": calls["mapping._evict_oldest_keyframe"],
           "keyframes": int(lio.state.kf.count), "max_err_m": max_err,
           "final_err_m": final_err, "drift_pct_per_m": drift,
           "path_len_m": path_len}
    if span:
        res["span"] = f"{span[0].__name__}.{span[1]}"
        res["span_calls"] = len(span_ms)
        res["span_ms_per_call"] = float(np.mean(span_ms)) if span_ms else None
    print(f"phase {tag}: LioSam cuda, {what}, over {len(data)} scans x "
          f"{N_SCAN}x{HORIZON}: {res['evictions']} keyframe evictions, "
          f"{res['keyframes']} keyframes held; launches B1 "
          f"{launched['voxel_lookup_cat']}, B2 {launched['knn_query']}; "
          + (f"{res['span']} {res['span_ms_per_call']:.3f} ms per call over "
             f"{res['span_calls']} calls (synchronised); " if span else "")
          + f"max err {max_err:.4f} m, final err {final_err:.4f} m, drift "
          f"{drift:.4f} %/m over {path_len:.1f} m; {wall:.1f} s [{card}]",
          flush=True)
    if drift > DRIFT_GATE_PCT or final_err > final_gate_m:
        raise AssertionError(
            f"accuracy gate ({what}): drift {drift:.4f} %/m (<= "
            f"{DRIFT_GATE_PCT}), final err {final_err:.4f} m (<= "
            f"{final_gate_m})")
    return res, lio


def phase_eviction(method, data, card):
    """Phase 7: the bench drive with a store of EVICT_KEYFRAMES keyframes, so
    that the oldest is evicted with marginalization again and again, under
    bench.py's gates; on the incremental map the moment tables stay
    consistent with the stored keyframes (tests/test_liosam_incmap.py's
    checks: every alive cell counts >= 0.5 points, and all of them no more
    than the stored surf points)."""
    import dataclasses

    from msst_torch.ops import voxelmap

    p = dataclasses.replace(_params(method), max_keyframes=EVICT_KEYFRAMES)
    tag = "7a" if method == "voxel" else "7b"
    res, lio = _option_drive(tag, f"scan2map_method={method}, max_keyframes="
                             f"{EVICT_KEYFRAMES}", p, data, card)
    kernel = "voxel_lookup_cat" if method == "voxel" else "knn_query"
    if res["evictions"] < 10 or res["launched"][kernel] == 0:
        raise AssertionError(f"the eviction drive ({method}) evicted "
                             f"{res['evictions']} times and launched "
                             f"{res['launched']}")
    if method == "voxel":
        mom, kf = lio.state.local_map.surf_mom, lio.state.kf
        alive = mom.key < voxelmap._BIG
        cnt = mom.cnt[alive]
        stored = int(kf.surf_mask[:int(kf.count)].sum())
        res["alive_cells"] = int(alive.sum())
        res["alive_count_sum"] = float(cnt.sum())
        res["stored_surf_points"] = stored
        print(f"        moments: {res['alive_cells']} alive surf cells, "
              f"least count {float(cnt.min())}, counts sum to "
              f"{res['alive_count_sum']} of {stored} stored surf points",
              flush=True)
        if not (bool((cnt >= 0.5).all()) and float(cnt.sum()) <= stored + 1e-3):
            raise AssertionError("the moment tables disagree with the "
                                 "stored keyframes after eviction")
    return res


def phase_rebuild(source, data, card):
    """Phase 8: the voxel method with map_update="rebuild" (the local map
    refit from the nearby keyframes at each keyframe) and `source` as its
    fit input, under bench.py's gates; the rebuild's ms per keyframe.

    vox_source="direct" (the raw keyframe features, no centroid pass) keeps
    the drift gate, and its final error is held to msst_tpu's own on this
    drive, DIRECT_FINAL_GATE_M: msst_tpu misses bench.py's 0.10 m in this
    mode (PERF.md section 6)."""
    import dataclasses

    from msst_torch.models.liosam import mapping

    p = dataclasses.replace(_params("voxel"), map_update="rebuild",
                            vox_source=source)
    tag = "8a" if source == "downsampled" else "8b"
    res, _ = _option_drive(tag, f"map_update=rebuild, vox_source={source}",
                           p, data, card,
                           span=(mapping, "_rebuild_local_map"),
                           final_gate_m=(DIRECT_FINAL_GATE_M
                                         if source == "direct"
                                         else FINAL_GATE_M))
    if res["launched"]["voxel_lookup_cat"] == 0 or not res["span_calls"]:
        raise AssertionError(f"the rebuild drive ({source}) launched "
                             f"{res['launched']}, rebuilt "
                             f"{res['span_calls']} times")
    return res


def phase_exact_features(data, card):
    """Phase 9: the voxel method with feature_method="exact" (the
    reference's greedy corner picks) under bench.py's gates; the frontend's
    ms per scan."""
    import dataclasses

    from msst_torch.models.liosam import mapping

    p = dataclasses.replace(_params("voxel"), feature_method="exact")
    res, _ = _option_drive("9", "feature_method=exact", p, data, card,
                           span=(mapping, "run_frontend"))
    if res["launched"]["voxel_lookup_cat"] == 0:
        raise AssertionError(f"the exact-feature drive launched "
                             f"{res['launched']}")
    return res


def _pcd_points(path):
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"POINTS"):
                return int(line.split()[1])
    raise AssertionError(f"{path}: no POINTS line")


def phase_demo(card):
    """Phase 10: ``python -m msst_torch.models.liosam.demo`` (its ``main``)
    over 40 scans on the card, then ``save_map`` into a temporary
    directory: the three PCDs exist and hold the map's points."""
    import tempfile

    from msst_torch.models.liosam import demo

    t0 = time.perf_counter()
    lio = demo.main(["--scans", "40"])
    wall = time.perf_counter() - t0
    if lio.device.type != "cuda":
        raise AssertionError(f"the demo ran on {lio.device}")
    with tempfile.TemporaryDirectory() as d:
        out = lio.save_map(d)
        counts = {name: _pcd_points(os.path.join(d, f"{name}.pcd"))
                  for name in ("corner_map", "surf_map", "global_map")}
    want = {"corner_map": len(out["corner_map"]),
            "surf_map": len(out["surf_map"])}
    want["global_map"] = want["corner_map"] + want["surf_map"]
    print(f"phase 10: demo.main(--scans 40) on {lio.device}: "
          f"{int(lio.state.kf.count)} keyframes in {wall:.1f} s; save_map "
          f"wrote {counts} points, the map holds {want} [{card}]",
          flush=True)
    if counts != want or want["surf_map"] == 0:
        raise AssertionError(f"save_map wrote {counts}, want {want}")
    return {"points": counts, "wall_s": wall,
            "keyframes": int(lio.state.kf.count)}


# phase 11's scene: two 64 x 1024 sweeps (65,536 points each, the golden
# calibration tests' CAP) ray-cast in sim.World() from a level master at
# CALIB_MASTER_XYZ and a side mount with 90 degrees of yaw, 45 of pitch and
# a ~0.5 m lever arm (the Multi_LiCa demo rig's geometry).  msst_tpu on this
# scene, on the CPU: Multi_LiCa 0.7135 deg / 0.0884 m, auto_calibrate (the
# lever arm + (0.1, -0.1, 0.05) m as its guess) 0.0000 deg / 0.0058 m, NDT
# over 3 frames of every 4th point from the mount off by (1, -1, 2) deg and
# that lever-arm error 0.6272 deg / 0.1578 m; of the other master positions
# tried ((3, 2), (5, -4), (-20, -12) m and two other mounts) msst_tpu's
# Multi_LiCa flipped 180 degrees on each.  Every method is gated at
# tests/test_calibration.py's 2 degrees and 0.2 m, looser than each of
# msst_tpu's errors here.
CALIB_MASTER_XYZ = (-5.0, 0.0, 1.8)
CALIB_SIDE_RPY_DEG = (0.0, 45.0, 90.0)
CALIB_LEVER_M = (0.1, 0.45, -0.2)
CALIB_SEED = 11
CALIB_GATE_DEG = 2.0
CALIB_GATE_M = 0.2
CALIB_GUESS_RPY_DEG = (1.0, -1.0, 2.0)     # NDT's initial guess, off the mount
CALIB_GUESS_T_M = (0.1, -0.1, 0.05)        # and the lever-arm guesses' error
NDT_FRAMES = 3
# 11d: a 2 h log at 200 Hz, white noise densities and bias walks of a MEMS
# IMU, gravity on acc z
ALLAN_SAMPLES = 2 * 3600 * 200
ALLAN_DT = 0.005
ALLAN_GYR_N = 1.5e-3       # rad/s/sqrt(Hz)
ALLAN_ACC_N = 4.0e-3       # m/s^2/sqrt(Hz)
ALLAN_AGREE = 0.01         # card against the CPU twin, relative
# B2 at the calibration path's shapes (label, k, C, max_sqdist, grid cell,
# table, queries): the source cloud's queries against the target grid, or
# the target's own points
KNN_CALIB_SHAPES = (
    ("GICP, NDT, manual score", 1, 16, 1.0, 1.4, 16384, "source"),
    ("yaw search", 1, 16, 4.0, 2.0, 8192, "source"),
    ("covariances k=10", 10, 24, float("inf"), 1.0, 8192, "self"),
    ("covariances k=16", 16, 24, float("inf"), 1.4, 16384, "self"),
    ("normals and FPFH", 48, 64, 1.4 ** 2, 1.4, 16384, "self"),
    ("outlier removal (k + 1)", 11, 32, float("inf"), 1.0, 8192, "self"),
)
CALIB_TIMED_CALLS = 20


def _mount(rpy_deg, t):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("xyz", np.radians(rpy_deg)).as_matrix()
    T[:3, 3] = t
    return T


def _calib_scene():
    """(master sweep, side sweep, true side -> master extrinsic)."""
    from msst_torch.utils import sim

    rng = np.random.default_rng(CALIB_SEED)
    T_wm = _mount((0.0, 0.0, 0.0), CALIB_MASTER_XYZ)
    T_ms = _mount(CALIB_SIDE_RPY_DEG, CALIB_LEVER_M)
    world = sim.World()
    m, *_ = sim.raycast_scan(world, T_wm, n_scan=64, horizon=1024, rng=rng)
    s, *_ = sim.raycast_scan(world, T_wm @ T_ms, n_scan=64, horizon=1024,
                             rng=rng)
    return m, s, T_ms


def _pose_err(T, T_gt):
    """(degrees, metres) between two 4x4 transforms."""
    T = np.asarray(T, np.float64)
    c = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1.0) / 2.0
    return (float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))),
            float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3])))


def _matrix(pose):
    return pose.to_matrix().detach().cpu().numpy()


def _prepped(xyz, dev, pose=None):
    """Multi_LiCa's prep of a sweep on `dev`: the 20 m crop and the 0.35 m
    voxel filter into 16384 slots, moved by `pose` (a 4x4) if given."""
    import torch

    from msst_torch.ops.pointcloud import Cloud, crop_box
    from msst_torch.ops.voxel import voxel_downsample

    cl = crop_box(Cloud.create(torch.from_numpy(xyz).to(dev)),
                  (-20.0,) * 3, (20.0,) * 3)
    cl = voxel_downsample(cl, 0.35, capacity=16384)
    pts = cl.xyz
    if pose is not None:
        T = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        pts = pts @ T[:3, :3].T + T[:3, 3]
    return pts.contiguous(), cl.mask.contiguous()


def phase_knn_calib_shapes(scene, usage, dev_name="cuda"):
    """Phase 3b, kernel B2 at the calibration path's shapes: each (k, C,
    max_sqdist) of KNN_CALIB_SHAPES bit-equal to the twin on a 16384-slot
    cloud of phase 11's scene, and k = 48 (KCap = 64) on the lattice whose
    candidates tie at the 48th slot; each shape timed beside its twin, on
    the device alone, and against its bound."""
    import torch

    from msst_torch.ops import knn
    from msst_torch.utils.kernel_work import knn_query_work

    dev = torch.device(dev_name)
    m, s, T_ms = scene
    tq, tm = _prepped(m, dev)
    sq, sm = _prepped(s, dev, T_ms)
    shapes, err = [], 0.0
    for label, k, cand, max_sq, cell, table, queries in KNN_CALIB_SHAPES:
        grid = knn.build(tq, tm, cell, table)
        q, qm = (sq, sm) if queries == "source" else (tq, tm)
        res, e = _knn_equal(label, grid, None, q, qm, None, k, cand, max_sq)
        err = max(err, e)

        def call(grid=grid, q=q, qm=qm, k=k, cand=cand, max_sq=max_sq):
            knn.query(grid, q, qm, k=k, candidates_per_cell=cand,
                      max_sqdist=max_sq)

        def plain(grid=grid, q=q, qm=qm, k=k, cand=cand, max_sq=max_sq):
            knn.query_plain(grid, q, qm, k=k, candidates_per_cell=cand,
                            max_sqdist=max_sq)

        runs = {"kernel": [], "plain": []}
        for name, fn in (("kernel", call), ("plain", plain),
                         ("plain", plain), ("kernel", call)):
            runs[name].append(_cuda_ms(fn, n=CALIB_TIMED_CALLS, warm=2))
        work = knn_query_work(grid, grid, q, qm, q.shape[0], cand, res.idx)
        bound_ms, bound_by = _bound(work["bytes"], work["ops"])
        shapes.append({
            "label": label, "k": k, "C": cand,
            "max_sqdist": max_sq if np.isfinite(max_sq) else None,
            "cell": cell, "table": table, "queries": int(q.shape[0]),
            "live_queries": int(qm.sum()), "points": int(tm.sum()),
            "valid_slots": int(res.valid.sum()), "max_abs_err": e,
            "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
            "device_ms": _device_ms(call, "knn_query_kernel"),
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work})
    lgrid, lq, lqm = _lattice_grid(dev)
    ties = {}
    for max_sq in (float("inf"), 0.75 ** 2):
        lres, e = _knn_equal(f"lattice ties, k=48, max_sqdist={max_sq}",
                             lgrid, None, lq, lqm, None, 48, 64, max_sq)
        d = lres.sqdist
        ties[max_sq] = int((torch.isfinite(d[:, 47])
                            & (d[:, 47] == d[:, 46])).sum())
        err = max(err, e)
    if min(ties.values()) == 0:
        raise AssertionError(f"knn_query: no ties at the 48th slot ({ties})")
    kcap64 = [v for fn, v in usage.get("knn_query", {}).items()
              if "<64" in fn]
    print(f"phase 3b (calibration shapes): knn_query == twin, all slots, on "
          f"{int(tm.sum())} target and {int(sm.sum())} source points of "
          f"16384 slots; lattice, k=48, C=64: {ties} rows tie at the 48th "
          f"slot (no cap / 0.75 m cap); max_abs_err {err}; KCap = 64 "
          f"(ptxas: registers, spill stores B, spill loads B): {kcap64}",
          flush=True)
    for r in shapes:
        print(f"        {r['label']}: k={r['k']}, C={r['C']}, max_sqdist="
              f"{r['max_sqdist'] or 'inf'}, cell {r['cell']} m, H={r['table']}, "
              f"{r['live_queries']} of {r['queries']} queries live, "
              f"{r['valid_slots']} valid slots: {r['ms']:.4f} ms a launch, "
              f"plain {r['plain_ms']:.4f} ms (CUDA events, "
              f"{CALIB_TIMED_CALLS} calls); device {_fmt_ms(r['device_ms'])}; "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
              f"({r['work']['bytes']} B, {r['work']['ops']} operations, "
              f"{r['work']['candidates']} candidates)", flush=True)
    return {"shapes": shapes,
            "ties_at_48": {"no cap": ties[float("inf")],
                           "0.75 m cap": ties[0.75 ** 2]},
            "kcap64_ptxas": kcap64, "max_abs_err": err}


def _timed(fn):
    """(result, seconds) of fn() to the end of its device work."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _counted(fn):
    """(result, seconds, B2 launches) of fn() with the counts set to 0
    just before it."""
    from msst_torch.ops import knn

    knn.query.launches = 0
    out, sec = _timed(fn)
    return out, sec, knn.query.launches


def _check_calib(tag, T, T_gt, launches):
    deg, metres = _pose_err(T, T_gt)
    if not np.isfinite(T).all() or deg > CALIB_GATE_DEG or metres > CALIB_GATE_M:
        raise AssertionError(f"{tag}: {deg:.4f} deg / {metres:.4f} m from the "
                             f"true mount, gates {CALIB_GATE_DEG} deg / "
                             f"{CALIB_GATE_M} m")
    if launches == 0:
        raise AssertionError(f"{tag}: no B2 launch")
    return deg, metres


def phase_calibration(scene, card, dev_name="cuda"):
    """Phase 11, the calibration path at its defaults' sizes (11a-11d);
    each run's B2 launches counted from 0."""
    import torch

    from msst_torch.models.calibration import auto_calib, multi_lica
    from msst_torch.models.calibration import ndt_calib
    from msst_torch.ops import se3

    dev = torch.device(dev_name)
    m, s, T_ms = scene
    t_phase = time.perf_counter()
    out = {}

    def tensors(xyz, d):
        return (torch.from_numpy(xyz).to(d),
                torch.ones(len(xyz), dtype=torch.bool, device=d))

    mx, mm = tensors(m, dev)
    sx, sm = tensors(s, dev)
    cfg = multi_lica.MultiLicaConfig()
    res, sec, n = _counted(lambda: multi_lica.calibrate_pair(sx, sm, mx, mm,
                                                             cfg))
    T = _matrix(res.pose)
    deg, metres = _check_calib("11a", T, T_ms, n)
    t0 = time.perf_counter()
    cpu = multi_lica.calibrate_pair(*tensors(s, "cpu"), *tensors(m, "cpu"),
                                    cfg)
    t_cpu = time.perf_counter() - t0
    gap = _pose_err(T, _matrix(cpu.pose))
    out["11a"] = {"deg": deg, "m": metres, "s": sec, "launches": n,
                  "fitness": float(res.fitness), "rmse": float(res.rmse),
                  "coarse_inliers": int(res.coarse_inliers),
                  "cpu_gap_deg": gap[0], "cpu_gap_m": gap[1],
                  "cpu_deg_m": _pose_err(_matrix(cpu.pose), T_ms),
                  "cpu_s": t_cpu}
    print(f"phase 11a: multi_lica.calibrate_pair(MultiLicaConfig()) of two "
          f"64x1024 sweeps on {dev}: {deg:.4f} deg / {metres:.4f} m from the "
          f"true mount (gates {CALIB_GATE_DEG} deg / {CALIB_GATE_M} m); "
          f"fitness {float(res.fitness):.4f}, rmse {float(res.rmse):.4f}, "
          f"{int(res.coarse_inliers)} coarse inliers; {n} B2 launches; "
          f"{sec:.2f} s; the port on the CPU {gap[0]:.5f} deg / {gap[1]:.5f} m "
          f"from it, in {t_cpu:.1f} s [{card}]", flush=True)

    guess_t = torch.tensor(T_ms[:3, 3] + np.array(CALIB_GUESS_T_M),
                           dtype=torch.float32, device=dev)
    init = se3.Pose.from_rpy_xyz(torch.zeros(3, device=dev), guess_t)
    gen = torch.Generator(device=dev).manual_seed(0)
    res, sec, n = _counted(lambda: auto_calib.auto_calibrate(
        mx, mm, sx, sm, auto_calib.AutoCalibConfig(), gen, init_pose=init))
    deg, metres = _check_calib("11b", _matrix(res.pose), T_ms, n)
    out["11b"] = {"deg": deg, "m": metres, "s": sec, "launches": n,
                  "yaw_cost": float(res.yaw_cost),
                  "icp_rmse": float(res.icp_rmse)}
    print(f"phase 11b: auto_calibrate from the lever arm + "
          f"{CALIB_GUESS_T_M} m: {deg:.4f} deg / {metres:.4f} m; ground "
          f"{bool(res.ground_ok)}, ICP rmse {float(res.icp_rmse):.4f}; {n} B2 "
          f"launches (136 yaws); {sec:.2f} s", flush=True)

    rpy = np.radians(CALIB_SIDE_RPY_DEG) + np.radians(CALIB_GUESS_RPY_DEG)
    guess = se3.Pose.from_rpy_xyz(torch.tensor(rpy, dtype=torch.float32,
                                               device=dev), guess_t)
    cal = ndt_calib.NdtCalibrator(ndt_calib.NdtCalibConfig(),
                                  initial_guess=guess, device=dev)
    frames = []
    for _ in range(NDT_FRAMES):
        r, sec, n = _counted(lambda: cal.process_pair(m[::4], s[::4]))
        frames.append({"s": sec, "launches": n, "iters": int(r.iters),
                       "score": float(r.score)})
    deg, metres = _check_calib("11c", _matrix(cal.pose), T_ms,
                               sum(f["launches"] for f in frames))
    out["11c"] = {"deg": deg, "m": metres, "frames": frames}
    print(f"phase 11c: NdtCalibrator(NdtCalibConfig()) over {NDT_FRAMES} "
          f"frames of every 4th point, from the mount off by "
          f"{CALIB_GUESS_RPY_DEG} deg and {CALIB_GUESS_T_M} m: {deg:.4f} deg "
          f"/ {metres:.4f} m; per frame (s, B2 launches, NDT iterations): "
          + ", ".join(f"({f['s']:.3f}, {f['launches']}, {f['iters']})"
                      for f in frames), flush=True)
    out["11d"] = _allan_check(dev, card)
    out["s"] = time.perf_counter() - t_phase
    return out


def _rel(a, b):
    """|a - b| / |b|; 0 where both are 0."""
    return abs(a - b) / abs(b) if b else (0.0 if a == b else float("inf"))


def _allan_check(dev, card):
    """11d: AllanCalibrator over a 2 h x 200 Hz synthetic log on `dev` and
    on the CPU (the twin).  Gated: on the gyro axes (means near 0) each
    cluster's Allan variance and the bias instability within ALLAN_AGREE of
    the CPU's.  Printed: the acc axes (a bias, and gravity on z: the
    float32 cumulative sum of an axis with a mean loses the small clusters'
    precision, in msst_tpu alike) and every axis' fitted white noise (the
    float32 SVD fit of msst_tpu's fit_allan; ROADMAP, section 3)."""
    import torch

    from msst_torch.models.calibration import imu_allan

    rng = np.random.default_rng(23)
    n = ALLAN_SAMPLES
    gyro = (ALLAN_GYR_N / np.sqrt(ALLAN_DT) * rng.normal(size=(n, 3))
            + 1e-3 + np.cumsum(rng.normal(scale=2e-7, size=(n, 3)), axis=0))
    acc = (ALLAN_ACC_N / np.sqrt(ALLAN_DT) * rng.normal(size=(n, 3))
           + np.array([0.05, -0.03, 9.80665])
           + np.cumsum(rng.normal(scale=2e-6, size=(n, 3)), axis=0))
    t = np.arange(n) * ALLAN_DT
    cals = {d: imu_allan.AllanCalibrator(max_samples=n, device=d)
            for d in (str(dev), "cpu")}
    for i in range(n):
        for c in cals.values():
            c.add_sample(t[i], gyro[i], acc[i])
    res, secs = {}, {}
    for d, c in cals.items():
        t0 = time.perf_counter()
        res[d] = c.compute()
        secs[d] = time.perf_counter() - t0
    card_r, cpu_r = res[str(dev)], res["cpu"]
    rows, worst = [], 0.0
    for kind in ("gyr", "acc"):
        for ax in range(3):
            a, b = card_r[f"{kind}_axes"][ax], cpu_r[f"{kind}_axes"][ax]
            rel = {"avar": max(_rel(x, y) for x, y in zip(a["avar"],
                                                         b["avar"])),
                   "bias_instability": _rel(a["bias_instability"],
                                            b["bias_instability"]),
                   "white_noise": _rel(a["white_noise"], b["white_noise"])}
            gated = kind == "gyr"
            if gated:
                worst = max(worst, rel["avar"], rel["bias_instability"])
            rows.append({"axis": f"{kind} {'xyz'[ax]}", "gated": gated,
                         "white_noise": [a["white_noise"], b["white_noise"]],
                         "bias_instability": [a["bias_instability"],
                                              b["bias_instability"]],
                         "rel": rel})
    print(f"phase 11d: AllanCalibrator, {n} samples (2 h at 200 Hz), on "
          f"{dev} in {secs[str(dev)]:.2f} s, on the CPU in {secs['cpu']:.2f} "
          f"s; white noise known {ALLAN_GYR_N} (gyr), {ALLAN_ACC_N} (acc), "
          f"fitted card {card_r['gyr_n']:.6g} / {card_r['acc_n']:.6g}, CPU "
          f"{cpu_r['gyr_n']:.6g} / {cpu_r['acc_n']:.6g}; card against CPU, "
          "largest relative gap (avar over 100 clusters, bias instability, "
          "white noise): "
          + "; ".join(f"{r['axis']} ({r['rel']['avar']:.2e}, "
                      f"{r['rel']['bias_instability']:.2e}, "
                      f"{r['rel']['white_noise']:.2e})"
                      + ("" if r["gated"] else " not gated")
                      for r in rows) + f" [{card}]", flush=True)
    if worst > ALLAN_AGREE:
        raise AssertionError(f"11d: card and CPU differ by {worst:.3e} > "
                             f"{ALLAN_AGREE} on a gyro axis")
    return {"rows": rows, "s": secs, "worst_gated": worst,
            "gyr_n": [card_r["gyr_n"], cpu_r["gyr_n"]],
            "acc_n": [card_r["acc_n"], cpu_r["acc_n"]]}


def phase_calib_cli(scene, card, dev_name="cuda"):
    """Phase 11e: ``python -m msst_torch.cli calibrate TGT.pcd SRC.pcd
    --method M`` for lica, auto and ndt, three processes started together,
    on PCDs of phase 11's sweeps; each JSON matrix equal to the library's
    call made the CLI's way (MultiLidarCalibrator.standard_calibration,
    auto_calibrate of clouds padded to 32768 with a generator seeded 0,
    NdtCalibrator from identity) in this process."""
    import tempfile

    import torch

    from msst_torch import cli
    from msst_torch.models.calibration import auto_calib, multi_lica
    from msst_torch.models.calibration import device as device_mod
    from msst_torch.models.calibration import ndt_calib
    from msst_torch.utils.io_pcd import write_pcd

    dev = torch.device(dev_name)
    m, s, _ = scene
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tgt, src = os.path.join(d, "master.pcd"), os.path.join(d, "side.pcd")
        write_pcd(tgt, m)
        write_pcd(src, s)
        procs = {}
        for method in ("lica", "auto", "ndt"):
            outp = os.path.join(d, f"{method}.json")
            procs[method] = (outp, subprocess.Popen(
                [sys.executable, "-m", "msst_torch.cli", "calibrate", tgt, src,
                 "--method", method, "--output", outp, "--device", dev_name],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        try:
            want = {}
            r = multi_lica.MultiLidarCalibrator(
                multi_lica.MultiLicaConfig(), device=dev
            ).standard_calibration(m, [s])[0]
            want["lica"] = _matrix(r.pose)
            m_x, m_m = device_mod.pad(m, cli.AUTO_CAPACITY, dev)
            s_x, s_m = device_mod.pad(s, cli.AUTO_CAPACITY, dev)
            want["auto"] = _matrix(auto_calib.auto_calibrate(
                m_x, m_m, s_x, s_m, auto_calib.AutoCalibConfig(),
                torch.Generator(device=dev).manual_seed(0)).pose)
            cal = ndt_calib.NdtCalibrator(device=dev)
            cal.process_pair(m, s)
            want["ndt"] = _matrix(cal.pose)
            got = {}
            for method, (outp, proc) in procs.items():
                log, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"11e: msst_torch.cli calibrate "
                                         f"--method {method} exited "
                                         f"{proc.returncode}:\n{log[-3000:]}")
                with open(outp) as f:
                    got[method] = np.asarray(json.load(f)["source_0"]["matrix"],
                                             np.float32)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    diffs = {k: float(np.abs(got[k] - want[k]).max()) for k in got}
    wall = time.perf_counter() - t0
    print(f"phase 11e: python -m msst_torch.cli calibrate, lica / auto / ndt "
          f"in three processes on {dev}: JSON matrices against the library's "
          f"max |diff| {diffs}; {wall:.1f} s [{card}]", flush=True)
    if any(diffs.values()):
        raise AssertionError(f"11e: the CLI's matrices differ: {diffs}")
    return {"diffs": diffs, "s": wall}


# phase 12's scenes.  12a: 50 frames at 10 Hz of tests/test_heading_target_
# fusion.py's corridor (a floor and two walls 4 m apart seen from 1.2 m up,
# 1 cm noise) at one VLP-16 sweep's count of points (16 x 1800), rows
# shuffled as a sweep interleaves its returns, the sensor at roll 3 deg and
# pitch -2 deg, its yaw in the corridor ramping from 0 to 20 deg.  The
# estimator reports the corridor's direction in the levelled sensor frame,
# so its yaw is minus the sensor's (modulo 180 deg: a corridor has no front
# on the first frame), and at yaw psi the wall distances at the +-2 m
# sample points are 2 -+ 2 sin(psi) (LF, RB) and 2 +- 2 sin(psi) (LB, RF).
# Gates: test_heading_target_fusion.py's, from the second frame on (the
# smoothing lags the ramp by ~1 deg).  12b: a 0.1 m post (40 points,
# intensity 200) moving at 2 m/s, 800 background points at intensity 20,
# 40 high-intensity clutter points over 20 m, in 1024 slots.
HEADING_FRAMES = 50
HEADING_POINTS = 16 * 1800
HEADING_RP_DEG = (3.0, -2.0)
HEADING_YAW_END_DEG = 20.0
HEADING_HALF_WIDTH_M = 2.0
HEADING_SAMPLE_M = 2.0
HEADING_SEED = 12
HEADING_CPU_FRAMES = 5
HEADING_GATE_DEG = 1.0
HEADING_YAW_GATE_DEG = 2.0
HEADING_DIST_GATE_M = 0.2
TRACK_FRAMES = 50
TRACK_SLOTS = 1024
TRACK_START_M = (4.0, 2.0)
TRACK_SPEED = 2.0
TRACK_POST = (40, 0.1)               # points, radius (m)
TRACK_BG, TRACK_CLUTTER = 800, 40
TRACK_SEED = 13
TRACK_CENTER_GATE_M = 0.05
TRACK_END_GATE_M = 0.2
FUSION_CALLS = 20
FUSION_AGREE_M = 1e-4
CLI_FRAMES = 5


def _corridor_cloud(rng, roll, pitch, yaw, n):
    """tests/test_heading_target_fusion.py's corridor (angles in degrees),
    its rows shuffled."""
    from scipy.spatial.transform import Rotation

    w = HEADING_HALF_WIDTH_M
    xs = rng.uniform(-8, 8, n)
    k = n // 4
    world = np.concatenate([
        np.column_stack([xs[:n // 2], rng.uniform(-w, w, n // 2),
                         np.zeros(n // 2)]),
        np.column_stack([xs[n // 2:n // 2 + k], np.full(k, w),
                         rng.uniform(0, 3, k)]),
        np.column_stack([xs[n // 2 + k:n // 2 + 2 * k], np.full(k, -w),
                         rng.uniform(0, 3, k)])])
    world += rng.normal(scale=0.01, size=world.shape)
    R = Rotation.from_euler("xyz", np.radians([roll, pitch, yaw])).as_matrix()
    pts = ((world - np.array([0.0, 0.0, 1.2])) @ R).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def _heading_frames():
    """(points, sensor yaw in degrees) of each 12a frame."""
    rng = np.random.default_rng(HEADING_SEED)
    return [(_corridor_cloud(rng, *HEADING_RP_DEG, yaw, HEADING_POINTS), yaw)
            for yaw in np.linspace(0.0, HEADING_YAW_END_DEG, HEADING_FRAMES)]


def _track_frames():
    """(xyz, intensity, mask, true centre) of each 12b frame."""
    rng = np.random.default_rng(TRACK_SEED)
    n_post, r_post = TRACK_POST
    frames = []
    for i in range(TRACK_FRAMES):
        c = np.array(TRACK_START_M) + [TRACK_SPEED * SCAN_DT * i, 0.0]
        th = rng.uniform(0, 2 * np.pi, n_post)
        xy = np.concatenate([
            c + r_post * np.column_stack([np.cos(th), np.sin(th)]),
            rng.uniform(-20, 20, (TRACK_BG, 2)),
            rng.uniform(-10, 10, (TRACK_CLUTTER, 2))])
        z = np.concatenate([np.zeros(n_post + TRACK_BG),
                            rng.uniform(0.0, 1.5, TRACK_CLUTTER)])
        inten = np.concatenate([np.full(n_post, 200.0), np.full(TRACK_BG, 20.0),
                                np.full(TRACK_CLUTTER, 200.0)])
        perm = rng.permutation(len(xy))
        n = len(xy)
        xyz = np.zeros((TRACK_SLOTS, 3), np.float32)
        xyz[:n] = np.column_stack([xy, z])[perm]
        iv = np.zeros(TRACK_SLOTS, np.float32)
        iv[:n] = inten[perm]
        frames.append((xyz, iv, np.arange(TRACK_SLOTS) < n, c))
    return frames


def phase_knn_tracker_shape(frame, dev_name="cuda"):
    """Phase 3b, kernel B2 at the tracker's shape: (k, C, max_sqdist) =
    (8, 16, 0.2^2) on a 2048-bucket table of 0.2 m cells, over 12b's first
    frame (1024 slots, its candidate points as target_tracker.track_step
    picks them), bit-equal to the twin on every slot, timed as the
    calibration shapes are."""
    import torch

    from msst_torch.models import target_tracker as tt
    from msst_torch.ops import knn
    from msst_torch.utils.kernel_work import knn_query_work

    dev = torch.device(dev_name)
    cfg = tt.TargetConfig()
    xyz, inten, mask, _ = frame
    keep, _ = tt.candidate_mask(
        tt.TrackerState.create(dev), torch.from_numpy(xyz).to(dev),
        torch.from_numpy(inten).to(dev), torch.from_numpy(mask).to(dev),
        torch.tensor(0.1, device=dev), cfg)
    q = torch.cat([torch.from_numpy(xyz[:, :2]).to(dev),
                   torch.zeros((len(xyz), 1), device=dev)], 1).contiguous()
    tol = cfg.cluster_tolerance
    grid = knn.build(q, keep, cell_size=tol, table_size=2048)
    res, err = _knn_equal("the tracker's shape", grid, None, q, keep, None,
                          8, 16, tol * tol)

    def call():
        knn.query(grid, q, keep, k=8, candidates_per_cell=16,
                  max_sqdist=tol * tol)

    def plain():
        knn.query_plain(grid, q, keep, k=8, candidates_per_cell=16,
                        max_sqdist=tol * tol)

    runs = {"kernel": [], "plain": []}
    for name, fn in (("kernel", call), ("plain", plain), ("plain", plain),
                     ("kernel", call)):
        runs[name].append(_cuda_ms(fn, n=CALIB_TIMED_CALLS, warm=2))
    work = knn_query_work(grid, grid, q, keep, q.shape[0], 16, res.idx)
    bound_ms, bound_by = _bound(work["bytes"], work["ops"])
    row = {"label": "tracker clustering", "k": 8, "C": 16,
           "max_sqdist": tol * tol, "cell": tol, "table": 2048,
           "queries": int(q.shape[0]), "live_queries": int(keep.sum()),
           "points": int(keep.sum()), "valid_slots": int(res.valid.sum()),
           "max_abs_err": err, "ms": min(runs["kernel"]),
           "plain_ms": min(runs["plain"]),
           "device_ms": _device_ms(call, "knn_query_kernel"),
           "bound_ms": bound_ms, "bound_by": bound_by, "work": work}
    print(f"phase 3b (tracker shape): knn_query == twin, all slots: k=8, "
          f"C=16, max_sqdist={tol * tol:.4f}, cell {tol} m, H=2048, "
          f"{row['live_queries']} of {row['queries']} queries live, "
          f"{row['valid_slots']} valid slots; max_abs_err {err}; "
          f"{row['ms']:.4f} ms a launch, plain {row['plain_ms']:.4f} ms (CUDA "
          f"events, {CALIB_TIMED_CALLS} calls); device "
          f"{_fmt_ms(row['device_ms'])}; bound {bound_ms:.6f} ms by {bound_by} "
          f"({work['bytes']} B, {work['ops']} operations, "
          f"{work['candidates']} candidates)", flush=True)
    return row


def _wrap(deg, period):
    """deg into [-period / 2, period / 2)."""
    return (deg + period / 2) % period - period / 2


def _heading_rows(frames, dev, n=None):
    """heading_step with HeadingConfig() over the frames (the first n) on
    `dev`, the CLI's generator seeds and times; each frame's (roll, pitch,
    yaw, LF, LB, RF, RB, confidence) read back as a 10 Hz node publishes
    it.  Returns (rows, seconds a frame, B2 launches)."""
    import torch

    from msst_torch.models import heading as hd
    from msst_torch.ops import knn

    cfg = hd.HeadingConfig()
    st = hd.HeadingState.create(dev)
    rows, secs = [], []
    knn.query.launches = 0
    for i, (pts, _) in enumerate(frames[:n]):
        t0 = time.perf_counter()
        st, r = hd.heading_step(
            st, torch.from_numpy(pts).to(dev),
            torch.ones(len(pts), dtype=torch.bool, device=dev), 0.1 * (i + 1),
            torch.Generator(device=dev).manual_seed(i), cfg)
        rows.append(torch.cat([torch.stack([r.roll, r.pitch, r.yaw]),
                               r.distances, r.confidence[None].float()]
                              ).cpu().numpy())
        secs.append(time.perf_counter() - t0)
    return np.array(rows, np.float64), secs, knn.query.launches


def _heading_errors(tag, rows, frames):
    """The worst |error| of roll, pitch, yaw (mod 180) and the distances
    over the frames from the second on; raises past a gate or at a
    confidence below 2."""
    worst = {"roll": 0.0, "pitch": 0.0, "yaw": 0.0, "dist": 0.0}
    for i in range(1, len(rows)):
        yaw = frames[i][1]
        sin2 = HEADING_SAMPLE_M * np.sin(np.radians(yaw))
        w = HEADING_HALF_WIDTH_M
        d_true = np.array([w - sin2, w + sin2, w + sin2, w - sin2])
        e = {"roll": abs(rows[i, 0] - HEADING_RP_DEG[0]),
             "pitch": abs(rows[i, 1] - HEADING_RP_DEG[1]),
             "yaw": abs(_wrap(rows[i, 2] + yaw, 180.0)),
             "dist": float(np.abs(rows[i, 3:7] - d_true).max())}
        worst = {k: max(worst[k], float(v)) for k, v in e.items()}
        if (e["roll"] > HEADING_GATE_DEG or e["pitch"] > HEADING_GATE_DEG
                or e["yaw"] > HEADING_YAW_GATE_DEG
                or e["dist"] > HEADING_DIST_GATE_M or rows[i, 7] != 2):
            raise AssertionError(f"{tag}: frame {i} (sensor yaw {yaw:.2f} "
                                 f"deg) off: {e}, confidence {rows[i, 7]}")
    return worst


def _track_rows(frames, dev):
    """track_step with TargetConfig() over the frames on `dev`; each
    frame's (x, y, valid, points, track x, track y) read back.  Returns
    (rows, seconds a frame, B2 launches)."""
    import torch

    from msst_torch.models import target_tracker as tt
    from msst_torch.ops import knn

    cfg = tt.TargetConfig()
    st = tt.TrackerState.create(dev)
    rows, secs = [], []
    knn.query.launches = 0
    for i, (xyz, inten, mask, _) in enumerate(frames):
        t0 = time.perf_counter()
        st, o = tt.track_step(
            st, torch.from_numpy(xyz).to(dev), torch.from_numpy(inten).to(dev),
            torch.from_numpy(mask).to(dev), 0.1 * (i + 1),
            torch.Generator(device=dev).manual_seed(i), cfg)
        rows.append(torch.stack([o.x, o.y, o.is_valid.float(),
                                 o.point_count.float(), o.track_x,
                                 o.track_y]).cpu().numpy())
        secs.append(time.perf_counter() - t0)
    return np.array(rows, np.float64), secs, knn.query.launches


def _fusion_reference(clouds, extrinsics, per):
    """fusion_pointclouds in float64 numpy: each LiDAR's first `per` points
    moved by its (x, y, z, roll, pitch, yaw), concatenated in LiDAR order,
    the points inside the default ego box (FusionConfig.ego_lo/hi) cut."""
    from scipy.spatial.transform import Rotation

    moved = []
    for xyz, e in zip(clouds, extrinsics):
        R = Rotation.from_euler("xyz", e[3:6]).as_matrix()
        moved.append(np.asarray(xyz[:per], np.float64) @ R.T + np.asarray(e[:3]))
    pts = np.concatenate(moved)
    inside = np.all((pts >= -1.0) & (pts <= 1.0), axis=1)
    return pts[~inside]


def phase_estimators(scene, track_frames, card, dev_name="cuda"):
    """Phase 12: the estimators beside LIO-SAM on the card.  12a
    heading_step over 50 corridor frames (and the port on the CPU over the
    first 5), 12b track_step over 50 frames, 12c PointCloudFusion over
    phase 11's two sweeps against a float64 reference, 12d the heading and
    track commands against the library."""
    import torch
    from scipy.spatial.transform import Rotation

    from msst_torch.models import fusion as fu
    from msst_torch.ops.pointcloud import Cloud

    dev = torch.device(dev_name)
    out = {}
    t_phase = time.perf_counter()

    frames = _heading_frames()
    rows, secs, launches = _heading_rows(frames, dev)
    worst = _heading_errors("12a", rows, frames)
    if launches != len(frames):
        raise AssertionError(f"12a: {launches} B2 launches over "
                             f"{len(frames)} frames, not one a frame")
    t0 = time.perf_counter()
    cpu_rows, _, _ = _heading_rows(frames, torch.device("cpu"),
                                   HEADING_CPU_FRAMES)
    cpu_s = time.perf_counter() - t0
    cpu_worst = _heading_errors("12a (CPU)", cpu_rows, frames)
    a, b = rows[:HEADING_CPU_FRAMES], cpu_rows
    gap = {"roll_pitch_deg": float(np.abs(a[:, :2] - b[:, :2]).max()),
           "yaw_deg": float(np.abs(_wrap(a[:, 2] - b[:, 2], 360.0)).max()),
           "dist_m": float(np.abs(a[:, 3:7] - b[:, 3:7]).max())}
    steady = secs[1:]
    out["12a"] = {"launches": launches, "ms": [1000 * x for x in secs],
                  "ms_median": 1000 * float(np.median(steady)),
                  "worst": worst, "cpu_worst": cpu_worst, "cpu_gap": gap,
                  "cpu_s": cpu_s}
    print(f"phase 12a: heading_step(HeadingConfig(), max_points 16384) on "
          f"{dev} over {len(frames)} corridor frames of {HEADING_POINTS} "
          f"points (roll {HEADING_RP_DEG[0]}, pitch {HEADING_RP_DEG[1]}, yaw "
          f"0 -> {HEADING_YAW_END_DEG} deg): worst roll {worst['roll']:.4f}, "
          f"pitch {worst['pitch']:.4f}, yaw (mod 180) {worst['yaw']:.4f} deg, "
          f"distances {worst['dist']:.4f} m (gates {HEADING_GATE_DEG} / "
          f"{HEADING_YAW_GATE_DEG} deg, {HEADING_DIST_GATE_M} m), confidence 2 "
          f"from frame 1; {launches} B2 launches; {out['12a']['ms_median']:.2f} "
          f"ms a frame (median of frames 1-{len(frames) - 1}, upload to "
          f"read-back), first frame {1000 * secs[0]:.1f} ms; the port on the "
          f"CPU over {HEADING_CPU_FRAMES} frames (its own draws) worst "
          f"{cpu_worst}, {gap} from the card's, {cpu_s:.1f} s [{card}]",
          flush=True)

    rows, secs, launches = _track_rows(track_frames, dev)
    truth = np.array([f[3] for f in track_frames])
    err = np.linalg.norm(rows[:, :2] - truth, axis=1)
    end = float(np.linalg.norm(rows[-1, 4:6] - truth[-1]))
    if not rows[:, 2].all():
        raise AssertionError(f"12b: no detection in frames "
                             f"{np.flatnonzero(rows[:, 2] == 0).tolist()}")
    if err.max() > TRACK_CENTER_GATE_M or end > TRACK_END_GATE_M:
        raise AssertionError(f"12b: centre off by up to {err.max():.4f} m "
                             f"(gate {TRACK_CENTER_GATE_M}), the track by "
                             f"{end:.4f} m at the end (gate {TRACK_END_GATE_M})")
    if launches != len(track_frames):
        raise AssertionError(f"12b: {launches} B2 launches over "
                             f"{len(track_frames)} frames, not one a frame")
    out["12b"] = {"launches": launches, "ms": [1000 * x for x in secs],
                  "ms_median": 1000 * float(np.median(secs[1:])),
                  "worst_center_m": float(err.max()), "end_track_m": end,
                  "points": rows[:, 3].tolist()}
    print(f"phase 12b: track_step(TargetConfig()) on {dev} over "
          f"{len(track_frames)} frames of {TRACK_SLOTS} slots (a "
          f"{TRACK_POST[1]} m post at {TRACK_SPEED} m/s, {TRACK_BG} background "
          f"and {TRACK_CLUTTER} clutter points): detected in every frame, "
          f"centre within {err.max():.4f} m (gate {TRACK_CENTER_GATE_M}), "
          f"track {end:.4f} m from the post at the end (gate "
          f"{TRACK_END_GATE_M}); {launches} B2 launches; "
          f"{out['12b']['ms_median']:.2f} ms a frame (median), first "
          f"{1000 * secs[0]:.1f} ms [{card}]", flush=True)

    m, s, T_ms = scene
    ext = ((0.0,) * 6, (*(float(x) for x in T_ms[:3, 3]),
                        *(float(x) for x in Rotation.from_matrix(
                            T_ms[:3, :3]).as_euler("xyz"))))
    cfg = fu.FusionConfig(n_lidars=2, capacity=131072, extrinsics=ext)
    fuser = fu.PointCloudFusion(cfg, device=dev)
    fused = fuser.fuse_arrays([m, s])
    ref = _fusion_reference([m, s], ext, cfg.capacity // cfg.n_lidars)
    n = int(fused.mask.sum())
    if n != len(ref) or not bool(fused.mask[:n].all()):
        raise AssertionError(f"12c: {n} fused points, the reference "
                             f"{len(ref)}")
    diff = float(np.abs(fused.xyz[:n].cpu().numpy() - ref).max())
    if diff > FUSION_AGREE_M:
        raise AssertionError(f"12c: fused points {diff:.2e} m from the "
                             f"float64 reference (limit {FUSION_AGREE_M})")
    host = []
    for _ in range(FUSION_CALLS):
        _, sec = _timed(lambda: fuser.fuse_arrays([m, s]))
        host.append(sec)
    per = cfg.capacity // cfg.n_lidars
    clouds = [Cloud.create(torch.from_numpy(np.pad(
        x[:per], ((0, per - len(x[:per])), (0, 0)))).to(dev),
        mask=torch.from_numpy(np.arange(per) < len(x)).to(dev))
        for x in (m, s)]
    fuse_ms = _cuda_ms(lambda: fuser.fuse(clouds), n=FUSION_CALLS)
    out["12c"] = {"points": n, "max_abs_err": diff,
                  "ms_fuse_arrays": 1000 * float(np.median(host)),
                  "ms_fuse": fuse_ms}
    print(f"phase 12c: PointCloudFusion(n_lidars=2, capacity=131072) of "
          f"phase 11's sweeps ({len(m)} + {len(s)} points) with their true "
          f"mounts and the default ego box on {dev}: {n} points (the ego box "
          f"cut {len(m) + len(s) - n}), equal in "
          f"count and order to the float64 reference, max |diff| {diff:.2e} m; "
          f"fuse_arrays (host padding, one upload a LiDAR, fuse) "
          f"{out['12c']['ms_fuse_arrays']:.3f} ms (median of {FUSION_CALLS}), "
          f"fuse of the uploaded clouds {fuse_ms:.3f} ms (CUDA events) "
          f"[{card}]", flush=True)
    out["12d"] = _estimator_cli(frames, track_frames, card, dev_name)
    out["s"] = time.perf_counter() - t_phase
    return out


def _estimator_cli(frames, track_frames, card, dev_name="cuda"):
    """Phase 12d: ``python -m msst_torch.cli heading`` on PCDs of 12a's
    first CLI_FRAMES frames and ``... track`` on 12b's, two processes
    started together; each JSON line equal to the library's, run the
    command's way in this process (the PCD read back, padded to the
    config's max_points, frame i at 0.1 * (i + 1) s with a generator
    seeded i)."""
    import tempfile

    import torch

    from msst_torch.models import heading as hd
    from msst_torch.models import target_tracker as tt
    from msst_torch.models.calibration import device as device_mod
    from msst_torch.utils.io_pcd import read_pcd, write_pcd

    dev = torch.device(dev_name)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        hpaths, tpaths = [], []
        for i in range(CLI_FRAMES):
            hpaths.append(os.path.join(d, f"heading_{i}.pcd"))
            write_pcd(hpaths[-1], frames[i][0])
            xyz, inten, mask, _ = track_frames[i]
            tpaths.append(os.path.join(d, f"track_{i}.pcd"))
            write_pcd(tpaths[-1], xyz[mask], inten[mask])
        procs = {cmd: subprocess.Popen(
            [sys.executable, "-m", "msst_torch.cli", cmd, *paths, "--device",
             dev_name], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for cmd, paths in (("heading", hpaths), ("track", tpaths))}
        try:
            want = {"heading": [], "track": []}
            cfg = hd.HeadingConfig()
            st = hd.HeadingState.create(dev)
            for i, path in enumerate(hpaths):
                pts, m = device_mod.pad(read_pcd(path)["xyz"], cfg.max_points,
                                        dev)
                st, r = hd.heading_step(
                    st, pts, m, 0.1 * (i + 1),
                    torch.Generator(device=dev).manual_seed(i), cfg)
                want["heading"].append({
                    "frame": i, "roll_deg": round(float(r.roll), 3),
                    "pitch_deg": round(float(r.pitch), 3),
                    "yaw_deg": round(float(r.yaw), 3),
                    "distances_LF_LB_RF_RB": [round(float(x), 3)
                                              for x in r.distances],
                    "confidence": int(r.confidence)})
            cfg = tt.TargetConfig()
            st = tt.TrackerState.create(dev)
            for i, path in enumerate(tpaths):
                pcd = read_pcd(path)
                pts, m = device_mod.pad(pcd["xyz"], cfg.max_points, dev)
                iv = np.zeros(cfg.max_points, np.float32)
                iv[:len(pcd["xyz"])] = pcd["fields"]["intensity"]
                st, o = tt.track_step(
                    st, pts, torch.from_numpy(iv).to(dev), m, 0.1 * (i + 1),
                    torch.Generator(device=dev).manual_seed(i), cfg)
                want["track"].append({
                    "frame": i, "valid": bool(o.is_valid),
                    "x": round(float(o.x), 4), "y": round(float(o.y), 4),
                    "distance": round(float(o.distance), 4),
                    "points": int(o.point_count),
                    "track": [round(float(o.track_x), 4),
                              round(float(o.track_y), 4)]})
            got = {}
            for cmd, proc in procs.items():
                text, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"12d: msst_torch.cli {cmd} exited "
                                         f"{proc.returncode}:\n{err[-3000:]}")
                got[cmd] = [json.loads(x) for x in text.splitlines()
                            if x.startswith("{")]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    wall = time.perf_counter() - t0
    same = {cmd: got[cmd] == want[cmd] for cmd in got}
    print(f"phase 12d: python -m msst_torch.cli heading / track on "
          f"{CLI_FRAMES} PCDs each, two processes on {dev}: JSON lines equal "
          f"to the library's: {same}; last heading line {got['heading'][-1]}; "
          f"last track line {got['track'][-1]}; {wall:.1f} s [{card}]",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"12d: the commands' lines differ: got {got}, "
                             f"want {want}")
    return {"same": same, "s": wall, "heading": got["heading"],
            "track": got["track"]}


# phase 13's inputs.  13a: a synthetic KITTI raw drive at lio-kitti's own
# HDL-64 profile: sim.World(), the bench drive's circle (r = 10 m, 2 m/s),
# KITTI_SCANS sweeps of 64 rings over HDL-64E's elevation span (the span
# io_kitti assigns 64-ring data to) x 1800 columns, each a static snapshot
# from the pose at its stamp (KITTI's sweeps are motion-compensated; the
# reader gives each point the time of its azimuth in a clockwise sweep), and
# OXTS rows at 100 Hz carrying the simulator's gyro, specific force (with
# sim.make_dataset's noise), attitude, velocity and a GNSS fix.  13b:
# bench-voxel's drive as a rosbag 2.0 of Ouster-layout clouds.  13c:
# tests/data/golden_packets.bin as a classic pcap.
KITTI_RINGS, KITTI_HORIZON = 64, 1800
KITTI_ELEV_DEG = (-24.9, 2.0)
KITTI_SCANS = 128
KITTI_GPS_SCANS = 48
KITTI_SEED = 9
OXTS_HZ = 100
KITTI_LATLON0 = (49.0, 8.4)
KITTI_POS_ACCURACY_M = 0.5
KITTI_BASE = (2011, 9, 26, 12, 0, 0)
EARTH_RADIUS_M = 6378137.0
PCAP_HEADER = 42       # Ethernet, IPv4 and UDP headers before each payload
KITTI_MAX_POINTS = 150000
KITTI_CPU_SCANS = 8
KITTI_VIZ_EVERY = 64
PCAP_REPEAT = 25
FIXED_FRAME_AGREE_M = 1e-4
PCAP_AGREE = 2e-3
# phase 13b's accuracy: the bag's drive starts unstable in both packages
# (the reader's attitude is 0.03 rad ahead, PERF.md section 6), so a single
# drive's drift is one draw from a spread that rounding-level changes of the
# input span.  The card's median over the feeds perturbed by these seeds is
# held to msst_tpu's largest over the same feeds: its drift %/m and ATE m
# per seed, from scripts/torch_vs_ref_drive.py --bag DIR --scans 256
# --horizon 1800 --perturb SEED --packages msst_tpu (CPU runs)
BAG_REFERENCE = {
    0: (4.2238971849731834, 0.21574988616511764),
    1: (4.80086410531671, 0.14863934304939133),
    2: (2.844391023950033, 0.16341256477140131),
    3: (4.995618380678619, 0.1520324417305526),
    4: (4.062596892860856, 0.18360471029947278),
    5: (4.169448741296562, 0.18194099409217646),
    6: (4.424365463960959, 0.2130669125514792),
    7: (3.9080820410651937, 0.1812285231343614),
}


def _bench_trajectory():
    from msst_torch.utils import sim

    return sim.SimTrajectory(kind="circle", radius=10.0, speed=2.0)


def _imu_series(traj, t_end, rate, seed, gravity=9.80511, noise_gyr=1e-3,
                noise_acc=1e-2):
    """IMU samples of `traj` at `rate` over [0, t_end]: times, body rates,
    specific force (sim.make_dataset's finite differences and noise),
    attitude (roll, pitch, yaw) and world-frame velocity and position."""
    from scipy.spatial.transform import Rotation as Rs

    dt = 1.0 / rate
    ts = np.arange(int(round(t_end * rate)) + 1) * dt
    Ts = np.stack([traj.pose(t) for t in ts])
    ps, Rm = Ts[:, :3, 3], Ts[:, :3, :3]
    vs = np.gradient(ps, dt, axis=0)
    accs = np.gradient(vs, dt, axis=0)
    gyro = np.zeros((len(ts), 3))
    for k in range(len(ts) - 1):
        gyro[k] = Rs.from_matrix(Rm[k].T @ Rm[k + 1]).as_rotvec() / dt
    gyro[-1] = gyro[-2]
    f_body = np.einsum("nji,nj->ni", Rm, accs - np.array([0, 0, -gravity]))
    rng = np.random.default_rng(seed)
    gyro = gyro + rng.normal(scale=noise_gyr, size=gyro.shape)
    f_body = f_body + rng.normal(scale=noise_acc, size=f_body.shape)
    return dict(t=ts, gyro=gyro, acc=f_body,
                rpy=Rs.from_matrix(Rm).as_euler("xyz"), vel=vs, pos=ps)


def _kitti_stamp(t):
    """A KITTI timestamps.txt line for t seconds after KITTI_BASE."""
    import datetime

    d = datetime.datetime(*KITTI_BASE) + datetime.timedelta(
        microseconds=int(round(t * 1e6)))
    return f"{d.strftime('%Y-%m-%d %H:%M:%S')}.{d.microsecond:06d}000"


def _write_kitti_drive(root, n_scans=KITTI_SCANS, seed=KITTI_SEED,
                       n_rings=KITTI_RINGS, horizon=KITTI_HORIZON,
                       elev=KITTI_ELEV_DEG, motion=False):
    """Write the synthetic KITTI raw drive under `root`
    (``<root>/2011_09_26/2011_09_26_drive_0001_sync``) and return (its
    directory, the true sensor positions at the sweeps' stamps, points a
    sweep).  motion=True casts each column from the pose at its own firing
    time instead of a static snapshot."""
    from msst_torch.utils import sim
    from msst_torch.utils.io_kitti import OXTS_FIELDS

    traj = _bench_trajectory()
    world = sim.World()
    d = os.path.join(root, "2011_09_26", "2011_09_26_drive_0001_sync")
    velo = os.path.join(d, "velodyne_points", "data")
    oxts = os.path.join(d, "oxts", "data")
    os.makedirs(velo)
    os.makedirs(oxts)
    rng = np.random.default_rng(seed)
    gt, points = [], 0
    for i in range(n_scans):
        t0 = i * SCAN_DT
        pose = traj.pose(t0)
        xyz, _, _, _ = sim.raycast_scan(
            world, pose, n_scan=n_rings, horizon=horizon, rng=rng,
            elev_limits=elev, spin_period=SCAN_DT,
            traj=traj if motion else None, t0=t0)
        pts = np.concatenate([xyz, np.ones((len(xyz), 1), np.float32)], 1)
        pts.astype(np.float32).tofile(os.path.join(velo, f"{i:010d}.bin"))
        gt.append(pose[:3, 3])
        points = len(xyz)
    with open(os.path.join(d, "velodyne_points", "timestamps.txt"), "w") as f:
        f.write("".join(_kitti_stamp(i * SCAN_DT) + "\n"
                        for i in range(n_scans)))
    imu = _imu_series(traj, n_scans * SCAN_DT + 0.2, OXTS_HZ, seed + 1)
    lat0, lon0 = KITTI_LATLON0
    col = {k: i for i, k in enumerate(OXTS_FIELDS)}
    rows = np.zeros((len(imu["t"]), len(OXTS_FIELDS)))
    # the inverse of io_kitti.latlon_to_enu about the first fix
    east, north = imu["pos"][:, 0] - imu["pos"][0, 0], \
        imu["pos"][:, 1] - imu["pos"][0, 1]
    rows[:, col["lat"]] = lat0 + np.degrees(north / EARTH_RADIUS_M)
    rows[:, col["lon"]] = lon0 + np.degrees(
        east / (EARTH_RADIUS_M * np.cos(np.radians(lat0))))
    rows[:, col["alt"]] = 500.0 + imu["pos"][:, 2]
    for k, name in enumerate(("roll", "pitch", "yaw")):
        rows[:, col[name]] = imu["rpy"][:, k]
    rows[:, col["vn"]], rows[:, col["ve"]] = imu["vel"][:, 1], imu["vel"][:, 0]
    rows[:, col["vu"]] = imu["vel"][:, 2]
    for axes, key in ((("ax", "ay", "az"), "acc"), (("af", "al", "au"), "acc"),
                      (("wx", "wy", "wz"), "gyro"),
                      (("wf", "wl", "wu"), "gyro")):
        for k, name in enumerate(axes):
            rows[:, col[name]] = imu[key][:, k]
    rows[:, col["pos_accuracy"]] = KITTI_POS_ACCURACY_M
    rows[:, col["vel_accuracy"]] = 0.05
    rows[:, col["navstat"]], rows[:, col["numsats"]] = 4, 11
    for k, row in enumerate(rows):
        with open(os.path.join(oxts, f"{k:010d}.txt"), "w") as f:
            f.write(" ".join(f"{v:.12g}" for v in row) + "\n")
    with open(os.path.join(d, "oxts", "timestamps.txt"), "w") as f:
        f.write("".join(_kitti_stamp(t) + "\n" for t in imu["t"]))
    return d, np.stack(gt), points


def _write_ouster_bag(path, data, traj=None):
    """`data` (sim.make_dataset scans) as a rosbag 2.0 of one uncompressed
    chunk: /imu (sensor_msgs/Imu: the scans' IMU samples merged into one
    stream, with the trajectory's attitude) and /points
    (sensor_msgs/PointCloud2 in Ouster's layout: x, y, z, intensity float32,
    t uint32 ns from the sweep's start, reflectivity uint16, ring uint8,
    noise uint16, range uint32 mm).  Messages are in the order a recorder
    writes them: a cloud after the IMU samples of its scan's window (0.15 s
    past its stamp in sim.make_dataset), as a cloud that arrives after its
    sweep.  Returns the IMU stream written (t, gyro, acc, rpy)."""
    import struct

    from scipy.spatial.transform import Rotation as Rs

    traj = traj or _bench_trajectory()
    t = np.concatenate([s["imu_t"] for s in data]).astype(np.float64)
    g = np.concatenate([s["imu_gyro"] for s in data])
    a = np.concatenate([s["imu_acc"] for s in data])
    _, first = np.unique(np.round(t * 1e4).astype(np.int64), return_index=True)
    t, g, a = t[first], g[first], a[first]
    rpy = np.stack([Rs.from_matrix(traj.pose(x)[:3, :3]).as_euler("xyz")
                    for x in t])
    quat = Rs.from_euler("xyz", rpy).as_quat()   # x, y, z, w

    def header_fields(fields):
        out = b""
        for k, v in fields.items():
            e = k.encode() + b"=" + v
            out += struct.pack("<I", len(e)) + e
        return out

    def record(fields, body):
        h = header_fields(fields)
        return struct.pack("<I", len(h)) + h + struct.pack("<I", len(body)) \
            + body

    def stamp(x):
        sec = int(x)
        return struct.pack("<II", sec, int(round((x - sec) * 1e9)))

    def conn(i, topic, typ):
        return record({"op": b"\x07", "conn": struct.pack("<I", i),
                       "topic": topic}, header_fields(
            {"topic": topic, "type": typ, "md5sum": b"*"}))

    def imu_msg(k):
        return (struct.pack("<I", k) + stamp(t[k]) + struct.pack("<I", 3)
                + b"imu" + struct.pack("<4d", *quat[k]) + bytes(72)
                + struct.pack("<3d", *g[k]) + bytes(72)
                + struct.pack("<3d", *a[k]) + bytes(72))

    ouster = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("intensity", "<f4"), ("t", "<u4"),
                       ("reflectivity", "<u2"), ("ring", "u1"),
                       ("pad", "u1"), ("noise", "<u2"), ("range", "<u4")])
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
              ("t", 16, 6), ("reflectivity", 20, 4), ("ring", 22, 2),
              ("noise", 24, 4), ("range", 26, 6)]

    def cloud_msg(i, s):
        n = len(s["xyz"])
        rec = np.zeros(n, ouster)
        rec["x"], rec["y"], rec["z"] = s["xyz"].T
        rec["intensity"] = 100.0
        rec["t"] = np.round(s["time_rel"].astype(np.float64) * 1e9)
        rec["ring"] = s["ring"]
        rec["range"] = np.round(np.linalg.norm(s["xyz"], axis=1) * 1e3)
        body = struct.pack("<I", i) + stamp(s["scan_start"]) \
            + struct.pack("<I", 9) + b"os_sensor" + struct.pack("<II", 1, n) \
            + struct.pack("<I", len(fields))
        for name, off, dt in fields:
            body += struct.pack("<I", len(name)) + name.encode() \
                + struct.pack("<IBI", off, dt, 1)
        body += b"\x00" + struct.pack("<II", ouster.itemsize,
                                      ouster.itemsize * n)
        payload = rec.tobytes()
        return body + struct.pack("<I", len(payload)) + payload + b"\x01"

    parts = [conn(0, b"/imu", b"sensor_msgs/Imu"),
             conn(1, b"/points", b"sensor_msgs/PointCloud2")]
    k = 0
    for i, s in enumerate(data):
        due = float(s["imu_t"][-1])
        while k < len(t) and t[k] <= due:
            parts.append(record({"op": b"\x02", "conn": struct.pack("<I", 0),
                                 "time": stamp(t[k])}, imu_msg(k)))
            k += 1
        parts.append(record({"op": b"\x02", "conn": struct.pack("<I", 1),
                             "time": stamp(due)}, cloud_msg(i, s)))
    chunk = b"".join(parts)
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(record({"op": b"\x05", "compression": b"none",
                        "size": struct.pack("<I", len(chunk))}, chunk))
    return dict(t=t, gyro=g, acc=a, rpy=rpy)


def _write_pcap(path, packets, stamps):
    """Packets (P, 1206) as a classic pcap: each payload behind 42 bytes of
    Ethernet, IPv4 and UDP header, at its capture stamp."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
        for pkt, st in zip(packets, stamps):
            sec = int(st)
            usec = int(round((st - sec) * 1e6))
            frame = (b"\xff" * 6 + b"\x60\x76\x88\x00\x00\x00" + b"\x08\x00"
                     + struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + 8 + 1206, 0,
                                   0x4000, 64, 17, 0, bytes([192, 168, 1, 201]),
                                   bytes([255, 255, 255, 255]))
                     + struct.pack("!HHHH", 2368, 2368, 8 + 1206, 0)
                     + bytes(pkt))
            f.write(struct.pack("<IIII", sec, usec, len(frame), len(frame)))
            f.write(frame)


@contextmanager
def _lio_watch(device_name):
    """Around one run of the LIO commands: every kernel launch count set to
    0; each top-level ``LioSam.process_scan`` timed to its pose on the host
    (phase 4's scan-to-pose latency; the boot re-feed counts in the scan
    that triggers it); every Gauss-Newton iteration counted; the LioSam the
    command made kept.  Yields a dict read after the block."""
    from msst_torch import cli
    from msst_torch.models.liosam import pipeline
    from msst_torch.ops import gather, knn, registration, voxelmap

    counters = {"voxel_lookup_cat": voxelmap.lookup_cat,
                "knn_query": knn.query, "gather_rows": gather.gather_rows}
    watch = {"ms": [], "keyframe": [], "gps": [], "gn": [], "s2m": [],
             "lios": []}
    depth = [0]
    process_scan, lio_run = pipeline.LioSam.process_scan, cli._lio_run
    entries = {name: getattr(registration, name)
               for name in ("scan_to_map_voxel", "scan_to_map")}

    def timed_scan(self, *args, **kwargs):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            out = process_scan(self, *args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            out.pose_matrix.cpu()
            watch["ms"].append(1000.0 * (time.perf_counter() - t0))
            watch["keyframe"].append(out.is_keyframe)
            watch["gps"].append(self.state.n_gps)
        return out

    def counted(inner):
        def run(*args, **kwargs):
            out = inner(*args, **kwargs)
            watch["gn"].append(out.iterations)
            watch["s2m"].append(out)
            return out
        return run

    def kept_run(*args, **kwargs):
        lio = lio_run(*args, **kwargs)
        watch["lios"].append(lio)
        return lio

    for fn in counters.values():
        fn.launches = 0
    pipeline.LioSam.process_scan = timed_scan
    cli._lio_run = kept_run
    for name, inner in entries.items():
        setattr(registration, name, counted(inner))
    try:
        yield watch
    finally:
        pipeline.LioSam.process_scan = process_scan
        cli._lio_run = lio_run
        for name, inner in entries.items():
            setattr(registration, name, inner)
        if device_name == "cuda":
            import torch

            torch.cuda.synchronize()
        watch["launched"] = {name: fn.launches
                             for name, fn in counters.items()}
        watch["gn_total"] = (int(sum(int(x) for x in watch["gn"]))
                             if watch["gn"] else 0)


def _run_cli(argv):
    """``msst_torch.cli.main(argv)`` in this process: (stdout, stderr)."""
    import io

    from msst_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(argv)
    return out.getvalue(), err.getvalue()


def _kitti_poses(path):
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :] = rows
    return poses


def _errors(est, gt):
    """(max_err, final_err, drift_pct_per_m, path_len) of poses `est`
    (N, 4, 4) against true positions `gt` (N, 3), bench.py's definitions
    with the truth about its first position."""
    gt = gt - gt[0]
    e = est[:, :3, 3]
    n = min(len(e), len(gt))
    err = np.linalg.norm(e[:n] - gt[:n], axis=1)
    path = float(np.linalg.norm(np.diff(gt[:n], axis=0), axis=1).sum())
    return (float(err.max()), float(err[-1]),
            100.0 * float(err.max()) / max(path, 1e-6), path)


def _perturbed(scans, seed):
    """Copies of scan dicts `scans` with every point coordinate scaled by
    1 + 2^-23 N(0, 1) (numpy's generator seeded by `seed`, scan after
    scan): a rounding-level change of the input."""
    rng = np.random.default_rng(seed)
    out = []
    for s in scans:
        scale = 1.0 + 2.0 ** -23 * rng.standard_normal(s["xyz"].shape)
        out.append(dict(s, xyz=(s["xyz"] * scale).astype(s["xyz"].dtype)))
    return out


def _bag_ate(est, gt):
    """Phase 13b's ATE: ``kitti_eval.ate_rmse`` of poses `est` against the
    true positions `gt` (N, 3) about the truth's first."""
    from msst_torch.utils.kitti_eval import ate_rmse

    truth = np.tile(np.eye(4), (len(gt), 1, 1))
    truth[:, :3, 3] = gt - gt[0]
    return float(ate_rmse(est, truth))


def _steady(ms, boot=8):
    """scans/s, p50 and p99 ms of the scans after the boot re-feed."""
    steady = np.asarray(ms[boot + 1:])
    return (len(steady) / (steady.sum() / 1000.0),
            float(np.percentile(steady, 50)), float(np.percentile(steady, 99)))


def phase_lio_kitti(kitti, workdir, card, dev_name="cuda"):
    """Phase 13a: ``msst_torch.cli.main(["lio-kitti", DIR, ...])`` in this
    process at its own profile (64 x 1800, 150,000 points, the default
    8-scan boot) over the synthetic KITTI drive, with --viz-every; gates
    against the simulator's truth (drift, the command's own ATE line); B1
    launches against the Gauss-Newton iterations; then a short GPS run
    through the command's ``_lio_run``.  Returns the result and the CPU
    run's process (the drive's first 8 scans on the CPU, checked after
    13b)."""
    import io
    import itertools

    from msst_torch import cli
    from msst_torch.models.liosam.params import LioParams
    from msst_torch.utils.io_kitti import KittiRawDrive

    drive, gt, points = kitti
    out = os.path.join(workdir, "kitti_trajectory.txt")
    stats = os.path.join(workdir, "kitti_stats.json")
    viz = os.path.join(workdir, "viz")
    t0 = time.perf_counter()
    with _lio_watch(dev_name) as w:
        text, log = _run_cli(["lio-kitti", drive, "--output", out,
                              "--stats-json", stats, "--viz-every",
                              str(KITTI_VIZ_EVERY), "--viz-dir", viz,
                              "--device", dev_name])
    wall = time.perf_counter() - t0
    lio = w["lios"][0]
    if lio.device.type != dev_name or lio.p.n_scan != KITTI_RINGS \
            or lio.p.horizon_scan != KITTI_HORIZON \
            or lio.p.max_points != KITTI_MAX_POINTS:
        raise AssertionError(f"13a ran {lio.p.n_scan} x {lio.p.horizon_scan}"
                             f", {lio.p.max_points} points on {lio.device}")
    ate = [ln for ln in text.splitlines() if ln.startswith("ATE RMSE: ")]
    if len(ate) != 1:
        raise AssertionError(f"13a: no ATE line in the output:\n{text}")
    ate_m = float(ate[0].split()[2]) / 100.0
    est = _kitti_poses(out)
    max_err, final_err, drift, path = _errors(est, gt)
    launches, gn = w["launched"]["voxel_lookup_cat"], w["gn_total"]
    lookups, reassoc = _check_lookups("13a", launches, w["s2m"], gn)
    sps, p50, p99 = _steady(w["ms"])
    res = {"scans": len(est), "points_per_sweep": points,
           "max_points": KITTI_MAX_POINTS, "wall_s": wall,
           "launches": launches, "launched": w["launched"],
           "gn_iterations": gn, "lookups": lookups,
           "reassociations": reassoc,
           "keyframes": int(lio.state.kf.count),
           "ate_m": ate_m, "max_err_m": max_err, "final_err_m": final_err,
           "drift_pct_per_m": drift, "path_len_m": path,
           "scans_per_s": sps, "p50_ms": p50, "p99_ms": p99,
           "stats": json.load(open(stats)), "step_ms": w["ms"],
           "viz_ticks": log.count("viz: scan")}
    print(f"phase 13a: msst-torch lio-kitti on {lio.device}, {KITTI_RINGS} x "
          f"{KITTI_HORIZON}, max_points {KITTI_MAX_POINTS}, {points} points "
          f"a sweep, {len(est)} scans: '{ate[0]}' ({ate_m:.4f} m), max err "
          f"{max_err:.4f} m, final err {final_err:.4f} m (not gated: 8-scan "
          f"boot), drift {drift:.4f} %/m over {path:.1f} m; {launches} B1 "
          f"launches for {lookups} lookups ({len(w['s2m'])} GN loops + "
          f"{reassoc} re-associations) in {gn} GN iterations, "
          f"{res['keyframes']} keyframes; "
          f"{sps:.2f} scans/s, per-scan p50 {p50:.2f} ms p99 {p99:.2f} ms "
          f"(pose on host, scans 9+); stats {res['stats']}; {wall:.1f} s "
          f"[{card}]", flush=True)
    # bench.py's gates; msst_tpu meets them on this drive too, on the CPU
    # (scripts/torch_vs_ref_drive.py --kitti DIR --scans 128 --packages
    # msst_tpu): drift 0.4205 %/m, ATE 1.6 cm, final error 0.1057 m
    if drift > DRIFT_GATE_PCT or ate_m > FINAL_GATE_M:
        raise AssertionError(
            f"13a gates: drift {drift:.4f} %/m (<= {DRIFT_GATE_PCT}), "
            f"ATE {ate_m:.4f} m (<= {FINAL_GATE_M})")

    # --gps over the first scans: the datum locks after 30 fixes, then each
    # fix is fed.  LioSam's gate adds a GPS factor only while the position
    # covariance's trace is >= pose_cov_threshold (0.05) or the match
    # degenerates, which this drive never reaches (~0.006, CPU run): the
    # run opens the gate (pose_cov_threshold = 0), as tests/test_liosam.py's
    # elevation test does, through the command's own _lio_run
    t0 = time.perf_counter()
    err = io.StringIO()
    p = LioParams(n_scan=KITTI_RINGS, horizon_scan=KITTI_HORIZON,
                  max_points=KITTI_MAX_POINTS, loop_closure_enabled=False,
                  pose_cov_threshold=0.0)
    with _lio_watch(dev_name) as g, contextlib.redirect_stderr(err):
        scans = itertools.islice(
            KittiRawDrive(drive, KITTI_RINGS).iter_scans(with_gps=True),
            KITTI_GPS_SCANS)
        glio = cli._lio_run(scans, params=p, gps=True, progress=False,
                            device=dev_name)
    locked = [ln for ln in err.getvalue().splitlines()
              if ln.startswith("gps datum locked after")]
    n_gps = [int(x) for x in g["gps"]]
    first = next((i for i, n in enumerate(n_gps) if n > 0), None)
    kf_ms = [m for i, m in enumerate(g["ms"]) if first is not None
             and i > first and bool(g["keyframe"][i])]
    other_ms = [m for i, m in enumerate(g["ms"]) if first is not None
                and i > first and not bool(g["keyframe"][i])]
    res["gps"] = {"scans": KITTI_GPS_SCANS, "locked": locked,
                  "gps_factors": int(glio.state.n_gps),
                  "first_factor_scan": first, "keyframe_ms": kf_ms,
                  "other_ms": other_ms, "wall_s": time.perf_counter() - t0,
                  "gn_iterations": g["gn_total"],
                  "launches": g["launched"]["voxel_lookup_cat"]}
    print(f"phase 13a --gps: {KITTI_GPS_SCANS} scans, "
          f"{locked[0] if locked else 'no datum'}; "
          f"{res['gps']['gps_factors']} GPS factors, the first at scan "
          f"{first}; after it {len(kf_ms)} keyframes at "
          f"{np.median(kf_ms) if kf_ms else float('nan'):.1f} ms median "
          f"(max {max(kf_ms) if kf_ms else float('nan'):.1f}; the full-graph "
          f"solve, ROADMAP P5), other scans "
          f"{np.median(other_ms) if other_ms else float('nan'):.1f} ms; "
          f"{res['gps']['wall_s']:.1f} s [{card}]", flush=True)
    if not locked or not locked[0].startswith(
            "gps datum locked after 30 fixes") or not n_gps[-1] or not kf_ms:
        raise AssertionError(f"13a --gps: datum {locked}, GPS factors "
                             f"{n_gps[-1] if n_gps else 0}, keyframes after "
                             f"the first {len(kf_ms)}")
    # the command itself with --gps over the same scans, at its own gate:
    # the reader's fixes, the datum, the ATE report
    t0 = time.perf_counter()
    text, log = _run_cli(["lio-kitti", drive, "--gps", "--scans",
                          str(KITTI_GPS_SCANS), "--output",
                          os.path.join(workdir, "kitti_gps.txt"),
                          "--device", dev_name])
    cmd_locked = [ln for ln in log.splitlines()
                  if ln.startswith("gps datum locked after 30 fixes")]
    cmd_ate = [ln for ln in text.splitlines() if ln.startswith("ATE RMSE: ")]
    res["gps"]["command"] = {"locked": cmd_locked, "ate": cmd_ate,
                             "wall_s": time.perf_counter() - t0}
    print(f"phase 13a lio-kitti --gps --scans {KITTI_GPS_SCANS}: "
          f"{cmd_locked[0] if cmd_locked else 'no datum'}; "
          f"{cmd_ate[0] if cmd_ate else 'no ATE line'}; "
          f"{res['gps']['command']['wall_s']:.1f} s [{card}]", flush=True)
    if len(cmd_locked) != 1 or len(cmd_ate) != 1:
        raise AssertionError(f"13a lio-kitti --gps: datum {cmd_locked}, "
                             f"ATE {cmd_ate}")
    # the drive's first 8 scans on the CPU, in a process of its own while
    # 13b runs on the card; read back by phase_lio_cpu
    cpu_out = os.path.join(workdir, "kitti_cpu.txt")
    env = dict(os.environ, OMP_NUM_THREADS="6")
    cpu = subprocess.Popen(
        [sys.executable, "-m", "msst_torch.cli", "lio-kitti", drive,
         "--scans", str(KITTI_CPU_SCANS), "--output", cpu_out, "--device",
         "cpu"], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    res["cpu_job"] = (cpu, cpu_out, est[:KITTI_CPU_SCANS])
    res["viz_dir"] = viz
    return res


def phase_lio_cpu(job, card):
    """Phase 13a, the CPU run: the drive's first 8 scans through ``python -m
    msst_torch.cli lio-kitti --device cpu``, within CPU_AGREE_M of the
    card's first 8 poses."""
    proc, path, card_poses = job
    log, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"13a CPU run exited {proc.returncode}:\n"
                             f"{log[-3000:]}")
    cpu = _kitti_poses(path)
    gap = float(np.linalg.norm(cpu[:, :3, 3] - card_poses[:, :3, 3],
                               axis=1).max())
    print(f"phase 13a CPU: lio-kitti --device cpu over the first "
          f"{len(cpu)} scans: {gap:.6f} m from the card's (<= "
          f"{CPU_AGREE_M}) [{card}]", flush=True)
    if len(cpu) != len(card_poses) or gap > CPU_AGREE_M:
        raise AssertionError(f"13a: the CPU run is {gap:.6f} m from the card")
    return {"scans": len(cpu), "gap_m": gap}


def _same_imu(a, b):
    """Scan dict `a` holds the IMU samples of scan dict `b` (stamps within
    1 us, gyro and acc equal) between b's second and last-but-one sample,
    and no other there: the windows' edges (0.5 s before the stamp, 0.15 s
    after it) may keep or drop a sample whose float32 stamp rounds across
    them, and the pipeline reads neither edge."""
    tb = np.asarray(b["imu_t"][1:-1], np.float64)
    ta = np.asarray(a["imu_t"], np.float64)
    if not len(tb) or abs(a["scan_start"] - b["scan_start"]) > 1e-6:
        return False
    inner = (ta > tb[0] - 1e-6) & (ta < tb[-1] + 1e-6)
    j = np.nonzero(inner)[0]
    return (len(j) == len(tb)
            and np.allclose(ta[j], tb, rtol=0, atol=1e-6)
            and np.array_equal(a["imu_gyro"][j], b["imu_gyro"][1:-1])
            and np.array_equal(a["imu_acc"][j], b["imu_acc"][1:-1]))


def phase_lio_bag(data, workdir, card, dev_name="cuda"):
    """Phase 13b: bench-voxel's drive as a rosbag 2.0 of Ouster-layout
    clouds, in the order a recorder writes it; ``iter_lio_inputs`` gives
    back the simulator's points and IMU samples, and as the first scan's
    attitude the one of the last IMU message in its window (msst_tpu's
    reader, as it is); ``msst-torch lio-bag`` on the card within CPU_AGREE_M
    of ``LioSam(LioParams(loop_closure_enabled=False))`` (the command's
    profile) fed those scans directly, its map frame seeded by that
    attitude, one B1 launch a lookup.  The attitude read 0.15 s past the
    stamp turns the map frame by 0.03 rad on this drive; neither package
    meets bench.py's gates after it and the start is unstable in both
    (ROADMAP section 3; PERF.md section 6), so the accuracy is held as a
    spread: the command's loop over the scans perturbed by each seed of
    BAG_REFERENCE, the median drift and ATE at or under msst_tpu's largest
    over the same feeds."""
    from msst_torch import cli
    from msst_torch.models.liosam import LioSam
    from msst_torch.models.liosam.params import LioParams
    from msst_torch.utils import io_rosbag, sensor_formats

    bag = os.path.join(workdir, "bench_voxel_ouster.bag")
    t0 = time.perf_counter()
    imu = _write_ouster_bag(bag, data)
    write_s, size = time.perf_counter() - t0, os.path.getsize(bag)
    first = next(raw for topic, _, _, raw in io_rosbag.RosbagReader(bag)
                 .messages({"/points"}))
    sensor = sensor_formats.detect_sensor(io_rosbag.decode_pointcloud2(first))
    scans = list(io_rosbag.iter_lio_inputs(bag, "/points", "/imu"))
    exact = len(scans) == len(data) and all(
        np.array_equal(s["xyz"], d["xyz"])
        and np.array_equal(s["ring"], d["ring"])
        and _same_imu(s, d) for s, d in zip(scans, data))
    t_gap = max(float(np.abs(s["time_rel"] - d["time_rel"]).max())
                for s, d in zip(scans, data))
    last = [int(np.argmin(np.abs(imu["t"] - s["imu_t"][-1]))) for s in scans]
    rpy_gap = max(float(np.abs(s["imu_rpy"] - imu["rpy"][k]).max())
                  for s, k in zip(scans, last))
    heading0 = float(np.arctan2(data[0]["gt_pose"][1, 0],
                                data[0]["gt_pose"][0, 0]))
    yaw0 = float(scans[0]["imu_rpy"][2]) - heading0
    print(f"phase 13b: wrote {len(data)} scans as a {size / 1e6:.1f} MB "
          f"rosbag in {write_s:.1f} s; detected '{sensor}'; iter_lio_inputs "
          f"gave {len(scans)} scans, xyz, ring and IMU equal to the "
          f"simulator's: {exact}, time_rel within {t_gap:.2e} s (Ouster's t "
          f"is integer ns), the attitude that of each window's last IMU "
          f"message within {rpy_gap:.1e} rad (the first scan's yaw "
          f"{yaw0:.4f} rad ahead of the truth's at its stamp)", flush=True)
    if sensor != "ouster" or not exact or t_gap > 1e-9 or rpy_gap > 1e-6:
        raise AssertionError("13b: the bag does not give back the drive")

    out = os.path.join(workdir, "bag_trajectory.txt")
    t0 = time.perf_counter()
    with _lio_watch(dev_name) as w:
        _run_cli(["lio-bag", bag, "--cloud-topic", "/points", "--imu-topic",
                  "/imu", "--output", out, "--device", dev_name])
    wall = time.perf_counter() - t0
    got = _kitti_poses(out)
    lio = LioSam(LioParams(loop_closure_enabled=False), device=dev_name)
    for s in scans:
        lio.process_scan(s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
                         imu_t=s["imu_t"], imu_gyro=s["imu_gyro"],
                         imu_acc=s["imu_acc"], imu_rpy=s["imu_rpy"])
    direct = lio.trajectory.as_matrices()
    gap = float(np.linalg.norm(got[:, :3, 3] - direct[:, :3, 3], axis=1)
                .max()) if len(got) == len(direct) else float("inf")
    seeded = abs(float(np.arctan2(got[0, 1, 0], got[0, 0, 0]))
                 - float(scans[0]["imu_rpy"][2]))
    gt = np.stack([d["gt_pose"][:3, 3] for d in data])
    max_err, final_err, drift, path = _errors(got, gt)
    ate = _bag_ate(got, gt)
    launches, gn = w["launched"]["voxel_lookup_cat"], w["gn_total"]
    lookups, reassoc = _check_lookups("13b", launches, w["s2m"], gn)
    sps, p50, p99 = _steady(w["ms"])
    t0 = time.perf_counter()
    spread = {}
    for seed in BAG_REFERENCE:
        est = cli._lio_run(iter(_perturbed(scans, seed)), progress=False,
                           device=dev_name).trajectory.as_matrices()
        spread[seed] = (_errors(est, gt)[2], _bag_ate(est, gt))
    spread_s = time.perf_counter() - t0
    med_drift, med_ate = np.median(list(spread.values()), axis=0)
    ref_drift, ref_ate = np.max(list(BAG_REFERENCE.values()), axis=0)
    res = {"scans": len(got), "bag_mb": size / 1e6, "write_s": write_s,
           "wall_s": wall, "direct_gap_m": gap, "launches": launches,
           "gn_iterations": gn, "lookups": lookups,
           "reassociations": reassoc, "first_yaw_offset_rad": yaw0,
           "seeded_gap_rad": seeded, "ate_m": ate, "max_err_m": max_err,
           "final_err_m": final_err, "drift_pct_per_m": drift,
           "path_len_m": path, "perturbed": {str(k): v for k, v in spread.items()},
           "median_drift_pct_per_m": float(med_drift),
           "median_ate_m": float(med_ate), "spread_s": spread_s,
           "scans_per_s": sps, "p50_ms": p50, "p99_ms": p99,
           "keyframes": int(w["lios"][0].state.kf.count)}
    print(f"phase 13b: msst-torch lio-bag on {dev_name}, {len(got)} scans: "
          f"{gap:.6f} m from LioSam fed the same scans directly (<= "
          f"{CPU_AGREE_M}); first heading {seeded:.1e} rad from the reader's "
          f"attitude; against the truth: ATE {ate:.4f} m, max err "
          f"{max_err:.4f} m, final {final_err:.4f} m, drift {drift:.4f} %/m; "
          f"{launches} B1 launches for {lookups} lookups "
          f"({len(w['s2m'])} GN loops + {reassoc} re-associations) in {gn} "
          f"GN iterations, {res['keyframes']} keyframes; {sps:.2f} scans/s, "
          f"p50 {p50:.2f} ms p99 {p99:.2f} ms; {wall:.1f} s [{card}]",
          flush=True)
    print(f"phase 13b spread: the loop over the scans perturbed by seeds "
          f"{list(spread)}: drift %/m "
          f"{[round(v[0], 4) for v in spread.values()]}, ATE m "
          f"{[round(v[1], 4) for v in spread.values()]}; median drift "
          f"{med_drift:.4f} %/m (<= msst_tpu's largest {ref_drift:.4f}), "
          f"median ATE {med_ate:.4f} m (<= {ref_ate:.4f}); {spread_s:.1f} s "
          f"[{card}]", flush=True)
    if gap > CPU_AGREE_M or seeded > 1e-4:
        raise AssertionError(f"13b: lio-bag is {gap:.6f} m from the direct "
                             f"feed, its first heading {seeded:.1e} rad from "
                             "the reader's")
    if med_drift > ref_drift or med_ate > ref_ate:
        raise AssertionError(
            f"13b gates: median drift {med_drift:.4f} %/m (<= msst_tpu's "
            f"{ref_drift:.4f}), median ATE {med_ate:.4f} m (<= {ref_ate:.4f})")
    return res


def _fixed_frame_reference(xyz, t, pose_times, poses6):
    """transform_to_fixed_frame in float64 numpy: each point's pose
    interpolated between its two timeline poses (slerp, linear
    translation), clamped at the ends."""
    from scipy.spatial.transform import Rotation as Rs

    M = len(pose_times)
    j = np.clip(np.searchsorted(pose_times, t, side="right") - 1, 0, M - 2)
    t0, t1 = pose_times[j], pose_times[j + 1]
    w = np.clip((t - t0) / np.maximum(t1 - t0, 1e-9), 0.0, 1.0)
    r = Rs.from_euler("xyz", poses6[:, :3].astype(np.float64))
    r0, r1 = r[j], r[j + 1]
    rot = r0 * Rs.from_rotvec((r0.inv() * r1).as_rotvec() * w[:, None])
    trans = poses6[j, 3:] * (1 - w[:, None]) + poses6[j + 1, 3:] * w[:, None]
    return rot.apply(xyz.astype(np.float64)) + trans


def phase_decode_pcap(card, workdir, dev_name="cuda"):
    """Phase 13c: tests/data/golden_packets.bin, repeated PCAP_REPEAT times,
    as a classic pcap; ``python -m msst_torch.cli decode-pcap`` writes a PCD
    equal to the numpy decoder's within PCAP_AGREE (the native decoder,
    built with g++ in that process), the native rings equal to numpy's; and
    ``packets_to_fixed_frame`` on the card against a float64 numpy
    reference of the same interpolation."""
    from msst_torch.utils import packets
    from msst_torch.utils.io_pcd import read_pcd

    root = os.path.dirname(os.path.abspath(__file__))
    golden = np.fromfile(os.path.join(root, "tests", "data",
                                      "golden_packets.bin"), np.uint8)
    pk = np.tile(golden.reshape(-1, 1206), (PCAP_REPEAT, 1))
    stamps = 1.6e9 + 0.25 + np.arange(len(pk)) * 0.00118
    pcap, pcd = os.path.join(workdir, "golden.pcap"), \
        os.path.join(workdir, "golden.pcd")
    _write_pcap(pcap, pk, stamps)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "msst_torch.cli",
                           "decode-pcap", pcap, pcd],
                          cwd=root, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"13c: decode-pcap exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    got = read_pcd(pcd)
    xyz, ring, _, inten = packets.packets_to_scan(pk, stamps=stamps,
                                                  force_numpy=True)
    nat = packets.packets_to_scan(pk, stamps=stamps)
    n_ok = len(got["xyz"]) == len(xyz)
    err = float(max(np.abs(got["xyz"] - xyz).max(),
                    np.abs(got["fields"]["intensity"] - inten).max())) \
        if n_ok else float("inf")
    rings = np.array_equal(nat[1], ring)

    # the transform node: a sensor turning and moving through the packets
    span = stamps[-1] - stamps[0]
    pose_t = stamps[0] - 0.001 + np.linspace(0.0, span + 0.002, 9)
    poses6 = np.zeros((9, 6), np.float32)
    poses6[:, 2] = np.linspace(0.0, 0.3, 9)
    poses6[:, 0] = np.linspace(0.0, 0.05, 9)
    poses6[:, 3] = np.linspace(0.0, 2.0, 9)
    poses6[:, 4] = np.linspace(0.0, -1.0, 9)
    fixed, _, _ = packets.packets_to_fixed_frame(pk, stamps, pose_t, poses6,
                                                 device=dev_name)
    d = packets.decode_packets(pk)
    v = d["valid"]
    t = (np.repeat(stamps, 384) + d["time_us"].astype(np.float64) * 1e-6)[v]
    want = _fixed_frame_reference(
        np.stack([d["x"][v], d["y"][v], d["z"][v]], 1), t - pose_t[0],
        pose_t - pose_t[0], poses6)
    ff_err = float(np.abs(fixed - want).max())
    ff_ms = _cuda_ms(lambda: packets.packets_to_fixed_frame(
        pk, stamps, pose_t, poses6, device=dev_name), n=10, warm=2) \
        if dev_name == "cuda" else None
    print(f"phase 13c: python -m msst_torch.cli decode-pcap, {len(pk)} "
          f"packets in {wall:.1f} s (g++ build included): {len(got['xyz'])} "
          f"points, max |diff| from the numpy decoder {err:.2e} (<= "
          f"{PCAP_AGREE}), native rings equal: {rings}; "
          f"packets_to_fixed_frame on {dev_name}: {len(fixed)} points, "
          f"{ff_err:.2e} m from float64 numpy (<= {FIXED_FRAME_AGREE_M}), "
          f"{_fmt_ms(ff_ms)} a call with the decode [{card}]", flush=True)
    if not n_ok or err > PCAP_AGREE or not rings \
            or ff_err > FIXED_FRAME_AGREE_M:
        raise AssertionError("13c: the pcap decode or the fixed-frame "
                             "projection disagrees")
    return {"packets": len(pk), "points": len(xyz), "max_abs_err": err,
            "fixed_frame_err_m": ff_err, "fixed_frame_ms": ff_ms,
            "wall_s": wall}


def phase_viewer(viz, card):
    """Phase 13d: 13a's --viz-every directory holds global_map.ply,
    trajectory.json and viewer.html (trajectory.png only where matplotlib
    imports); ``viz_html.make_server(dir, port=0)`` serves them on
    127.0.0.1 with caching off, and an overwrite is seen on the next
    fetch."""
    import threading
    import urllib.request

    from msst_torch.utils import viz as vz
    from msst_torch.utils import viz_html

    have = sorted(os.listdir(viz))
    try:
        import matplotlib  # noqa: F401
        png = True
    except ImportError:
        png = False
    srv = viz_html.make_server(viz, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        def get(name):
            r = urllib.request.urlopen(f"http://127.0.0.1:{port}/{name}",
                                       timeout=30)
            if r.headers["Cache-Control"] != "no-store":
                raise AssertionError(f"13d: {name} is cacheable")
            return r.read().decode()

        page = get("viewer.html")
        ply = get("global_map.ply")
        n_map = int(ply.split("element vertex ", 1)[1].split()[0])
        poses = len(json.loads(get("trajectory.json"))["xyz"])
        tmp = os.path.join(viz, ".global_map.ply.tmp")
        vz.write_ply(tmp, np.zeros((3, 3)))
        os.replace(tmp, os.path.join(viz, "global_map.ply"))
        reloaded = "element vertex 3\n" in get("global_map.ply")
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"phase 13d: viz dir {have}; served on 127.0.0.1:{port} with "
          f"Cache-Control no-store: viewer.html ({len(page)} B), "
          f"global_map.ply ({n_map} points), trajectory.json ({poses} "
          f"poses); an overwrite seen on the next fetch: {reloaded}; "
          f"matplotlib {'present' if png else 'absent, the PNG skipped'} "
          f"[{card}]", flush=True)
    want = {"global_map.ply", "trajectory.json", "viewer.html"}
    if not want <= set(have) or ("trajectory.png" in have) != png \
            or "webgl" not in page or not n_map or not reloaded:
        raise AssertionError(f"13d: the viewer's files or server: {have}")
    return {"files": have, "map_points": n_map, "poses": poses,
            "png": png}


# ---------------------------------------------------------------------------
# phase 14: multi-session mapping, eight sessions on one card
# ---------------------------------------------------------------------------

MS_SLOTS = 8
MS_SCANS = 56
MS_WARM = 24
MS_ALIGN_EVERY = 6
MS_BUDGET = 8
MS_SPEED_GATE = 1.0        # tests/test_parallel.py:324-338
MS_DATUM_GATE_M = 0.35
MS_SHARE_GATE = 0.7
# 14a is held to tests/test_parallel.py:324-338's gates as they are.  14b
# (a profile msst_tpu never validated for the fleet drive) drives seed 0
# over MS_FEEDS, its scans perturbed at the rounding level (`_perturbed`
# under the seed [feed, session]), each feed aligned and as a control.
# The control drives the first feed only: without the align, rounding
# moves its final error by 1 mm at most (msst_tpu over these feeds 0.552-
# 0.553 m, the card 0.552 m on each, PERF.md section 6).  Every feed must
# meet the speed, rendezvous and datum gates; the card's
# median over the feeds of each ratio gate must meet the gate, or, where
# msst_tpu misses it on one of the same feeds, msst_tpu's largest over
# them (as 13b holds the card to msst_tpu's largest): the align's result
# on this drive is a spread that rounding alone spans (PERF.md section 6).
# Per feed: msst_tpu's aligned drive (err_at_injection, err_final,
# err_datum_final, loops_total, mean_speed) and its control's err_final,
# on the CPU (scripts/torch_vs_ref_multisession.py --profile bench
# --packages msst_tpu --perturb FEED).
MS_FEEDS = (0, 1, 2, 3)
MS_REFERENCE = {
    "14a": None,
    "14b": {
        0: ({"err_at_injection": 0.525, "err_final": 0.619,
             "err_datum_final": 0.09, "loops_total": 40,
             "mean_speed": 2.31}, {"err_final": 0.552}),
        1: ({"err_at_injection": 0.526, "err_final": 1.291,
             "err_datum_final": 0.088, "loops_total": 40,
             "mean_speed": 2.287}, {"err_final": 0.553}),
        2: ({"err_at_injection": 0.525, "err_final": 0.775,
             "err_datum_final": 0.09, "loops_total": 40,
             "mean_speed": 2.306}, {"err_final": 0.552}),
        3: ({"err_at_injection": 0.525, "err_final": 1.269,
             "err_datum_final": 0.091, "loops_total": 40,
             "mean_speed": 2.295}, {"err_final": 0.552}),
    },
}
# the known offset lies in the grid ICP's basin on this sweep: from (0, 0,
# 0.03 rad, 0.15, -0.10, 0.05 m) msst_tpu's grid ICP stops at 0.5801 deg /
# 12.56 mm after 11 iterations, as the port's does, and from this one both
# recover 0.0074 deg / 2.46 mm in 4 (CPU runs, scripts/
# torch_vs_ref_grid_icp.py)
ICP14_OFFSET = (0.0, 0.0, 0.004, 0.04, -0.03, 0.02)  # rpy (rad), xyz (m)
ICP14_MAX_ITERS = 50
ICP14_TRUTH_DEG = 0.05
ICP14_TRUTH_M = 0.01
ICP14_AGREE = 1e-4    # card against the CPU twin, m and rad


def _ms_profiles():
    """{tag: (LioParams, horizon)}: 14a msst_tpu's drive profile
    (``drive_params()``, 16 x 360), 14b bench.py's profile (16 x 1800,
    ``LioParams`` defaults otherwise, 256 keyframes, loop closure off)."""
    from msst_torch.parallel import drive_params

    return {"14a": (drive_params(), 360),
            "14b": (_params("voxel"), HORIZON)}


def _ms_key(speed, n_scans, n_scan, horizon, seed):
    return (round(float(speed), 6), int(n_scans), int(n_scan), int(horizon),
            int(seed))


def _ms_session(j, horizon):
    """Session j's scans of ``multisession_drive`` (seed 0) at `horizon`
    columns, made as the drive makes them (runs in a worker process)."""
    from msst_torch.utils import sim

    speed = 1.6 + 1.4 * j / max(MS_SLOTS - 1, 1)
    data = sim.make_dataset(sim.World(), sim.SimTrajectory(
        kind="circle", radius=8.0, speed=speed), n_scans=MS_SCANS,
        scan_dt=SCAN_DT, n_scan=N_SCAN, horizon=horizon, seed=j)
    return _ms_key(speed, MS_SCANS, N_SCAN, horizon, j), data


@contextmanager
def _ms_cached_scans(cache):
    """``sim.make_dataset`` answering the drive's calls from `cache` (the
    worker pool's scans, the same arrays); any other call is simulated."""
    from msst_torch.utils import sim

    inner = sim.make_dataset

    def make_dataset(world, traj, n_scans=40, scan_dt=0.1, n_scan=16,
                     horizon=360, seed=0, **kw):
        key = _ms_key(traj.speed, n_scans, n_scan, horizon, seed)
        if (key in cache and not kw and scan_dt == SCAN_DT
                and traj.kind == "circle" and traj.radius == 8.0):
            return cache[key]
        return inner(world, traj, n_scans=n_scans, scan_dt=scan_dt,
                     n_scan=n_scan, horizon=horizon, seed=seed, **kw)

    sim.make_dataset = make_dataset
    try:
        yield
    finally:
        sim.make_dataset = inner


@contextmanager
def _ms_perturbed(sim, feed):
    """``sim.make_dataset`` of either package's simulator with each
    session's points scaled by `_perturbed` under the seed [feed, the
    session's seed]: the same rounding-level feeds in both packages."""
    inner = sim.make_dataset

    def make_dataset(world, traj, n_scans=40, scan_dt=0.1, n_scan=16,
                     horizon=360, seed=0, **kw):
        return _perturbed(inner(world, traj, n_scans=n_scans,
                                scan_dt=scan_dt, n_scan=n_scan,
                                horizon=horizon, seed=seed, **kw),
                          [feed, seed])

    sim.make_dataset = make_dataset
    try:
        yield
    finally:
        sim.make_dataset = inner


def _ms_drive(p, horizon, use_align, card_tag):
    """One ``multisession_drive`` on the card, 8 slots, with every kernel
    count set to 0 just before it and read just after; each fleet step and
    each align timed to the end of its device work; each align's host
    syncs counted by ``torch.cuda.set_sync_debug_mode("warn")`` and its ICP
    iterations (one stop flag read each) summed.  Returns (the drive's
    result, the record, the last step's states and scan times)."""
    import warnings

    import torch

    from msst_torch.ops import gather, knn, registration, voxelmap
    from msst_torch.parallel import make_mesh
    from msst_torch.parallel import multisession as ms

    rec = {"step_s": [], "align_s": [], "align_syncs": [], "icp_iters": []}
    last = {}
    step, align = ms.batched_odometry_step, ms.cross_session_align
    icp = registration.icp_point2point_brute
    icp_iters = []

    def timed_step(states, inputs, p, mesh, axis="session"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(states, inputs, p, mesh, axis)
        torch.cuda.synchronize()
        rec["step_s"].append(time.perf_counter() - t0)
        last["states"], last["scan_time"] = out[0], inputs.scan.scan_start
        return out

    def counted_icp(*args, **kwargs):
        res = icp(*args, **kwargs)
        icp_iters.append(res.iters)
        return res

    def timed_align(states, p, mesh, axis="session", n_cand=2):
        n0 = len(icp_iters)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = align(states, p, mesh, axis, n_cand)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            rec["align_s"].append(time.perf_counter() - t0)
        rec["align_syncs"].append(sum("synchroniz" in str(w.message)
                                      for w in caught))
        rec["icp_iters"].append(int(torch.stack(icp_iters[n0:]).sum()))
        return out

    counters = {"B1": voxelmap.lookup_cat, "B2": knn.query,
                "B3": gather.gather_rows}
    mesh = make_mesh(MS_SLOTS)
    ms.batched_odometry_step, ms.cross_session_align = timed_step, timed_align
    registration.icp_point2point_brute = counted_icp
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = ms.multisession_drive(p, mesh, n_scans=MS_SCANS,
                                    n_warm=MS_WARM,
                                    align_every=MS_ALIGN_EVERY,
                                    horizon=horizon, use_align=use_align)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    finally:
        ms.batched_odometry_step, ms.cross_session_align = step, align
        registration.icp_point2point_brute = icp
    steady = 1000.0 * np.asarray(rec["step_s"][2:])
    rec.update(
        step_p50_ms=float(np.percentile(steady, 50)),
        step_p99_ms=float(np.percentile(steady, 99)),
        scans_per_s=MS_SLOTS * len(rec["step_s"]) / rec["wall_s"],
        step_scans_per_s=MS_SLOTS * len(rec["step_s"]) / sum(rec["step_s"]),
        align_ms=[1000.0 * s for s in rec["align_s"]])
    if rec["launches"]["B1"] == 0:
        raise AssertionError(f"{card_tag}: the drive never launched B1")
    if use_align and rec["launches"]["B3"] == 0:
        raise AssertionError(f"{card_tag}: the aligns never launched B3")
    return res, rec, last


def _ms_gates(tag, runs, ref):
    """tests/test_parallel.py:324-338's gates on aligned drives against
    their controls, `runs` [(aligned, control)] (one per feed):
    [(gate, value, bound)], each value <= its bound (the speed and the loops
    > theirs).  The speed, loops and datum gates take the worst run; the
    two ratio gates the median over the runs.  `ref` (MS_REFERENCE) holds
    msst_tpu's drives over the same feeds, or None for the gates as they
    are: a ratio gate msst_tpu misses on one of its feeds takes msst_tpu's
    largest over the feeds as its bound."""
    def figures(a, c):
        return {"mean_speed > ": a["mean_speed"],
                "loops_total > ": a["loops_total"],
                "err_datum_final <= ": a["err_datum_final"],
                "err_final / err_at_injection <= ":
                    a["err_final"] / a["err_at_injection"],
                "err_final / control err_final <= ":
                    a["err_final"] / c["err_final"]}

    bounds = {"mean_speed > ": MS_SPEED_GATE, "loops_total > ": 0,
              "err_datum_final <= ": MS_DATUM_GATE_M,
              "err_final / err_at_injection <= ": MS_SHARE_GATE,
              "err_final / control err_final <= ": MS_SHARE_GATE}
    ratios = ("err_final / err_at_injection <= ",
              "err_final / control err_final <= ")
    card = [figures(a, c) for a, c in runs]
    gates = []
    for name, bound in bounds.items():
        values = [f[name] for f in card]
        if name in ratios:
            value = float(np.median(values))
            if ref:
                worst = max(figures(a, c)[name] for a, c in ref.values())
                bound = max(bound, worst)
        else:
            value = (min if name.endswith("> ") else max)(values)
        gates.append((name, value, bound))
    failed = [g for g in gates
              if (g[1] <= g[2] if g[0].endswith("> ") else g[1] > g[2])]
    for name, value, bound in gates:
        print(f"        {tag} gate {name}{bound:.4f}: {value:.4f}",
              flush=True)
    if failed:
        raise AssertionError(f"{tag}: gates missed: {failed}")
    return [{"gate": n.strip(), "value": v, "bound": b} for n, v, b in gates]


def _occupied(lm):
    """Usable voxels (mask & valid) of each session's corner and surf maps."""
    return [[int(x) for x in (v.mask & v.valid).sum(dim=1).tolist()]
            for v in (lm.corner_vox, lm.surf_vox)]


def phase_multisession(cache, card):
    """Phase 14: multi-session mapping on the card.  14a ``drive_params()``
    and 14b bench.py's profile: 8 session slots, 56 scans, the frame
    offsets injected at scan 24, an align every 6 scans, and a control
    drive without the align, under tests/test_parallel.py's gates; 14b
    over the perturbed feeds MS_FEEDS (`_ms_gates`, MS_REFERENCE), then
    both merges of its last feed's final states.  14c the grid ICP."""
    import torch

    from msst_torch.ops import gather, voxelmap
    from msst_torch.parallel import make_mesh
    from msst_torch.parallel import multisession as ms

    out = {}
    profiles = _ms_profiles()
    for tag in ("14a", "14b"):
        p, horizon = profiles[tag]
        t0 = time.perf_counter()
        if tag == "14b":
            torch.cuda.reset_peak_memory_stats()
        feeds = [None] if tag == "14a" else MS_FEEDS
        res = {"feeds": []}
        for feed in feeds:
            scans = {k: v if feed is None else _perturbed(v, [feed, k[-1]])
                     for k, v in cache.items() if k[3] == horizon}
            with _ms_cached_scans(scans):
                aligned, rec, last = _ms_drive(p, horizon, True, tag)
                if not res["feeds"]:
                    control, crec, _ = _ms_drive(p, horizon, False, tag)
                    res.update(control=control, control_record=crec)
            del scans
            res["feeds"].append({"feed": feed, "aligned": aligned,
                                 "record": rec})
            print(f"phase {tag}: multisession_drive, {MS_SLOTS} sessions "
                  f"of {N_SCAN}x{horizon} on one card, {MS_SCANS} scans, "
                  f"offsets at scan {MS_WARM}, an align every "
                  f"{MS_ALIGN_EVERY}, "
                  + ("the feed as simulated" if feed is None else
                     f"perturbed feed {feed}")
                  + f": aligned {aligned}; control"
                  + ("" if feed is None else f" (feed {feeds[0]})")
                  + f" {control}; fleet step "
                  f"p50 {rec['step_p50_ms']:.2f} ms, p99 "
                  f"{rec['step_p99_ms']:.2f} ms; {rec['scans_per_s']:.2f} "
                  f"scans/s over the sessions in the aligned drive's "
                  f"{rec['wall_s']:.2f} s ({rec['step_scans_per_s']:.2f} "
                  f"over its steps alone, control "
                  f"{crec['scans_per_s']:.2f}); aligns "
                  f"{[round(a, 1) for a in rec['align_ms']]} ms, host "
                  f"syncs {rec['align_syncs']}, ICP iterations "
                  f"{rec['icp_iters']}; launches aligned "
                  f"{rec['launches']}, control {crec['launches']} [{card}]",
                  flush=True)
        res["gates"] = _ms_gates(
            tag, [(f["aligned"], res["control"]) for f in res["feeds"]],
            MS_REFERENCE[tag])
        if tag == "14b":
            states, scan_time = last["states"], last["scan_time"]
            mesh = make_mesh(MS_SLOTS)
            own = _occupied(states.local_map)
            for fn in (voxelmap.lookup_cat, gather.gather_rows):
                fn.launches = 0
            merged, merge_s = _timed(lambda: ms.cooperative_map_merge(
                states, scan_time, p, mesh))
            sel, sel_s = _timed(
                lambda: ms.cooperative_map_merge_selective(
                    states, scan_time, p, mesh, budget=MS_BUDGET))
            b3 = gather.gather_rows.launches
            res["merge"] = {
                "own": own, "full": _occupied(merged.local_map),
                "selective": _occupied(sel.local_map),
                "merge_ms": 1000.0 * merge_s,
                "selective_ms": 1000.0 * sel_s, "selective_B3": b3,
                "peak_bytes": torch.cuda.max_memory_allocated()}
            m = res["merge"]
            print(f"        14b merges of feed {feeds[-1]}'s final states: "
                  f"usable voxels (corner, surf) a session: own "
                  f"{m['own']}, full merge {m['full']} in "
                  f"{m['merge_ms']:.1f} ms, selective (budget "
                  f"{MS_BUDGET}) {m['selective']} in "
                  f"{m['selective_ms']:.1f} ms with {b3} B3 launches; "
                  f"peak device memory "
                  f"{m['peak_bytes'] / 2**30:.3f} GiB", flush=True)
            if b3 == 0 or min(min(r) for r in m["full"]) == 0 or min(
                    min(r) for r in m["selective"]) == 0:
                raise AssertionError(f"14b merges: {m}")
            del merged, sel, states
        del last
        res["s"] = time.perf_counter() - t0
        print(f"        {tag}: {res['s']:.1f} s", flush=True)
        out[tag] = res
    return out


def phase_grid_icp(scene, card, dev_name="cuda"):
    """Phase 14c: the grid ``registration.icp_point2point`` (its
    correspondences from ``knn.query`` at k = 1, C = 16, B2) on phase 11's
    master sweep (16384 slots, cell 1.4 m: phase 3b's first shape) against
    the same cloud moved by ICP14_OFFSET: the offset recovered, and the
    pose within ICP14_AGREE of the CPU twin's on the same inputs."""
    import torch

    from msst_torch.ops import knn, registration, se3

    def run(dev):
        tq, tm = _prepped(scene[0], dev)
        off = se3.Pose.from_vec6(torch.tensor(ICP14_OFFSET, device=dev))
        src = off.inverse().apply(tq)
        grid = knn.build(tq, tm, 1.4, 16384)
        return registration.icp_point2point(
            src, tm, grid, tq, se3.Pose.identity(device=dev),
            max_iters=ICP14_MAX_ITERS, max_corr_dist=1.0)

    knn.query.launches = 0
    res, sec = _timed(lambda: run(torch.device(dev_name)))
    launches = knn.query.launches
    cpu = run(torch.device("cpu"))
    got = res.pose.to_vec6().cpu().numpy()
    truth_deg = float(np.rad2deg(np.abs(got[:3] - ICP14_OFFSET[:3]).max()))
    truth_m = float(np.abs(got[3:] - ICP14_OFFSET[3:]).max())
    agree = float(np.abs(got - cpu.pose.to_vec6().numpy()).max())
    iters = int(res.iters)
    print(f"phase 14c: grid icp_point2point on the card, {int(iters)} "
          f"iterations (CPU twin {int(cpu.iters)}), {launches} B2 launches, "
          f"{1000.0 * sec:.1f} ms; offset recovered to {truth_deg:.5f} deg / "
          f"{truth_m:.5f} m (gates {ICP14_TRUTH_DEG} deg / {ICP14_TRUTH_M} "
          f"m); fitness {float(res.fitness):.6f}; card vs CPU twin "
          f"{agree:.2e} (gate {ICP14_AGREE}) [{card}]", flush=True)
    if (launches != iters + 1 or truth_deg > ICP14_TRUTH_DEG
            or truth_m > ICP14_TRUTH_M or agree > ICP14_AGREE
            or not bool(res.converged)):
        raise AssertionError("14c: grid ICP missed its gates")
    return {"iters": iters, "cpu_iters": int(cpu.iters),
            "launches": launches, "ms": 1000.0 * sec, "truth_deg": truth_deg,
            "truth_m": truth_m, "cpu_gap": agree,
            "fitness": float(res.fitness)}


# ---------------------------------------------------------------------------
# phase 15: windowed dispatch, bench.py's protocol at W = 64
# ---------------------------------------------------------------------------

WINDOW = 64              # bench.py's MSST_BENCH_WINDOW default
LAT_WINDOWS = (1, 4)     # bench.py's MSST_BENCH_LATENCY_WINDOW default
LAT_SCANS = 96           # bench.py: 96 windows of 1, 24 of 4 (seed 9)
GRID_KEYS = ("ranges", "azimuth", "col_time", "elev")
SCAN_KEYS = ("xyz", "ring", "time_rel", "scan_start", "imu_t", "imu_gyro",
             "imu_acc", "imu_rpy")


def _window_dicts(scans, grids=True):
    """bench.py's ``_dicts``: the scan, its IMU and, with `grids`, the
    range-image grids that select the range-image upload."""
    keys = SCAN_KEYS + (GRID_KEYS if grids else ())
    return [{k: s[k] for k in keys} for s in scans]


def _windows_of(data, w, grids=True):
    return [_window_dicts(data[i:i + w], grids)
            for i in range(0, len(data), w)]


@contextmanager
def _watched_windows(lio, dev_name):
    """Record each window ``lio`` dispatches (in whichever thread): its
    upload layout (the decoder ``select_window_fn`` picks), the host ms of
    the dispatch and, on the card, CUDA events around it on the dispatching
    stream (read after the drive: no extra synchronisation)."""
    import torch

    from msst_torch.models.liosam.mapping import select_window_fn

    rec, inner = [], lio._dispatch_window

    def watched(buf, times, prev_count):
        ev = None
        if dev_name == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        out = inner(buf, times, prev_count)
        host_ms = 1000.0 * (time.perf_counter() - t0)
        if ev is not None:
            ev[1].record()
        rec.append({"layout": select_window_fn(lio.p, buf).__name__,
                    "scans": len(times), "host_ms": host_ms, "events": ev})
        return out

    lio._dispatch_window = watched
    try:
        yield rec
    finally:
        lio._dispatch_window = inner


def _window_ms(rec):
    """ms of each recorded window: the card's time between the events
    around its dispatch where there are events, else the host's."""
    return np.asarray([r["events"][0].elapsed_time(r["events"][1])
                       if r["events"] else r["host_ms"] for r in rec])


def _window_drive(tag, what, params, data, card, dev_name="cuda"):
    """bench.py's phase 1 (loop off) or 2 (loop on) at W = 64 on `data`:
    ``LioSam(params, window=64)`` takes the first window synchronously (the
    dynamic-init boot and its re-feed of that whole window), then the rest
    through ``process_window_async``, the range-image grids attached.  The
    kernel launch counters are set to 0 just before the drive and read just
    after; every window must take the hoisted range-image layout (ri2); B1
    must launch once per lookup the Gauss-Newton loops took; bench.py's
    gates.  Scans/s over the async part, ms a window, timings."""
    import torch

    from msst_torch.models.liosam import LioSam
    from msst_torch.models.liosam import pipeline as tpipe
    from msst_torch.ops import gather, knn, registration, voxelmap

    kernels = {"voxel_lookup_cat": voxelmap.lookup_cat,
               "knn_query": knn.query, "gather_rows": gather.gather_rows}
    lio = LioSam(params, device=dev_name, window=WINDOW)
    windows = _windows_of(data, WINDOW)
    s2m_inner, loop_inner = registration.scan_to_map_voxel, \
        tpipe.loop_closure_step
    s2m_runs, attempts = [], []

    def counted_s2m(*args, **kwargs):
        out = s2m_inner(*args, **kwargs)
        s2m_runs.append(out)
        return out

    def counted_loop(*args, **kwargs):
        attempts.append(1)
        return loop_inner(*args, **kwargs)

    registration.scan_to_map_voxel = counted_s2m
    tpipe.loop_closure_step = counted_loop
    try:
        with _watched_windows(lio, dev_name) as rec:
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            lio.process_window(windows[0])
            if dev_name == "cuda":
                torch.cuda.synchronize()
            boot_s = time.perf_counter() - t0
            n_boot = len(rec)
            lio.timings.clear()
            t0 = time.perf_counter()
            futs = [lio.process_window_async(b) for b in windows[1:]]
            for f in futs:
                f.result()
            if dev_name == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lio.flush()
            launched = {name: fn.launches for name, fn in kernels.items()}
    finally:
        registration.scan_to_map_voxel = s2m_inner
        tpipe.loop_closure_step = loop_inner
    layouts = sorted({r["layout"] for r in rec})
    if layouts != ["odometry_window_flat_ri2"]:
        raise AssertionError(f"{tag}: the windows took {layouts}, not the "
                             "hoisted range-image layout")
    gn_total = int(torch.stack([r.iterations for r in s2m_runs]).sum())
    lookups, reassoc = _check_lookups(tag, launched["voxel_lookup_cat"],
                                      s2m_runs, gn_total)
    n_async = sum(len(b) for b in windows[1:])
    ms = _window_ms(rec)
    steady = ms[n_boot:]
    max_err, final_err, drift, path_len = _accuracy(lio.trajectory, data)
    res = {
        "scans": len(data), "window": WINDOW, "layouts": layouts,
        "windows": len(rec), "boot_windows": n_boot, "boot_s": boot_s,
        "async_wall_s": wall, "scans_per_s": n_async / wall,
        "window_ms": ms.tolist(),
        "window_ms_p50": float(np.percentile(steady, 50)),
        "window_ms_p99": float(np.percentile(steady, 99)),
        "launched": launched, "lookups": lookups, "reassociations": reassoc,
        "gn_iterations": gn_total, "loop_attempts": len(attempts),
        "loops_closed": int(lio.state.n_loop),
        "keyframes": int(lio.state.kf.count),
        "timings_s": dict(lio.timings),
        "max_err_m": max_err, "final_err_m": final_err,
        "drift_pct_per_m": drift, "path_len_m": path_len,
        "map_health": lio.map_health,
    }
    print(f"phase {tag}: LioSam {dev_name}, window={WINDOW}, {what}, over "
          f"{len(data)} scans x {N_SCAN}x{HORIZON}: the boot window and its "
          f"re-feed ({n_boot} windows) in {boot_s:.2f} s, then {n_async} "
          f"scans through process_window_async in {wall:.3f} s = "
          f"{res['scans_per_s']:.2f} scans/s; ms a window (device, between "
          f"events on the dispatching stream) p50 "
          f"{res['window_ms_p50']:.2f} p99 {res['window_ms_p99']:.2f} over "
          f"{len(steady)} windows; layouts {layouts}; launches {launched} "
          f"(B1 {lookups} lookups, {reassoc} re-associations, {gn_total} GN "
          f"iterations); {len(attempts)} loop attempts dispatched, "
          f"{res['loops_closed']} loops closed; {res['keyframes']} "
          f"keyframes; max err {max_err:.4f} m, final err {final_err:.4f} "
          f"m, drift {drift:.4f} %/m over {path_len:.1f} m; host seconds of "
          f"the async part {{"
          + ", ".join(f"{k}: {v:.3f}" for k, v in sorted(
              res["timings_s"].items())) + f"}} [{card}]", flush=True)
    if drift > DRIFT_GATE_PCT or final_err > FINAL_GATE_M:
        raise AssertionError(
            f"{tag}: accuracy gate: drift {drift:.4f} %/m (<= "
            f"{DRIFT_GATE_PCT}), final err {final_err:.4f} m (<= "
            f"{FINAL_GATE_M})")
    return res


def phase_window_vs_single(data, rec4a, card, dev_name="cuda"):
    """15c: W = 64 with ``quantized_upload=False`` and no grids (the window
    carries the scans' float32 rows) over 4a's drive, against 4a's W = 1
    drive booting on 64 scans: the keyframe poses and the trajectory bit
    for bit.  The windows after the boot but the last are timed (ms a
    window on the card, as in 15a); over the last the host syncs are
    counted (``torch.cuda.set_sync_debug_mode("warn")``): the window step's
    core, which every layout shares."""
    import dataclasses
    import warnings

    import torch

    from msst_torch.models.liosam import LioSam
    from msst_torch.ops import voxelmap

    p = dataclasses.replace(_params("voxel"), quantized_upload=False)
    lio = LioSam(p, device=dev_name, window=WINDOW)
    windows = _windows_of(data, WINDOW, grids=False)
    with _watched_windows(lio, dev_name) as rec:
        voxelmap.lookup_cat.launches = 0
        for b in windows[:-1]:
            lio.process_window(b)
        n_timed = len(rec) - 2          # the boot window and its re-feed
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if dev_name == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                lio.process_window(windows[-1])
            finally:
                if dev_name == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
        launches = voxelmap.lookup_cat.launches
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    n_counted = len(windows[-1])
    got = _record(lio)
    layouts = sorted({r["layout"] for r in rec})
    same = {k: bool(np.array_equal(got[k], rec4a[k]))
            for k in ("pose6", "traj")}
    ms = _window_ms(rec)[2:2 + n_timed]
    res = {"layouts": layouts, "same_as_4a": same,
           "keyframes": len(got["pose6"]), "launches": launches,
           "window_ms": ms.tolist(), "syncs": syncs,
           "syncs_per_scan": syncs / n_counted}
    print(f"phase 15c: LioSam {dev_name}, window={WINDOW}, "
          f"quantized_upload=False, no grids ({layouts}) over 4a's "
          f"{len(data)} scans: {res['keyframes']} keyframes, bit-identical "
          f"to 4a (W=1, boot {BOOT_SCANS}): {same}; {launches} B1 launches; "
          f"ms a window after the boot {np.round(ms, 2).tolist()}; {syncs} "
          f"host syncs over the last window's {n_counted} scans = "
          f"{res['syncs_per_scan']:.2f} a scan [{card}]", flush=True)
    if layouts != ["odometry_window_flat"] or not all(same.values()):
        raise AssertionError(f"15c: W={WINDOW} differs from 4a's W=1 drive "
                             f"({same}, layouts {layouts})")
    if launches == 0:
        raise AssertionError("15c: the window drive never launched B1")
    return res


def _lat_stats(proc_ms, window):
    """bench.py's scan-to-pose latency under live 10 Hz arrival: scan i of a
    window waits (W-1-i) scan periods for the window to fill, then the
    window's processing and pose readback."""
    lats = [(window - 1 - i) * SCAN_DT * 1000.0 + pm
            for pm in proc_ms for i in range(window)]
    return {"window": window,
            "proc_ms_p50": float(np.percentile(proc_ms, 50)),
            "proc_ms_p99": float(np.percentile(proc_ms, 99)),
            "scan_to_pose_ms_p50": float(np.percentile(lats, 50)),
            "scan_to_pose_ms_p99": float(np.percentile(lats, 99))}


def phase_live_latency(lat_data, card, dev_name="cuda"):
    """15d: bench.py's live latency windows (``_measure_latency``): W = 1
    over 96 windows and W = 4 over 24, seed 9, loop off, the grids
    attached, a readback interval too large to flush; each window's
    ``process_window`` timed to its poses on the host, the first max(2,
    8 // W + 2) windows (the boot and its re-feed) dropped."""
    from msst_torch.models.liosam import LioSam
    from msst_torch.ops import voxelmap

    out = {}
    for lw in LAT_WINDOWS:
        n_win = LAT_SCANS // lw
        lio = LioSam(_params("voxel"), device=dev_name, window=lw,
                     readback_interval=10 ** 9)
        drop = max(2, lio._boot_n // lw + 2)
        voxelmap.lookup_cat.launches = 0
        proc = []
        for w in range(n_win):
            batch = _window_dicts(lat_data[w * lw:(w + 1) * lw])
            t0 = time.perf_counter()
            outs = lio.process_window(batch)
            outs.pose6.cpu()     # the poses are on the host
            proc.append(1000.0 * (time.perf_counter() - t0))
        launches = voxelmap.lookup_cat.launches
        st = _lat_stats(proc[drop:], lw)
        st.update(launches=launches, dropped=drop, proc_ms=proc)
        out[f"w{lw}"] = st
        print(f"phase 15d: LioSam {dev_name}, live window={lw} over {n_win} "
              f"windows (first {drop} dropped): process_window to poses on "
              f"the host p50 {st['proc_ms_p50']:.2f} ms p99 "
              f"{st['proc_ms_p99']:.2f} ms; scan-to-pose at 10 Hz p50 "
              f"{st['scan_to_pose_ms_p50']:.2f} ms p99 "
              f"{st['scan_to_pose_ms_p99']:.2f} ms; {launches} B1 launches "
              f"[{card}]", flush=True)
        if launches == 0:
            raise AssertionError(f"15d: window={lw} never launched B1")
    return out


def phase_window(data, loop_data, lat_data, rec4a, card, dev_name="cuda"):
    """Phase 15: 15a bench.py's phase 1 at W = 64 (seed 7, 256 scans, loop
    off), 15b its loop phase (seed 8, 340 scans, loop on: a loop must
    close, B3 must launch), 15c W = 64 against 4a bit for bit, 15d the live
    latency windows."""
    t0 = time.perf_counter()
    res = {"15a": _window_drive("15a", "loop closure off",
                                _params("voxel"), data, card, dev_name)}
    res["15b"] = _window_drive("15b", "loop closure on",
                               _params("voxel", loop=True), loop_data, card,
                               dev_name)
    b = res["15b"]
    if b["loops_closed"] < 1 or b["launched"]["gather_rows"] == 0:
        raise AssertionError(f"15b: {b['loops_closed']} loops closed, "
                             f"{b['launched']['gather_rows']} B3 launches")
    res["15c"] = phase_window_vs_single(data, rec4a, card, dev_name)
    res["15d"] = phase_live_latency(lat_data, card, dev_name)
    res["s"] = time.perf_counter() - t0
    print(f"phase 15: {res['s']:.1f} s", flush=True)
    return res


def _build_kernels(names):
    """One nvcc per source, all started together; then load each library.
    Returns the seconds each build took (0 where it was already built)."""
    from msst_torch import kernels

    def build(name):
        t0 = time.perf_counter()
        cached = kernels.library_path(name).exists()
        kernels.build(name)
        return 0.0 if cached else time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(build, names)))
    for name in names:
        kernels.load(name)
    return secs


def _resource_usage(names):
    """Print and return each kernel's registers and spill bytes as ``nvcc
    -Xptxas -v`` reported them at the build."""
    from msst_torch import kernels

    usage = {name: kernels.resource_usage(name) for name in names}
    for name, fns in usage.items():
        print(f"        {name}.cu (ptxas): " + ("; ".join(
            f"{fn} {regs} registers, spills {st} B stored / {ld} B loaded"
            for fn, (regs, st, ld) in sorted(fns.items()))
            or "no report (built before this script)"), flush=True)
    return {name: {fn: list(v) for fn, v in fns.items()}
            for name, fns in usage.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the per-scan times and the result")
    args = ap.parse_args(argv)

    import torch

    import msst_torch  # noqa: F401  (absent -> fail before any line is printed)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = _card()
    print(f"phase 1: nvidia-smi '{card}'; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)}",
          flush=True)

    t_sim = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _main(args, card, t_start, t_sim, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _main(args, card, t_start, t_sim, workdir) -> int:
    import torch

    # the drives' scans are simulated, and phase 13a's KITTI drive written
    # under `workdir`, in worker processes (spawned: this process holds a
    # CUDA context) while the kernels build; the pool ends before anything
    # is timed
    with ProcessPoolExecutor(
            5, mp_context=multiprocessing.get_context("spawn")) as pool:
        bench_job = pool.submit(_simulate, N_SCANS, 7)
        loop_job = pool.submit(_simulate, N_LOOP_SCANS, 8)
        kitti_job = pool.submit(_write_kitti_drive,
                                os.path.join(workdir, "kitti"))
        lat_job = pool.submit(_simulate, LAT_SCANS, 9)
        # phase 14's sessions, 14b's (1800 columns) first
        ms_jobs = [pool.submit(_ms_session, j, horizon)
                   for horizon in (HORIZON, 360) for j in range(MS_SLOTS)]
        t0 = time.perf_counter()
        build_s = _build_kernels(["voxel_lookup", "knn_query", "gather_rows"])
        print("phase 2: built with nvcc, in parallel: "
              + ", ".join(f"{k} {v:.2f} s" if v else f"{k} (already built)"
                          for k, v in build_s.items())
              + f"; {time.perf_counter() - t0:.2f} s in all", flush=True)
        usage = _resource_usage(build_s)
        data, loop_data = bench_job.result(), loop_job.result()
        kitti = kitti_job.result()
        lat_data = lat_job.result()
        ms_scans = dict(job.result() for job in ms_jobs)
    print(f"        simulated {N_SCANS} + {N_LOOP_SCANS} + {LAT_SCANS} "
          f"scans, wrote "
          f"the {KITTI_SCANS}-sweep KITTI drive and simulated phase 14's "
          f"2 x {MS_SLOTS} sessions of {MS_SCANS} scans in "
          f"{time.perf_counter() - t_sim:.1f} s", flush=True)
    p = _params("knn")   # both methods share every size the kernels see
    feats, queries = _step_features(data, p, torch.device("cuda"))
    b1 = phase_voxel_lookup(feats, queries, p)
    b2 = phase_knn_query(feats, queries, p)
    del feats, queries
    calib_scene = _calib_scene()
    b2["calib_shapes"] = phase_knn_calib_shapes(calib_scene, usage)
    track_frames = _track_frames()
    b2["tracker_shape"] = phase_knn_tracker_shape(track_frames[0])
    b3 = phase_gather_rows(torch.device("cuda"))
    res = {"card": card, "build_s": build_s, "resource_usage": usage,
           "kernels": [b1, b2, b3]}
    records = {}
    res["voxel"] = phase_main_path("4a", "voxel", "voxel_lookup_cat", data,
                                   card, records)
    res["knn"] = phase_main_path("4b", "knn", "knn_query", data, card,
                                 records)
    res["loop"], loop_state = phase_loop_path(loop_data, card, records)
    res["graph"] = phase_graph_solvers(card)
    res["defaults"] = phase_defaults_path(loop_data, card)
    b1["launches"] = res["voxel"]["launches"]
    b2["launches"] = res["knn"]["launches"]
    b3["launches"] = res["loop"]["launched"]["gather_rows"]
    for method in ("voxel", "knn"):
        res[method].update(phase_cpu(method, data))
    res["loop"].update(phase_cpu_loop(loop_state, card))
    del loop_state
    res["repeat"] = phase_repeat(
        {"4a": (_params("voxel"), data), "4b": (_params("knn"), data),
         "4c": (_params("voxel", loop=True), loop_data)}, records, card)
    rec4a = records.pop("4a")   # phase 15c's reference
    del records
    res["eviction"] = {m: phase_eviction(m, data, card)
                       for m in ("voxel", "knn")}
    res["rebuild"] = {s: phase_rebuild(s, data, card)
                      for s in ("downsampled", "direct")}
    res["exact_features"] = phase_exact_features(data, card)
    res["demo"] = phase_demo(card)
    res["calibration"] = phase_calibration(calib_scene, card)
    res["calibration"]["11e"] = phase_calib_cli(calib_scene, card)
    b2["calibration_launches"] = {
        "11a": res["calibration"]["11a"]["launches"],
        "11b": res["calibration"]["11b"]["launches"],
        "11c": [f["launches"] for f in res["calibration"]["11c"]["frames"]]}
    print(f"phase 11: {res['calibration']['s']:.1f} s (11a-11d), 11e "
          f"{res['calibration']['11e']['s']:.1f} s", flush=True)
    res["estimators"] = phase_estimators(calib_scene, track_frames, card)
    b2["heading_launches"] = res["estimators"]["12a"]["launches"]
    b2["tracker_launches"] = res["estimators"]["12b"]["launches"]
    print(f"phase 12: {res['estimators']['s']:.1f} s", flush=True)
    t13 = time.perf_counter()
    lio13 = res["lio_kitti"] = phase_lio_kitti(kitti, workdir, card)
    cpu_job = lio13.pop("cpu_job")
    try:
        res["lio_bag"] = phase_lio_bag(data, workdir, card)
        lio13["cpu"] = phase_lio_cpu(cpu_job, card)
    finally:
        if cpu_job[0].poll() is None:
            cpu_job[0].kill()
            cpu_job[0].wait()
    res["decode_pcap"] = phase_decode_pcap(card, workdir)
    res["viewer"] = phase_viewer(lio13.pop("viz_dir"), card)
    b1["lio_kitti_launches"] = lio13["launches"]
    b1["lio_kitti_gn_iterations"] = lio13["gn_iterations"]
    b1["lio_bag_launches"] = res["lio_bag"]["launches"]
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    t14 = time.perf_counter()
    res["multisession"] = phase_multisession(ms_scans, card)
    del ms_scans
    res["multisession"]["14c"] = phase_grid_icp(calib_scene, card)
    for tag in ("14a", "14b"):
        r = res["multisession"][tag]
        feeds = r["feeds"]
        b1[f"multisession_{tag}_launches"] = {
            "aligned": [f["record"]["launches"]["B1"] for f in feeds],
            "control": r["control_record"]["launches"]["B1"]}
        b3[f"multisession_{tag}_launches"] = [
            f["record"]["launches"]["B3"] for f in feeds]
    b3["multisession_14b_selective_launches"] = (
        res["multisession"]["14b"]["merge"]["selective_B3"])
    b2["grid_icp_launches"] = res["multisession"]["14c"]["launches"]
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
    res["window"] = phase_window(data, loop_data, lat_data, rec4a, card)
    del loop_data, lat_data, rec4a
    b1["window_15a_launches"] = res["window"]["15a"]["launched"][
        "voxel_lookup_cat"]
    b1["window_15b_launches"] = res["window"]["15b"]["launched"][
        "voxel_lookup_cat"]
    b3["window_15b_launches"] = res["window"]["15b"]["launched"][
        "gather_rows"]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(res, f, indent=1)

    print(f"done: every phase passed, {time.perf_counter() - t_start:.1f} s "
          "in all", flush=True)
    print(json.dumps({"kernels": [b1, b2, b3]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
