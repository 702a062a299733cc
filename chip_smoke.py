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
   one ``query_cat`` with n_a = 333; B3, the row gather (3c), at
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
Each of 6-10 drives the card and fails the run when its check fails.

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
import subprocess
import sys
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


def _knn_equal(label, grid_a, grid_b, q, qm, n_a, k, cand):
    """knn.query_cat (the kernel) against query_cat_plain on the card: every
    slot of idx, valid and sqdist bit-equal.  With grid_b None (and n_a
    None), knn.query against query_plain on grid_a.  Returns (result,
    max_abs_err)."""
    import torch

    from msst_torch.ops import knn

    if grid_b is None:
        got = knn.query(grid_a, q, qm, k=k, candidates_per_cell=cand)
        want = knn.query_plain(grid_a, q, qm, k=k, candidates_per_cell=cand)
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
    inner, gn_runs = getattr(registration, entry), []

    def counted(*args, **kwargs):
        out = inner(*args, **kwargs)
        gn_runs.append(out.iterations)
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
    if (launches != gn_total) if method == "knn" else (launches > gn_total):
        raise AssertionError(f"{launches} {kernel} launches for {gn_total} "
                             f"Gauss-Newton iterations ({method})")
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
        "gn_iterations": gn_total,
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

    # both drives' scans are simulated in worker processes (spawned: this
    # process holds a CUDA context) while the kernels build; the pool ends
    # before anything is timed
    t_sim = time.perf_counter()
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        bench_job = pool.submit(_simulate, N_SCANS, 7)
        loop_job = pool.submit(_simulate, N_LOOP_SCANS, 8)
        t0 = time.perf_counter()
        build_s = _build_kernels(["voxel_lookup", "knn_query", "gather_rows"])
        print("phase 2: built with nvcc, in parallel: "
              + ", ".join(f"{k} {v:.2f} s" if v else f"{k} (already built)"
                          for k, v in build_s.items())
              + f"; {time.perf_counter() - t0:.2f} s in all", flush=True)
        usage = _resource_usage(build_s)
        data, loop_data = bench_job.result(), loop_job.result()
    print(f"        simulated {N_SCANS} + {N_LOOP_SCANS} scans in "
          f"{time.perf_counter() - t_sim:.1f} s", flush=True)
    p = _params("knn")   # both methods share every size the kernels see
    feats, queries = _step_features(data, p, torch.device("cuda"))
    b1 = phase_voxel_lookup(feats, queries, p)
    b2 = phase_knn_query(feats, queries, p)
    del feats, queries
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
    del loop_data, records
    res["eviction"] = {m: phase_eviction(m, data, card)
                       for m in ("voxel", "knn")}
    res["rebuild"] = {s: phase_rebuild(s, data, card)
                      for s in ("downsampled", "direct")}
    res["exact_features"] = phase_exact_features(data, card)
    res["demo"] = phase_demo(card)
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
