#!/usr/bin/env python3
"""chip_smoke.py's phase 15 alone on one card: windowed dispatch at
bench.py's W = 64 protocol (15a loop off, 15b loop on, both async after the
boot window, the range-image uploads), W = 64 against the W = 1 drive of
phase 4a bit for bit (15c, so 4a runs first), and the live latency windows
1 and 4 (15d).

    python3 scripts/torch_window_chip.py [--turns N]

It builds the three kernels, simulates the drives in a worker pool, and
runs ``chip_smoke.phase_main_path`` (4a) and ``chip_smoke.phase_window`` as
chip_smoke.py does, with every gate.  Needs a CUDA device.

``--turns N`` runs, instead of the phases, N turns of the bench drive at
W = 1 (``process_scan``, the pose read back each scan, 64-scan boot) and
at W = 64 (``process_window``, float32 rows, so the same computation bit
for bit; and with the range-image grids), in the order W = 1, W = 64,
W = 64 grids, then reversed, and prints each drive's ms a scan over the
scans after the boot window (to the end of the device work of the last
one) and its scans/s: the window path's own cost, measured in one process
at one time.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def _turn(kind, data, card):
    """One drive of the bench drive: ms a scan over scans 64+ (W = 1: the
    sum of each process_scan with its pose on the host; W = 64: the
    windows after the boot, synchronised at the end)."""
    import dataclasses

    import numpy as np
    import torch

    from msst_torch.models.liosam import LioSam

    p = cs._params("voxel")
    if kind == "w1":
        lio = LioSam(p, device="cuda", boot_scans=cs.BOOT_SCANS)
        ms = []
        for s in data:
            t0 = time.perf_counter()
            cs._feed(lio, s).pose_matrix.cpu()
            ms.append(1000.0 * (time.perf_counter() - t0))
        steady = float(np.sum(ms[cs.BOOT_SCANS:]))
    else:
        grids = kind == "w64_grids"
        if not grids:
            p = dataclasses.replace(p, quantized_upload=False)
        lio = LioSam(p, device="cuda", window=cs.WINDOW)
        windows = cs._windows_of(data, cs.WINDOW, grids=grids)
        lio.process_window(windows[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in windows[1:]:
            lio.process_window(b)
        torch.cuda.synchronize()
        steady = 1000.0 * (time.perf_counter() - t0)
    n = len(data) - cs.WINDOW
    traj = lio.trajectory.as_matrices()
    err = float(np.linalg.norm(traj[-1, :3, 3] - (
        data[-1]["gt_pose"][:3, 3] - data[0]["gt_pose"][:3, 3])))
    print(f"turn {kind}: {steady / n:.2f} ms a scan over scans "
          f"{cs.WINDOW}+ ({n / steady * 1000.0:.2f} scans/s); final err "
          f"{err:.4f} m [{card}]", flush=True)
    return steady / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_window_chip: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs._card()
    with ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(cs._simulate, n, seed) for n, seed in (
            (cs.N_SCANS, 7), (cs.N_LOOP_SCANS, 8), (cs.LAT_SCANS, 9))]
        cs._build_kernels(["voxel_lookup", "knn_query", "gather_rows"])
        data, loop_data, lat_data = (job.result() for job in jobs)
    print(f"built and simulated in {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    if args.turns:
        order = ["w1", "w64", "w64_grids"]
        for i in range(args.turns):
            for kind in (order if i % 2 == 0 else order[::-1]):
                _turn(kind, data, card)
        print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    records = {}
    cs.phase_main_path("4a", "voxel", "voxel_lookup_cat", data, card,
                       records)
    cs.phase_window(data, loop_data, lat_data, records["4a"], card)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
