#!/usr/bin/env python3
"""chip_smoke.py's phase 14 alone on one card: multi-session mapping (14a
at ``drive_params()``, 14b at bench.py's profile, both merges of 14b's
final states) and the grid ICP (14c).

    python3 scripts/torch_multisession_chip.py

It builds the three kernels, simulates the 2 x 8 sessions in a worker
pool, and runs ``chip_smoke.phase_multisession`` and
``chip_smoke.phase_grid_icp`` as chip_smoke.py does, with every gate.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_multisession_chip: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs._card()
    with ProcessPoolExecutor(
            6, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(cs._ms_session, j, h)
                for h in (cs.HORIZON, 360) for j in range(cs.MS_SLOTS)]
        cs._build_kernels(["voxel_lookup", "knn_query", "gather_rows"])
        cache = dict(job.result() for job in jobs)
    print(f"built and simulated in {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    out = cs.phase_multisession(cache, card)
    out["14c"] = cs.phase_grid_icp(cs._calib_scene(), card)
    print(json.dumps({tag: {"aligned": [(f["feed"], f["aligned"])
                                        for f in out[tag]["feeds"]],
                            "control": out[tag]["control"]}
                      for tag in ("14a", "14b")}))
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
