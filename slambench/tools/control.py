"""The control of ``correct``: the reference put in the program's place and
computed one precision below the configuration's (float32 with TF32 on
for every matmul, where the configuration states TF32 off), against the
reference itself, at each cell's own size.  Every number it gives has to
exceed the cell's limit in at least one of them for the comparison to mean
anything.

    python3 slambench/tools/control.py --cells CELL[,CELL] \\
        --seeds N[,N] [--out FILE.jsonl]

From the root of a checkout, on the card.  One JSON object per cell and
seed: the numbers that ``compare.gaps`` gives for the control, each beside
the cell's limit, and the seconds each reference drive took.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control(cell: dict, seed: int, device) -> dict:
    from slambench import compare
    from slambench.cell import setup_scans
    from slambench.drive import Drive

    t = cell["traffic"]
    n_cmp = int(t["compare_scans"])
    W = t["window"]
    drive = Drive(cell["config"], setup_scans(cell) + n_cmp, seed,
                  points=W == 1, grids=W > 1, workers=t.get("workers"))
    t0 = time.perf_counter()
    ref, ref_snap = compare.reference_run(cell, drive, n_cmp, device)
    t1 = time.perf_counter()
    ctl, ctl_snap = compare.reference_run(cell, drive, n_cmp, device,
                                          tf32=True)
    t2 = time.perf_counter()
    if t.get("async"):
        ref_snap = ctl_snap = {}
    numbers = compare.gaps(ctl, ref, ctl_snap, ref_snap)
    limits = cell["limits"]
    return {"cell": cell["name"], "seed": seed, "compared_scans": n_cmp,
            "numbers": {k: {"value": v, "limit": limits.get(k)}
                        for k, v in numbers.items()},
            "fails": any(v > limits[k] for k, v in numbers.items()),
            "reference_s": t1 - t0, "control_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, str(ROOT))
    from slambench.cell import load_cell, load_json

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = load_json(ROOT / "BENCHMARK.json")
    for name in args.cells.split(","):
        cell = load_cell(ROOT, manifest, name)
        for seed in args.seeds.split(","):
            rec = control(cell, int(seed), device)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
