#!/usr/bin/env python3
"""Drive the port's (msst_torch) bench drives twice on one GPU, for any
checkout, and report how far the two drives of the same input lie apart;
optionally time the segment sums at the shapes those drives give them.

    python3 scripts/torch_repeat.py [--tree DIR] [--cells 4a,4b,4c]
                                    [--segsum] [--out DIR]

``--tree`` names the checkout whose ``msst_torch`` is imported (default: the
one this script lies in), so that two versions of the port can be measured
in turns on one card.  The drives, their records and the comparison are
this checkout's ``chip_smoke.py``'s: 4a (voxel) and 4b (knn) over the
256-scan bench drive, 4c (voxel, loop closure on) over bench.py's loop-on
drive, compared as phase 6 compares them (keyframe counts, loop events,
largest keyframe-pose and trajectory gaps, bit-identical or not).

``--segsum`` records the distinct inputs ``segments.segment_sum`` gets over
100 scans of 4a and 4b, then times it on each (CUDA events over 100 calls,
and its device time from torch.profiler), with the calls per steady scan.
One JSON object per part is printed and written to --out.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEGSUM_SCANS = 100


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever tree msst_torch comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(cs, cells):
    """tag -> (params, data) of the drives asked for."""
    bench = loop = None
    out = {}
    for tag in cells:
        if tag == "4c":
            loop = loop or cs._simulate(cs.N_LOOP_SCANS, 8)
            out[tag] = (cs._params("voxel", loop=True), loop)
        else:
            bench = bench or cs._simulate(cs.N_SCANS, 7)
            out[tag] = (cs._params("knn" if tag == "4b" else "voxel"), bench)
    return out


def segsum(cs, card):
    """segment_sum's distinct inputs over SEGSUM_SCANS scans of 4a and 4b,
    each timed on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msst_torch.models.liosam import LioSam
    from msst_torch.ops import segments

    fn = segments.segment_sum
    data = cs._simulate(SEGSUM_SCANS, 7)
    res = {"card": card, "cells": {}}
    for method in ("voxel", "knn"):
        seen: dict = {}
        steady = [False]

        def recording(vals, seg, num_segments):
            key = (tuple(vals.shape), num_segments)
            if key not in seen:
                seen[key] = {"args": (vals.clone(), seg.clone(), num_segments),
                             "calls": 0}
            if steady[0]:
                seen[key]["calls"] += 1
            return fn(vals, seg, num_segments)

        segments.segment_sum = recording
        try:
            lio = LioSam(cs._params(method), device="cuda",
                         boot_scans=cs.BOOT_SCANS)
            for i, s in enumerate(data):
                steady[0] = i > cs.BOOT_SCANS
                cs._feed(lio, s)
            torch.cuda.synchronize()
        finally:
            segments.segment_sum = fn
        n_steady = SEGSUM_SCANS - cs.BOOT_SCANS - 1
        rows = []
        for (shape, nseg), rec in sorted(seen.items()):
            args = rec["args"]
            ms = cs._cuda_ms(lambda: fn(*args))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn(*args)
                torch.cuda.synchronize()
            dev_ms = sum(ev.self_device_time_total
                         for ev in prof.key_averages()) / 1000.0 / 20
            rows.append({"shape": list(shape), "num_segments": nseg,
                         "calls_per_steady_scan": rec["calls"] / n_steady,
                         "ms": ms, "device_ms": dev_ms})
        res["cells"][method] = {
            "inputs": rows,
            "ms_per_steady_scan": sum(r["ms"] * r["calls_per_steady_scan"]
                                      for r in rows),
            "device_ms_per_steady_scan": sum(
                r["device_ms"] * r["calls_per_steady_scan"] for r in rows)}
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--cells", default="4a,4b,4c")
    ap.add_argument("--segsum", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    import msst_torch

    if not torch.cuda.is_available():
        print("torch_repeat: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    card = cs._card()
    tree = str(Path(msst_torch.__file__).parent)
    print(f"msst_torch from {tree}; [{card}]", flush=True)
    res = {"tree": tree, "card": card, "repeat": {}}
    cells = [c for c in args.cells.split(",") if c]
    for tag, (params, data) in _cases(cs, cells).items():
        gaps = cs._repeat_gaps(cs._drive_record(params, data),
                               cs._drive_record(params, data))
        res["repeat"][tag] = gaps
        print(json.dumps({"cell": tag, "card": card, **gaps}), flush=True)
    if args.segsum:
        res["segsum"] = segsum(cs, card)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = f"torch_repeat_{Path(args.tree).resolve().name}.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
