"""Run cells of the benchmark one after another, each in its own process,
and keep every run's result line with its exit code, wall time and the end
of its standard error.

    python3 slambench/tools/series.py --out FILE.jsonl \\
        CELL:SEED:SECONDS:TRACE [CELL:SEED:SECONDS:TRACE ...]

From the root of a checkout; one JSON object per run is appended to FILE
and printed.  ``python3 slambench/tools/series.py --spread FILE.jsonl``
prints each cell's medians and quartile spreads of every metric
(``statistics.quantiles(values, n=4)``, the spread as a share of the
median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_one(spec: str, timeout: float) -> dict:
    cell, seed, seconds, trace = spec.split(":")
    cmd = [sys.executable, "-m", "slambench.run", "--workload", cell,
           "--seed", seed, "--seconds", seconds, "--trace", trace]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        err = err if isinstance(err, str) else err.decode(errors="replace")
    rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds),
           "trace": int(trace), "rc": rc,
           "wall_s": time.perf_counter() - t0, "err_tail": err[-3000:]}
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if lines:
        try:
            rec["result"] = json.loads(lines[-1])
        except json.JSONDecodeError:
            rec["result_raw"] = lines[-1][-2000:]
    return rec


def spread(path: str) -> None:
    by: dict = {}
    for ln in open(path):
        rec = json.loads(ln)
        res = rec.get("result")
        if not res:
            continue
        key = (rec["cell"], rec["trace"])
        for name, m in res["metrics"].items():
            by.setdefault(key, {}).setdefault(name, []).append(m["value"])
    for (cell, trace), metrics in sorted(by.items()):
        for name, vals in sorted(metrics.items()):
            med = statistics.median(vals)
            if len(vals) >= 2:
                q = statistics.quantiles(vals, n=4)
                sp = (q[2] - q[0]) / med if med else float("nan")
            else:
                sp = float("nan")
            print(f"{cell} trace={trace} {name}: n={len(vals)} "
                  f"median={med!r} spread={sp!r} values={vals!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=float, default=1200.0)
    ap.add_argument("--spread")
    ap.add_argument("runs", nargs="*")
    args = ap.parse_args(argv)
    if args.spread:
        spread(args.spread)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for spec in args.runs:
        rec = run_one(spec, args.timeout)
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
