"""Run one cell of the benchmark once on the card.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
its limit), and the same numbers as the last lines of standard error.
Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, where the port cannot be imported from this
checkout, where ``jax``, ``jaxlib``, ``flax`` or ``msst_tpu`` was loaded, or,
with ``--trace 1``, where the program lacks an entry point that the spans
read (``missing_spans``, empty in every printed result).  Every process
the run starts has ended, and been waited for, before it exits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "msst_tpu")


def forbidden_modules(names=FORBIDDEN) -> list:
    """Loaded modules whose top-level name is one of `names`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in names})


def _cache_dirs(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    cache = root / "slambench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _finite(x):
    """`x` with every float that is not finite replaced by None, so that the
    line is strict JSON (stderr prints the value as it is)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def _card(torch) -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    """One run; on every way out, every process it started has ended."""
    from .drive import stop_children

    try:
        return _run(argv)
    finally:
        killed = stop_children()
        if killed:
            print(f"slambench: killed leftover processes {killed}",
                  file=sys.stderr)


def _run(argv) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("slambench: no CUDA device", file=sys.stderr)
        return 2
    from .cell import load_cell, load_json, run_cell

    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(ROOT, manifest, args.workload)
    chips = int(cell["workload"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import msst_torch

    where = Path(msst_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"slambench: msst_torch loads from {where}, outside the "
              f"checkout {ROOT}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = _card(torch)

    from .spans import MissingTargets

    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, t_start)
    except MissingTargets as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"slambench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    tr = res.pop("_trace")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": res.pop("_mem_peak"),
           "card": card}
    if tr is not None:
        dev["busy_s"] = tr["profile"]["busy_s"]
        dev["window_s"] = tr["window_s"]
        breakdown = {"device_ops": tr["profile"]["device_ops"],
                     "idle_gaps": tr["profile"]["idle_gaps"]}
    else:
        breakdown = None
    checks = res.pop("checks")
    out = {k: res[k] for k in ("correct", "attempted", "failed", "metrics")}
    out["device"] = dev
    if breakdown is not None:
        out["breakdown"] = breakdown
    if tr is not None:
        out["missing_spans"] = tr["missing_spans"]
    out["gates"] = res["gates"]
    out["drive"] = res["drive"]
    out["checks"] = checks
    for name, c in res["gates"].items():
        if isinstance(c, dict):
            print(f"gate {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(out), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
