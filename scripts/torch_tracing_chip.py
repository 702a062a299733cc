"""The program's tracer on the card, over the benchmark's cells.

    python3 scripts/torch_tracing_chip.py env
    python3 scripts/torch_tracing_chip.py layers --cell vlp16-replay \\
        --seed N [--seconds 51] [--scans 64] [--out DIR]
    python3 scripts/torch_tracing_chip.py cost --cell hdl64-live \\
        --seeds A,B,C [--seconds 51] [--out DIR]

``env``: torch's version and what its profiler offers (the global flag the
tracer reads, recording every thread), and a short drive on the card with
the tracer on: device intervals, the profiler's ranges on the tracer's
clock.

``layers``: one cell set up as ``slambench.run`` sets it up, half a window
untraced, then `--scans` scans (default the cell's ``profile_scans``) under
``torch.profiler`` (every thread where torch can) with the tracer on.
Prints one JSON object: per span the calls and host and device ms a scan
and their self ms; the new metrics as the benchmark reads them; explicit
reads by site; every host synchronisation the profiler saw, split into
those inside an explicit read and the rest (the implicit ones), the ten
largest of those by the innermost program span and aten op around them;
the device's idle time and the share of it inside some program span, by
the innermost span; for loop attempts each stage's share of an attempt;
for keyframes each child's share.

``cost``: for each seed, the cell's drive once and two sessions over it,
one whole window with the tracer off and one with it on (the order
alternates by seed), each window's end-to-end metrics as the benchmark
reads them.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _emit(obj, out, name):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, name), "w") as f:
            json.dump(obj, f, indent=1)


# -- env --------------------------------------------------------------------


def cmd_env(args):
    import torch
    import torch.autograd.profiler as tap
    from torch.profiler import ProfilerActivity, profile

    from msst_torch.models.liosam import LioSam
    from msst_torch.models.liosam.params import tiny_params
    from msst_torch.utils import profiling, sim

    res = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "card": _card(),
           "global_flag": hasattr(tap, "_is_profiler_enabled"),
           "all_threads": profiling._all_threads_config() is not None}
    data = sim.make_dataset(sim.World(), sim.SimTrajectory(kind="circle"),
                            n_scans=24, scan_dt=0.1, n_scan=16, horizon=360,
                            seed=2)
    keys = ("xyz", "ring", "time_rel", "scan_start", "imu_t", "imu_gyro",
            "imu_acc", "imu_rpy")
    lio = LioSam(tiny_params(), device="cuda")
    for s in data[:12]:
        lio.process_scan(**{k: s[k] for k in keys})
    lio.flush()
    profiling.drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in data[12:]:
            lio.process_scan(**{k: s[k] for k in keys})
        lio.flush()
    lg = profiling.drain()
    res["spans"] = len(lg["spans"])
    res["with_device_interval"] = sum(r["d0"] is not None
                                      for r in lg["spans"])
    start = prof.profiler.kineto_results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    res["ranges_on_device_line"] = sum(
        e.name.startswith("msst/") and e.device_type == cuda
        for e in prof.events())
    evs = sorted((e for e in prof.events() if e.name == "msst/gn_iter"
                  and e.device_type != cuda),
                 key=lambda e: e.time_range.start)
    mine = [r for r in lg["spans"] if r["name"] == "gn_iter"]
    res["gn_iter_ranges"] = [len(evs), len(mine)]
    if evs and len(evs) == len(mine):
        res["clock_gap_us"] = max(
            max(abs(start + e.time_range.start * 1000 - r["t0"]),
                abs(start + e.time_range.end * 1000 - r["t1"])) / 1e3
            for e, r in zip(evs, mine))
    dev = sorted(((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == cuda and not e.name.startswith("msst/")))
    if dev and mine:
        # the device intervals against the profiler's kernels: how far the
        # first gn_iter's device start lies from the nearest kernel start
        d0 = (mine[0]["d0"] - start) / 1e3
        res["gn_iter_device_vs_kernels_us"] = min(abs(s - d0)
                                                  for s, _ in dev)
        res["gn_iter_device_ms"] = [round((r["d1"] - r["d0"]) / 1e6, 4)
                                    for r in mine[:6]]
        res["gn_iter_host_ms"] = [round((r["t1"] - r["t0"]) / 1e6, 4)
                                  for r in mine[:6]]
    res["host_reads"] = profiling.host_reads(lg)
    # a span's host cost: an empty span around one small kernel, off and on
    x = torch.ones(1000, device="cuda")

    def per_call(body, n=20000):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            body()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    def spanned():
        with profiling.span("x"):
            x.add_(1)

    bare = per_call(lambda: x.add_(1))
    res["span_us_off"] = per_call(spanned) - bare
    with profiling.tracing():
        res["span_us_on"] = per_call(spanned) - bare
    profiling.drain()
    _emit(res, args.out, "tracing_env.json")
    return 0


# -- set-up as slambench.run sets a cell up ----------------------------------


def _setup(args, seed):
    import torch

    from slambench import cell as C
    from slambench.drive import Drive

    root = Path(args.root)
    seconds = args.seconds
    manifest = C.load_json(root / "BENCHMARK.json")
    cell = C.load_cell(root, manifest, args.cell)
    t = cell["traffic"]
    W = t["window"]
    n_setup = C.setup_scans(cell)
    if t["mode"] == "live":
        n_drive = n_setup + int(round(seconds * t["rate_hz"])) + 1
    else:
        n_drive = n_setup + int(-(-seconds * t["drive_scans_per_s"] // 1))
        n_drive = n_setup + -(-(n_drive - n_setup) // W) * W
    drive = Drive(cell["config"], n_drive, seed, points=W == 1, grids=W > 1,
                  workers=t.get("workers"))
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    return C, cell, drive, device


def _session(C, cell, drive, device):
    import torch

    import msst_torch.models.liosam as prog
    from msst_torch.models.liosam import loop as prog_loop

    def make():
        lio = C.make_lio(prog, cell, device)
        C.feed_setup(lio, drive, cell)
        return lio

    session = C.Session(make)
    if cell["traffic"].get("warm_loop"):
        C.warm_loop(session.lio, prog_loop)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return session


def _e2e(C, cell, rec):
    run = {"window": rec, "trace": None, "setup_s": 0.0}
    out = {}
    for m in cell["end_to_end"]:
        if m["name"] == "setup_s":
            continue
        v = C.metric_reader(cell["root"], m["name"])(run)
        if v is not None:
            out[m["name"]] = v
    return out


# -- layers -----------------------------------------------------------------


def _sweep_ancestors(events):
    """For each event of `events` (name, tid, start, end), the list of
    events enclosing it on its thread, outermost first (a stack sweep)."""
    by_tid: dict = {}
    for i, e in enumerate(events):
        by_tid.setdefault(e[1], []).append(i)
    up = [None] * len(events)
    for ids in by_tid.values():
        ids.sort(key=lambda i: (events[i][2], -events[i][3]))
        stack: list = []
        for i in ids:
            s, e = events[i][2], events[i][3]
            while stack and events[stack[-1]][3] <= s:
                stack.pop()
            up[i] = list(stack)
            stack.append(i)
    return up


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle_in_spans(dev_iv, spans, t_lo, t_hi):
    """Device idle time between t_lo and t_hi (ns) and its part inside some
    program span's host interval, by the innermost span open at each idle
    stretch (split at span edges)."""
    busy = _merge([(max(s, t_lo), min(e, t_hi)) for s, e in dev_iv
                   if e > t_lo and s < t_hi])
    gaps, cur = [], t_lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t_hi:
        gaps.append((cur, t_hi))
    idle = sum(e - s for s, e in gaps)
    # span edges cut the gaps into pieces, each named by its innermost span
    # (the latest-starting span open over the whole piece)
    edges = sorted({x for r in spans for x in (r["t0"], r["t1"])})
    by_name: dict = {}
    inside = 0
    ordered = sorted(spans, key=lambda r: r["t0"])
    starts = [r["t0"] for r in ordered]
    for gs, ge in gaps:
        cuts = [gs] + [x for x in edges[bisect.bisect_right(edges, gs):
                                        bisect.bisect_left(edges, ge)]] + [ge]
        for a, b in zip(cuts, cuts[1:]):
            if b <= a:
                continue
            mid = (a + b) / 2
            j = bisect.bisect_right(starts, mid)
            best = None
            for r in reversed(ordered[max(0, j - 400):j]):
                if r["t1"] > mid:
                    best = r
                    break
            if best is None:
                continue
            inside += b - a
            by_name[best["name"]] = by_name.get(best["name"], 0) + (b - a)
    return idle, inside, by_name


def cmd_layers(args):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msst_torch.utils import profiling

    C, cell, drive, device = _setup(args, args.seed)
    session = _session(C, cell, drive, device)
    t = cell["traffic"]
    run = C.WINDOWS[t["mode"]]
    clock = time.perf_counter
    n_setup = C.setup_scans(cell)
    rec_a = run(session, drive, cell, n_setup, args.seconds / 2, clock,
                lambda *a: None)
    start_b = rec_a.get("next", n_setup + rec_a["attempted"])
    scans = args.scans or t["profile_scans"]
    cfg = profiling._all_threads_config()
    kw = {"experimental_config": cfg} if cfg is not None else {}
    profiling.drain()
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, **kw) as prof:
        rec_b = run(session, drive, cell, start_b, args.seconds / 2, clock,
                    lambda *a: None, max_scans=scans)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    n = rec_b["attempted"]
    # the new metrics as the benchmark reads them, from the kept log
    runrec = {"trace": {"prof_scans": n}}
    metrics = {m: C.metric_reader(cell["root"], m)(runrec)
               for m in ("gn_iter_ms", "host_reads_per_scan")}
    lg = profiling.drain()
    base = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    host, dev_iv = [], []
    for e in events:
        s, en = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith("msst/"):
                continue      # a range's user annotation, not device work
            dev_iv.append((base + int(s * 1000), base + int(en * 1000)))
        else:
            host.append((e.name, e.thread, s, en))
    up = _sweep_ancestors(host)
    explicit, implicit = 0, {}
    n_sync = 0
    for i, (name, _, _, _) in enumerate(host):
        if name not in SYNC_CALLS:
            continue
        n_sync += 1
        names = [host[j][0] for j in up[i]]
        if any(x.startswith("msst/read:") for x in names):
            explicit += 1
            continue
        span = next((x for x in reversed(names) if x.startswith("msst/")),
                    "(no span)")
        op = next((x for x in reversed(names) if x.startswith("aten::")),
                  "(no aten op)")
        k = f"{span} | {op}"
        implicit[k] = implicit.get(k, 0) + 1
    summ = profiling.summary(lg)
    res = {"cell": args.cell, "seed": args.seed, "card": _card(),
           "torch": torch.__version__, "all_threads": cfg is not None,
           "profiled_scans": n, "window_s": rec_b["t_end"] - rec_b["t0"],
           "spans_per_scan": {
               k: {"calls": v["calls"] / n, "host_ms": v["host_ms"] / n,
                   "self_host_ms": v["self_host_ms"] / n,
                   "device_ms": v["device_ms"] / n,
                   "self_device_ms": v["self_device_ms"] / n}
               for k, v in sorted(summ.items())},
           "metrics": metrics,
           "reads_by_site_per_scan": {k: c / n for k, c in sorted(
               profiling.host_reads(lg).items(), key=lambda kv: -kv[1])},
           "counters": {k: profiling.counter_total(lg, k) for k in (
               "gn_iters", "b1_lookups", "icp_iters", "keyframes",
               "graph_solves", "graph_gn_iters", "loop_closures")},
           "graph_solve_iters": [r["args"]["iters"] for r in lg["spans"]
                                 if r["name"] == "graph_solve"],
           "syncs_per_scan": n_sync / n,
           "explicit_syncs_per_scan": explicit / n,
           "implicit_syncs_per_scan": (n_sync - explicit) / n,
           "implicit_top10_per_scan": [
               [k, c / n] for k, c in sorted(implicit.items(),
                                             key=lambda kv: -kv[1])[:10]]}
    closed = [r for r in lg["spans"] if r["t1"] is not None]
    if closed:
        t_lo = min(r["t0"] for r in closed)
        t_hi = max(r["t1"] for r in closed)
        idle, inside, by_name = _idle_in_spans(dev_iv, closed, t_lo, t_hi)
        res["idle_s"] = idle / 1e9
        res["idle_inside_span_share"] = inside / idle if idle else None
        res["idle_by_innermost_span_s"] = {
            k: v / 1e9 for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:12]}
        res["span_window_s"] = (t_hi - t_lo) / 1e9
    index = profiling.by_index(lg["spans"])

    def children_shares(parent_name):
        out, totals = {}, {"host": 0.0, "device": 0.0}
        for r in closed:
            if r["name"] != parent_name:
                continue
            totals["host"] += r["t1"] - r["t0"]
            if r["d0"] is not None:
                totals["device"] += r["d1"] - r["d0"]
        for r in closed:
            p = r["parent"]
            if p is None or index[p]["name"] != parent_name:
                continue
            e = out.setdefault(r["name"], {"host": 0.0, "device": 0.0,
                                           "calls": 0})
            e["calls"] += 1
            e["host"] += r["t1"] - r["t0"]
            if r["d0"] is not None:
                e["device"] += r["d1"] - r["d0"]
        return {k: {"calls": v["calls"],
                    "host_share": v["host"] / totals["host"]
                    if totals["host"] else None,
                    "device_share": v["device"] / totals["device"]
                    if totals["device"] else None,
                    "host_ms": v["host"] / 1e6}
                for k, v in out.items()}, {k: v / 1e6
                                           for k, v in totals.items()}

    for parent in ("loop_attempt", "keyframe"):
        shares, tot = children_shares(parent)
        if shares:
            res[f"{parent}_children"] = shares
            res[f"{parent}_total_ms"] = tot
    res["loop_attempts"] = [
        dict(r["args"], scan=r["scans"][0], host_ms=(r["t1"] - r["t0"]) / 1e6,
             device_ms=((r["d1"] - r["d0"]) / 1e6
                        if r["d0"] is not None else None))
        for r in closed if r["name"] == "loop_attempt"]
    _emit(res, args.out, f"layers_{args.cell}.json")
    return 0


# -- cost -------------------------------------------------------------------


def cmd_cost(args):
    import torch

    from msst_torch.utils import profiling

    C, cell, _, device = None, None, None, None
    rows = []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        C, cell, drive, device = _setup(args, seed)
        order = ("off", "on") if k % 2 == 0 else ("on", "off")
        for mode in order:
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            session = _session(C, cell, drive, device)
            ctx = (profiling.tracing() if mode == "on"
                   else contextlib.nullcontext())
            run = C.WINDOWS[cell["traffic"]["mode"]]
            with ctx:
                rec = run(session, drive, cell, C.setup_scans(cell),
                          args.seconds, time.perf_counter, lambda *a: None)
            spans = len(profiling.drain()["spans"])
            row = {"seed": seed, "mode": mode, "spans": spans,
                   "attempted": rec["attempted"]}
            row.update(_e2e(C, cell, rec))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del session, rec
        del drive
    _emit({"cell": args.cell, "card": _card(), "torch": torch.__version__,
           "rows": rows}, args.out, f"cost_{args.cell}.json")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("env")
    s.add_argument("--out", default=None)
    s = sub.add_parser("layers")
    s.add_argument("--root", default=str(ROOT))
    s.add_argument("--device", default="cuda")
    s.add_argument("--cell", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--seconds", type=float, default=51.0)
    s.add_argument("--scans", type=int, default=0)
    s.add_argument("--out", default=None)
    s = sub.add_parser("cost")
    s.add_argument("--root", default=str(ROOT))
    s.add_argument("--device", default="cuda")
    s.add_argument("--cell", required=True)
    s.add_argument("--seeds", required=True)
    s.add_argument("--seconds", type=float, default=51.0)
    s.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if getattr(args, "device", "cuda") == "cuda" and \
            not torch.cuda.is_available():
        print("torch_tracing_chip: no CUDA device", file=sys.stderr)
        return 1
    from slambench.drive import stop_children

    try:
        return {"env": cmd_env, "layers": cmd_layers,
                "cost": cmd_cost}[args.cmd](args)
    finally:
        stop_children()


if __name__ == "__main__":
    sys.exit(main())
