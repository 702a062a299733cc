"""One run of one cell: set-up, the measured window, the traced window's
layers, and the comparison with the reference.

A cell is a configuration (``configs/<name>.json``: the deployment's
``LioParams``, sensor and drive) under a traffic mix (``traffic/<name>.json``),
both named in ``BENCHMARK.json``.  The traffic's ``mode`` picks one of two
drivers of ``msst_torch.models.liosam.pipeline.LioSam``:

* ``replay``: closed loop, as a user replays a recorded drive: the next
  scan (or window of ``window`` scans, through ``process_window_async``
  when ``async``) is fed once the program has taken the last; the rate is
  every scan fed over the time from the window's start until all their
  poses are on the host;
* ``live``: open loop at the sensor's rate: scan k is due at t0 + k / rate
  whatever the program is doing, and its latency runs from its due time to
  its pose on the host.

Set-up feeds the boot scans (the dynamic-init re-feed), then
``fast_forward_scans`` more, flushes, and, with ``warm_loop``, runs one
forced loop attempt on a copy of the state that is then thrown away.  The
reference (``compare.py``) repeats the same calls on its own copy.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import time
from collections import deque
from pathlib import Path

import numpy as np

from . import compare, spans, stats
from .drive import Drive

# scans the loop warm-up shifts back past the age gate
_WARM_AGE_S = 1000.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, manifest: dict, name: str) -> dict:
    """The manifest's workload `name` with its configuration, traffic,
    limits and the metrics it reports."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = load_json(root / cfg_entry["file"])
    here = root / "slambench"
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = load_json(here / "limits" / f"{name}.json")

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if m["moves"] in e2e_names and reports(m)]
    return dict(name=name, workload=w, config=cfg, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer, root=root)


def metric_reader(root: Path, name: str):
    """``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``:
    its ``read(run)`` gives the metric or None."""
    base = root / "slambench" / "metrics"
    for stem in (name, name.split(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"slambench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in {base}")


# -- driving LioSam: the same calls for the program and the reference ------


def make_lio(L, cell: dict, device):
    """A LioSam of the module namespace `L` (the program's or the
    reference's ``models.liosam``) for the cell."""
    t = cell["traffic"]
    p = dict(cell["config"]["params"])
    p["loop_closure_enabled"] = bool(t["loop_closure"])
    for k, v in p.items():
        if isinstance(v, list):
            p[k] = tuple(v)
    return L.LioSam(L.LioParams(**p), device=device, window=t["window"],
                    boot_scans=t["boot_scans"],
                    readback_interval=t.get("readback_interval"))


def _scan_call(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


def feed(lio, scans: list, window: int) -> list:
    """Feed `scans` synchronously, `window` at a time; the StepOutputs with
    the scans each covers."""
    outs = []
    if window == 1:
        for s in scans:
            outs.append((_scan_call(lio, s), 1))
    else:
        for a in range(0, len(scans), window):
            chunk = scans[a:a + window]
            outs.append((lio.process_window(chunk), len(chunk)))
    return outs


def setup_scans(cell: dict) -> int:
    t = cell["traffic"]
    return t["boot_scans"] + t.get("fast_forward_scans", 0)


def feed_setup(lio, drive: Drive, cell: dict) -> None:
    """Boot, fast-forward, flush: the set-up's calls, for both sides."""
    feed(lio, drive.scans[:setup_scans(cell)], cell["traffic"]["window"])
    lio.flush()


def pose_rows(outs: list) -> list:
    """The per-scan 4x4 poses of a list of (StepOutput, scans), on the
    device (a window's StepOutput holds one row a slot)."""
    rows = []
    for out, n in outs:
        m = out.pose_matrix
        if m.dim() == 2:
            rows.append(m)
        else:
            rows.extend(m[:n].unbind(0))
    return rows


def keyframe_snapshot(lio) -> dict:
    """The keyframe store's poses and count and the loops closed, cloned on
    the device (no host sync)."""
    st = lio.state
    return {"kf_pose6": st.kf.pose6.clone(), "kf_count": st.kf.count.clone(),
            "n_loop": st.n_loop.clone()}


def _tree_map(fn, x):
    if x is None:
        return None
    if isinstance(x, tuple):
        vals = [_tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if hasattr(x, "clone"):
        return fn(x)
    return x


def warm_loop(lio, L_loop) -> None:
    """One loop attempt on a copy of the state whose keyframes are all made
    old enough, so that the candidate search, the ICP, the fine stage and a
    closure's graph solve run once before the window (their libraries'
    first use); the copy is thrown away."""
    st = _tree_map(lambda t: t.clone(), lio.state)
    kf = st.kf
    n = int(kf.count)
    if n < 2:
        return
    time_ = kf.time.clone()
    time_[:n - 1] -= _WARM_AGE_S
    st = st._replace(kf=kf._replace(time=time_))
    L_loop.loop_closure_step(st, lio.p)


# -- the measured window ----------------------------------------------------


class Session:
    """The program's LioSam under measurement.  `make` builds one and feeds
    it the set-up's scans; a replay window that reaches the end of the
    drive continues as a new session of the same drive, set-up included
    (``restart``)."""

    def __init__(self, make):
        self.make = make
        self.lio = make()

    def restart(self):
        self.lio = self.make()


def _window_replay(session, drive, cell, start, seconds, clock, on_scan,
                   max_scans=None):
    """Closed-loop replay from scan `start` for `seconds` (or until
    `max_scans` are fed); returns the window record."""
    t = cell["traffic"]
    W = t["window"]
    outs = []
    i, fed, restarted, first = start, 0, 0, None
    stop = max_scans if max_scans is not None else math.inf
    inflight = deque()
    t0 = clock()

    def drain():
        while inflight:
            f, n = inflight.popleft()
            outs.append((f.result(), n))
        session.lio.flush()

    while clock() - t0 < seconds and fed < stop:
        chunk = drive.scans[i:i + W]
        if len(chunk) < W:
            drain()
            if first is None:
                first = fed
                on_scan(fed, True)
            session.restart()
            fed += setup_scans(cell)
            restarted += setup_scans(cell)
            i = setup_scans(cell)
            continue
        if W > 1 and t.get("async"):
            if len(inflight) >= 2:
                f, n = inflight.popleft()
                outs.append((f.result(), n))
                if clock() - t0 >= seconds:
                    break
            inflight.append((session.lio.process_window_async(chunk),
                             len(chunk)))
        else:
            outs.extend(feed(session.lio, chunk, W))
            on_scan(fed + len(chunk))
        i += len(chunk)
        fed += len(chunk)
    drain()
    return dict(mode="replay", t0=t0, t_end=clock(), attempted=fed,
                outs=outs, restart_scans=restarted, next=i,
                first_session_scans=fed if first is None else first)


def _window_live(session, drive, cell, start, seconds, clock, on_scan,
                 max_scans=None):
    """Open loop at the sensor's rate from scan `start` for `seconds` (or
    `max_scans` scans)."""
    t = cell["traffic"]
    period = 1.0 / float(t["rate_hz"])
    n_due = min(int(round(seconds / period)), drive.n - start,
                max_scans if max_scans is not None else drive.n)
    late_cap = float(t.get("max_late_s", 60.0))
    due, done, outs = [], [], []
    t0 = clock() + 0.01
    for k in range(n_due):
        d = t0 + k * period
        due.append(d)
        wait = d - clock()
        if wait > 0:
            time.sleep(wait)
        if clock() > t0 + seconds + late_cap:
            done.append(None)
            continue
        out = _scan_call(session.lio, drive.scans[start + k])
        out.pose_matrix.cpu()
        done.append(clock())
        outs.append((out, 1))
        on_scan(k + 1)
    t_end = clock()
    session.lio.flush()
    return dict(mode="live", t0=t0, t_end=t_end, attempted=n_due, outs=outs,
                latencies=stats.latencies(due, done))


WINDOWS = {"replay": _window_replay, "live": _window_live}


# -- the traced window's targets -------------------------------------------


def span_targets():
    """(owner, attribute, key) of every span: the layers' entry points,
    reached by name from outside the program.  A traced run that cannot
    find one of them is refused (``spans.MissingTargets``)."""
    from msst_torch.models.liosam import mapping, pipeline
    from msst_torch.ops import graph, registration

    L = pipeline.LioSam
    return [
        (L, "process_scan", "pipeline"),
        (L, "process_window", "pipeline"),
        (L, "process_window_async", "pipeline"),
        (L, "_dispatch_window", "pipeline"),
        (pipeline, "odometry_step_packed", "step"),
        (mapping, "odometry_window_flat", "step"),
        (mapping, "odometry_window_flat_q16", "step"),
        (mapping, "odometry_window_flat_ri", "step"),
        (mapping, "odometry_window_flat_ri2", "step"),
        (mapping, "prepare_scan", "prepare"),
        (mapping, "prepare_scan_grid", "prepare"),
        (mapping, "odometry_core", "core"),
        (registration, "scan_to_map_voxel", "s2m"),
        (registration, "scan_to_map", "s2m"),
        (mapping, "_insert_keyframe", "keyframe"),
        (graph, "optimize", "graph_solve"),
        (graph, "optimize_cg", "graph_solve"),
        (pipeline, "loop_closure_step", "loop_attempt"),
    ]


def _traced_window(session, drive, cell, start, seconds, clock, device,
                   on_scan):
    """The --trace 1 window: its first half under synced spans, its second
    under torch.profiler, for at most the traffic's ``profile_scans``
    scans, with every B1 call's inputs recorded."""
    from torch.profiler import ProfilerActivity, profile

    from msst_torch.ops import voxelmap

    run = WINDOWS[cell["traffic"]["mode"]]
    totals: dict = {}
    with spans.synced_spans(span_targets(), device, totals) as missing:
        if missing:
            raise spans.MissingTargets(missing)
        rec_a = run(session, drive, cell, start, seconds / 2, clock, on_scan)
    b1_calls: list = []
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    start_b = rec_a.get("next", start + rec_a["attempted"])
    with spans.recorded_calls(voxelmap, "lookup_cat", b1_calls):
        with profile(activities=acts) as prof:
            rec_b = run(session, drive, cell, start_b, seconds / 2, clock,
                        lambda n, end=False: on_scan(n + rec_a["attempted"],
                                                     end),
                        max_scans=cell["traffic"]["profile_scans"])
    prof_red = spans.reduce_profile(prof)
    window_s = rec_b["t_end"] - rec_b["t0"]
    trace = {"spans": totals, "span_scans": rec_a["attempted"],
             "missing_spans": missing, "profile": prof_red,
             "prof_scans": rec_b["attempted"], "window_s": window_s,
             "b1_calls": b1_calls, "device": device}
    outs = rec_a["outs"] + rec_b["outs"]
    rec = dict(rec_b, t0=rec_a["t0"], outs=outs,
               attempted=rec_a["attempted"] + rec_b["attempted"])
    if rec_a["mode"] == "replay":
        rec["restart_scans"] = rec_a["restart_scans"] + rec_b["restart_scans"]
        rec["first_session_scans"] = (
            rec_a["first_session_scans"] if rec_a["restart_scans"]
            else rec_a["attempted"] + rec_b["first_session_scans"])
    if rec_a["mode"] == "live":
        rec["latencies"] = np.concatenate([rec_a["latencies"],
                                           rec_b["latencies"]])
    return rec, trace


# -- one run ----------------------------------------------------------------


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, faults=None) -> dict:
    """Set up, measure, compare; the result object (without the checks'
    print).  `faults` (tests only) is a context manager put around the
    program's set-up and window."""
    import torch

    from msst_torch.models.liosam import loop as prog_loop
    import msst_torch.models.liosam as prog

    clock = time.perf_counter
    t = cell["traffic"]
    mode = t["mode"]
    W = t["window"]
    n_setup = setup_scans(cell)
    if mode == "live":
        n_drive = n_setup + int(round(seconds * t["rate_hz"])) + 1
    else:
        n_drive = n_setup + int(math.ceil(seconds * t["drive_scans_per_s"]))
        n_drive = n_setup + -(-(n_drive - n_setup) // W) * W
    want_grids = W > 1
    parts = {"start_s": clock() - t_start}
    drive = Drive(cell["config"], n_drive, seed, points=not want_grids,
                  grids=want_grids, workers=t.get("workers"))

    parts["inputs_s"] = clock() - t_start - parts["start_s"]
    n_cmp = int(t["compare_scans"])
    if n_cmp % W:
        raise ValueError("compare_scans must be a multiple of the window")
    snapshot = {}

    def make():
        lio = make_lio(prog, cell, device)
        feed_setup(lio, drive, cell)
        return lio

    with (faults() if faults else contextlib.nullcontext()):
        t_feed = clock()
        session = Session(make)
        parts["feed_s"] = clock() - t_feed
        if t.get("warm_loop"):
            t_warm = clock()
            warm_loop(session.lio, prog_loop)
            parts["warm_loop_s"] = clock() - t_warm
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = clock() - t_start

        def on_scan(n, session_end=False):
            # the keyframe store once the compared scans are through, or at
            # the end of a first session that fed fewer (the synchronous
            # drivers; a window's scans are compared one by one)
            if ((n == n_cmp or session_end) and not snapshot
                    and not t.get("async")):
                snapshot.update(keyframe_snapshot(session.lio))

        if trace:
            rec, tr = _traced_window(session, drive, cell, n_setup, seconds,
                                     clock, device, on_scan)
        else:
            rec = WINDOWS[mode](session, drive, cell, n_setup, seconds,
                                clock, on_scan)
            tr = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            mem_peak = int(torch.cuda.max_memory_allocated(device))
        else:
            mem_peak = 0
        lio = session.lio
        if not snapshot and not t.get("async"):
            snapshot.update(keyframe_snapshot(lio))
        rows = pose_rows(rec["outs"])
        poses = (torch.stack(rows).cpu().numpy() if rows
                 else np.zeros((0, 4, 4), np.float32))
        traj = lio.trajectory.as_matrices()
        snap = {k: v.cpu().numpy() for k, v in snapshot.items()}
        drive_info = {"setup_parts_s": parts,
                      "keyframes": int(lio.state.kf.count),
                      "loops_closed": int(lio.state.n_loop),
                      "host_stage_s": dict(lio.timings)}
        del lio, session, rec["outs"], rows
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # a scan fed by a restarted session's set-up has no row of its own
    failed = int(rec["attempted"] - rec.get("restart_scans", 0) - np.isfinite(
        poses.reshape(len(poses), -1)).all(axis=1).sum())
    run = {"setup_s": setup_s, "window": rec, "trace": tr,
           "seconds": seconds}
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = metric_reader(cell["root"], m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks, correct, info = compare.check(
        cell, drive, poses, snap,
        min(len(poses), rec.get("first_session_scans", len(poses))), device)
    gates = compare.gates(drive, traj)
    gates.update(info)
    result = {
        "correct": bool(correct),
        "attempted": int(rec["attempted"]),
        "failed": failed,
        "metrics": metrics,
        "device": {},
        "gates": gates,
        "drive": drive_info,
        "checks": checks,
        "_mem_peak": mem_peak,
        "_trace": tr,
    }
    return result
