"""The port's tracer (``msst_torch.utils.profiling``) on the CPU: one tiny
drive with loop attempts forced on (a 0.5 s age gate, an attempt every 8
scans), driven at window 1 with recording off, with it on, and under
``torch.profiler``, and at window 4 through ``process_window_async`` with
it on, in one module fixture.

Recording on or off must leave the poses, keyframes and loops bit for bit
as they were; off it records nothing and makes no call of the tracer's
clock, CUDA events or profiler ranges.  The spans nest as the layers do,
carry their scans, and share the profiler's clock (within 100 us); the
worker's spans carry the window's scans and the thread's name."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msst_torch import cli as tcli
from msst_torch.models.liosam import LioSam
from msst_torch.models.liosam.params import tiny_params
from msst_torch.ops import registration
from msst_torch.utils import profiling, sim

N_SCANS = 12
PROFILED = 2
BOOT = 4
W = 4
SCAN_KEYS = ("xyz", "ring", "time_rel", "scan_start", "imu_t", "imu_gyro",
             "imu_acc", "imu_rpy")
GRID_KEYS = ("ranges", "azimuth", "col_time", "elev")
# the stage clocks of LioSam.timings and the spans that feed them
STAGES = {"pack": "pack", "flush_get": "flush",
          "loop_dispatch": "loop_attempt", "resync": "resync"}


def _params():
    return tiny_params(loop_closure_enabled=True,
                       history_keyframe_search_time_diff=0.5,
                       loop_closure_frequency=10.0 / 8)


def _drive_w1(data, profiled=None):
    """The drive at window 1; `profiled` (a torch.profiler profile) starts
    before its last PROFILED scans."""
    lio = LioSam(_params(), device="cpu", boot_scans=BOOT)
    for i, s in enumerate(data):
        if profiled is not None and i == len(data) - PROFILED:
            profiled.start()
        lio.process_scan(**{k: s[k] for k in SCAN_KEYS})
    return lio


def _drive_w4(data):
    lio = LioSam(_params(), device="cpu", window=W, boot_scans=BOOT)
    futs = [lio.process_window_async([{k: s[k] for k in SCAN_KEYS + GRID_KEYS}
                                      for s in data[i:i + W]])
            for i in range(0, len(data), W)]
    for f in futs:
        f.result()
    return lio


def _result(lio):
    traj = lio.trajectory.as_matrices()
    n = int(lio.state.kf.count)
    return {"traj": traj, "kf_pose6": lio.state.kf.pose6[:n].numpy(),
            "kf_time": lio.state.kf.time[:n].numpy(),
            "n_loop": int(lio.state.n_loop), "timings": dict(lio.timings)}


def _raise(*args, **kwargs):
    raise AssertionError("the tracer ran while recording was off")


@pytest.fixture(scope="module")
def drives():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    data = sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=N_SCANS, scan_dt=0.1, n_scan=16,
                            horizon=360, seed=5)
    profiling.drain()
    out = {}
    mp = pytest.MonkeyPatch()
    # off: no clock of the tracer, no CUDA event, no profiler range
    mp.setattr(profiling, "_now", _raise)
    mp.setattr(profiling, "_Event", _raise)
    mp.setattr(profiling, "_Range", _raise)
    try:
        lio = _drive_w1(data)
        out["off"] = _result(lio)
        out["off_session"] = profiling._session
    finally:
        mp.undo()

    iterations = []
    orig = registration.scan_to_map_voxel

    def spy(*args, **kwargs):
        res = orig(*args, **kwargs)
        iterations.append(int(res.iterations))
        return res

    mp.setattr(registration, "scan_to_map_voxel", spy)
    try:
        with profiling.tracing():
            lio = _drive_w1(data)
            out["on"] = _result(lio)
    finally:
        mp.undo()
    out["on_log"] = profiling.drain()
    out["iterations"] = iterations

    # the profiler over the last scans alone: recording turns on with it
    prof = profile(activities=[ProfilerActivity.CPU])
    lio = _drive_w1(data, profiled=prof)
    out["prof"] = _result(lio)
    prof.stop()
    out["prof_log"] = profiling.drain()
    start = prof.profiler.kineto_results.trace_start_ns()
    out["prof_events"] = [
        (e.name, start + int(e.time_range.start * 1000),
         start + int(e.time_range.end * 1000))
        for e in prof.events() if e.name.startswith("msst/")]

    with profiling.tracing():
        lio = _drive_w4(data)
        out["w4"] = _result(lio)
    out["w4_log"] = profiling.drain()
    torch.set_num_threads(n_threads)
    return out


def _index(lg):
    return profiling.by_index(lg["spans"])


def _up(rec, index):
    return profiling.ancestors(rec, index)


def test_recording_off_records_nothing_and_calls_no_tracer(drives):
    assert drives["off_session"] is None
    assert drives["off"]["n_loop"] > 0          # loops ran in the drive
    assert not profiling.recording()


def test_outputs_bit_identical_on_and_off(drives):
    off = drives["off"]
    for key in ("on", "prof"):
        got = drives[key]
        np.testing.assert_array_equal(got["traj"], off["traj"])
        np.testing.assert_array_equal(got["kf_pose6"], off["kf_pose6"])
        np.testing.assert_array_equal(got["kf_time"], off["kf_time"])
        assert got["n_loop"] == off["n_loop"]
    assert off["traj"].shape == (N_SCANS, 4, 4)


@pytest.mark.parametrize("which", ["on_log", "w4_log"])
def test_spans_nest_as_the_layers(drives, which):
    lg = drives[which]
    index = _index(lg)
    names = {r["name"] for r in lg["spans"]}
    assert {"pipeline", "step", "prepare", "core", "s2m", "gn_iter",
            "keyframe", "loop_attempt", "candidates"} <= names
    odometry_iters = 0
    for r in lg["spans"]:
        up = _up(r, index)
        if r["name"] == "gn_iter":
            assert up[0] == "s2m"
            if up[1] == "core":
                odometry_iters += 1
                chain = [n for n in up if n in ("core", "step", "pipeline")]
                assert chain[:3] == ["core", "step", "pipeline"]
            else:
                assert up[1] == "fine" and "loop_attempt" in up
        if r["name"] in ("prepare", "core"):
            assert "step" in up and "pipeline" in up
        if r["name"] == "loop_attempt":
            assert "step" not in up and "pipeline" in up
        if r["name"] == "slot":
            assert up[0] == "step"
    assert odometry_iters > 0


def test_each_span_carries_its_scans(drives):
    lg = drives["on_log"]
    index = _index(lg)
    assert all(r["scans"] is not None for r in lg["spans"])
    for r in lg["spans"]:
        if r["name"] in ("step", "core", "s2m", "gn_iter", "loop_attempt"):
            p = index[r["parent"]]
            while p["name"] != "pipeline":
                p = index[p["parent"]]
            assert r["scans"] == p["scans"] and r["scans"][1] == 1
    fed = sorted({r["scans"][0] for r in lg["spans"]
                  if r["name"] == "step"})
    assert fed == list(range(N_SCANS))


def test_self_time_within_duration(drives):
    for which in ("on_log", "w4_log"):
        lg = drives[which]
        selfs = profiling.self_ns(lg["spans"])
        index = _index(lg)
        parents = {r["parent"] for r in lg["spans"]}
        for i, s in selfs.items():
            r = index[i]
            dur = r["t1"] - r["t0"]
            assert 0 <= s <= dur
            if i in parents and r["tid"] == next(
                    c["tid"] for c in lg["spans"] if c["parent"] == i):
                assert s < dur


def test_gn_iter_spans_match_the_iterations(drives):
    lg = drives["on_log"]
    index = _index(lg)
    s2m = [r for r in lg["spans"] if r["name"] == "s2m"]
    per = {r["i"]: 0 for r in s2m}
    for r in lg["spans"]:
        if r["name"] == "gn_iter":
            per[r["parent"]] += 1
    assert [per[r["i"]] for r in s2m] == drives["iterations"]
    assert any(_up(r, index)[1] == "fine" for r in lg["spans"]
               if r["name"] == "gn_iter")


def test_counters_count_the_work(drives):
    lg = drives["on_log"]

    def n(name):
        return sum(r["name"] == name for r in lg["spans"])

    assert profiling.counter_total(lg, "gn_iters") == n("gn_iter")
    assert profiling.counter_total(lg, "b1_lookups") == sum(
        r["args"]["relookup"] for r in lg["spans"] if r["name"] == "gn_iter")
    assert profiling.counter_total(lg, "keyframes") == n("keyframe") > 0
    assert profiling.counter_total(lg, "graph_solves") == n("graph_solve")
    assert profiling.counter_total(lg, "loop_closures") == \
        drives["on"]["n_loop"] == n("close")
    assert profiling.counter_total(lg, "icp_iters") > 0
    attempts = [r for r in lg["spans"] if r["name"] == "loop_attempt"]
    assert attempts and any(a["args"]["found"] for a in attempts)
    for a in attempts:
        assert {"eligible", "tried", "found"} <= set(a["args"])
        if a["args"]["tried"]:
            assert a["args"]["icp_iters"] > 0
            assert len(a["args"]["fine_gn_iters"]) == 3 * a["args"]["tried"]
            assert np.isfinite(a["args"]["fitness"])


def _late(lg):
    """The spans of the profiled scans (the drive's last PROFILED)."""
    return {"spans": [r for r in lg["spans"]
                      if r["scans"][0] >= N_SCANS - PROFILED],
            "counts": {}}


def test_host_reads_at_named_sites_equal_across_drives(drives):
    a = profiling.host_reads(drives["on_log"])
    for site in ("core.gates", "core.keyframe", "s2m.stop_flag",
                 "keyframe.slot", "keyframe.rebake", "loop.eligible",
                 "loop.accept", "icp.stop", "pipeline.flush",
                 "pipeline.boot_velocity"):
        assert a.get(site, 0) > 0, site
    late = profiling.host_reads(_late(drives["on_log"]))
    assert late and late == profiling.host_reads(_late(drives["prof_log"]))
    assert a["s2m.stop_flag"] == profiling.counter_total(
        drives["on_log"], "gn_iters")
    assert a["core.gates"] == sum(r["name"] == "core"
                                  for r in drives["on_log"]["spans"])


def test_profiler_turns_recording_on_on_its_clock(drives):
    lg = drives["prof_log"]
    assert sorted({tuple(r["scans"]) for r in lg["spans"]
                   if r["name"] == "pipeline"}) == [
        (N_SCANS - PROFILED + i, 1) for i in range(PROFILED)]
    evs = drives["prof_events"]
    names = {name for name, _, _ in evs}
    assert {"msst/pipeline", "msst/core", "msst/gn_iter"} <= names
    assert any(name.startswith("msst/read:") for name in names)
    for name in ("pipeline", "core", "s2m", "gn_iter", "flush"):
        mine = [r for r in lg["spans"] if r["name"] == name]
        theirs = sorted((e for e in evs if e[0] == "msst/" + name),
                        key=lambda e: e[1])
        assert len(theirs) == len(mine)
        for r, (_, t0, t1) in zip(mine, theirs):
            assert abs(t0 - r["t0"]) < 100_000, name
            assert abs(t1 - r["t1"]) < 100_000, name


def test_async_worker_spans_carry_the_window(drives):
    lg = drives["w4_log"]
    index = _index(lg)
    worker = [r for r in lg["spans"] if r["thread"].startswith("lio-dispatch")]
    assert worker
    main_tids = {r["tid"] for r in lg["spans"]
                 if not r["thread"].startswith("lio-dispatch")}
    assert not {r["tid"] for r in worker} & main_tids
    windows = [r for r in worker if r["name"] == "pipeline"]
    assert [r["scans"] for r in windows] == [[4, W], [8, W]]
    for r in windows:
        caller = index[r["parent"]]
        assert caller["name"] == "pipeline" and caller["scans"] == r["scans"]
        assert caller["tid"] in main_tids
    slots = [r for r in worker if r["name"] == "slot"
             and index[r["parent"]]["scans"] == [8, W]]
    assert sorted({tuple(r["scans"]) for r in slots}) == [
        (8 + i, 1) for i in range(W)]
    assert any(r["name"] == "loop_attempt" for r in worker)


def test_chrome_trace_has_one_event_per_span(drives, tmp_path):
    lg = drives["w4_log"]
    path = tmp_path / "t.json"
    n = profiling.write_chrome(str(path), lg)
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "msst"]
    assert n == len(spans) == len(lg["spans"])
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)
    assert {e["tid"] for e in spans} == {r["tid"] for r in lg["spans"]}
    worker = [e for e in spans if e["name"] == "msst/pipeline"
              and e["args"]["scans"] == [8, W]]
    assert len(worker) == 2


def test_timings_are_the_stage_spans(drives):
    on, off = drives["on"]["timings"], drives["off"]["timings"]
    assert set(on) == set(off) == set(STAGES)
    lg = drives["on_log"]
    for key, name in STAGES.items():
        total = sum((r["t1"] - r["t0"]) / 1e9 for r in lg["spans"]
                    if r["name"] == name)
        assert on[key] == pytest.approx(total, rel=1e-9, abs=1e-12)
    assert set(drives["w4"]["timings"]) == set(STAGES) | {"dispatch"}


def test_lio_sim_trace_writes_the_spans(tmp_path, capsys):
    torch.set_num_threads(1)
    tcli.main(["lio-sim", "--device", "cpu", "--scans", "3", "--horizon",
               "360", "--trace", str(tmp_path / "tr")])
    capsys.readouterr()
    with open(tmp_path / "tr" / "trace.json") as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"msst/pipeline", "msst/step", "msst/s2m"} <= names or \
        {"msst/pipeline", "msst/step", "msst/prepare"} <= names


def test_threads_record_every_span_and_count():
    """More threads than cores open spans and count at once, outside any
    span too: every span is kept once, at its own index, under its own
    thread's parent, and no count is lost."""
    n_threads, n_spans = 16, 200
    profiling.drain()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing():
            def work(k):
                for j in range(n_spans):
                    with profiling.span("outer", (k, 1)):
                        with profiling.span("inner", j=j):
                            profiling.count("n")
                    profiling.count("outside")

            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    lg = profiling.drain()
    spans = lg["spans"]
    assert len(spans) == 2 * n_threads * n_spans
    assert [r["i"] for r in spans] == list(range(len(spans)))
    index = _index(lg)
    for r in spans:
        if r["name"] == "inner":
            up = index[r["parent"]]
            assert up["name"] == "outer" and up["tid"] == r["tid"]
            assert r["scans"] == up["scans"]
    assert profiling.counter_total(lg, "n") == n_threads * n_spans
    assert lg["counts"]["outside"] == n_threads * n_spans
