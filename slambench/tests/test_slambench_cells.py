"""Whole runs of tiny cells on the CPU: the harness without its look for a
card.  A sound program matches the reference bit for bit; with the timed
path broken underneath, ``correct`` comes out false for each fault a cell
can have (one card, so no exchange between chips to leave out): a step
that returns its state unchanged, an answer altered where it is produced,
and, where the cell feeds windows, half of the window left out."""

import json
import time
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

from slambench.cell import load_cell, load_json, run_cell
from slambench.tests.tiny import make_root

CPU = torch.device("cpu")
SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory, cpu_threads):
    return make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, name, trace=False, faults=None, seconds=1.0):
    cell = load_cell(root, load_json(root / "BENCHMARK.json"), name)
    return run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter(),
                    faults=faults)


@pytest.mark.parametrize("name", ["tiny-replay", "tiny-live", "tiny-loop"])
def test_sound_cells_match_the_reference(root, name):
    res = _run(root, name)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert res["gates"]["compared_scans"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


def test_traced_run_reads_the_layers(root):
    res = _run(root, "tiny-replay", trace=True, seconds=2.0)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    assert {"pipeline_self_ms.replay", "prepare_ms.replay",
            "s2m_ms.replay", "keyframe_ms.replay"} <= got
    # no device on the CPU: the device readers find nothing and stay silent
    assert not got & {"b1_roofline_pct.replay", "device_idle_pct.replay"}


def _patched(module, name, make):
    @contextmanager
    def fault():
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        try:
            yield
        finally:
            setattr(module, name, orig)
    return fault


def _mapping():
    from msst_torch.models.liosam import mapping
    return mapping


def state_unchanged():
    def make(orig):
        def step(state, ps, p):
            return state, orig(state, ps, p)[1]
        return step
    return _patched(_mapping(), "odometry_core", make)


def answer_altered():
    def make(orig):
        def step(state, ps, p):
            state, out = orig(state, ps, p)
            m = out.pose_matrix.clone()
            m[0, 3] += 0.05
            return state, out._replace(pose_matrix=m)
        return step
    return _patched(_mapping(), "odometry_core", make)


def half_window():
    def make(orig):
        def core(state, preps, valid, p):
            keep = sum(valid) // 2
            return orig(state, preps, [v and i < keep
                                       for i, v in enumerate(valid)], p)
        return core
    return _patched(_mapping(), "_window_core", make)


FAULTS = [("tiny-live", state_unchanged), ("tiny-loop", state_unchanged),
          ("tiny-replay", state_unchanged), ("tiny-live", answer_altered),
          ("tiny-loop", answer_altered), ("tiny-replay", answer_altered),
          ("tiny-replay", half_window)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, name, fault):
    res = _run(root, name, faults=fault())
    assert not res["correct"], res["checks"]


def test_a_cell_is_added_by_new_files_alone(root, tmp_path):
    """A throwaway configuration, traffic mix, per-layer metric and cell,
    added as files and manifest entries; no harness file changes."""
    import shutil

    shutil.copytree(root, tmp_path, dirs_exist_ok=True)
    sb = tmp_path / "slambench"
    cfg = json.loads((sb / "configs" / "tiny.json").read_text())
    cfg["sensor"] = dict(cfg["sensor"], elev_limits_deg=[-20.0, 10.0])
    (sb / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    traffic = json.loads((sb / "traffic" / "t_live.json").read_text())
    traffic["rate_hz"] = 5.0
    (sb / "traffic" / "slow_live.json").write_text(json.dumps(traffic))
    (sb / "limits" / "tiny2-slow.json").write_text(
        (sb / "limits" / "tiny-live.json").read_text())
    (sb / "metrics" / "scans_due.py").write_text(
        "def read(run):\n    return float(run['window']['attempted'])\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="tiny2",
                               file="slambench/configs/tiny2.json"))
    man["workloads"].append({"name": "tiny2-slow", "config": "tiny2",
                             "traffic": "slow_live", "chips": 1,
                             "why": "throwaway"})
    for m in man["end_to_end"]:
        if "pose_latency_p50_ms" == m["name"]:
            m["workloads"].append("tiny2-slow")
    man["per_layer"].append({"name": "scans_due", "unit": "scans",
                             "better": "higher", "source": "host_clock",
                             "layer": "traffic", "moves":
                             "pose_latency_p50_ms",
                             "workloads": ["tiny2-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    res = _run(tmp_path, "tiny2-slow", seconds=1.2)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 6
    assert set(res["metrics"]) == {"pose_latency_p50_ms", "setup_s"}
    traced = _run(tmp_path, "tiny2-slow", trace=True, seconds=1.2)
    assert traced["metrics"]["scans_due"]["value"] == 6.0


def test_a_replay_that_runs_out_of_drive_starts_a_new_session(root, tmp_path):
    """The drive holds one window past the boot: the window goes on as a
    new session of the same drive, its set-up included, and the scans of
    the first session are the ones compared."""
    import shutil

    shutil.copytree(root, tmp_path, dirs_exist_ok=True)
    p = tmp_path / "slambench" / "traffic" / "t_replay.json"
    traffic = json.loads(p.read_text())
    p.write_text(json.dumps(dict(traffic, drive_scans_per_s=1,
                                 compare_scans=4)))
    res = _run(tmp_path, "tiny-replay", seconds=2.5)
    assert res["correct"], res["checks"]
    assert res["gates"]["compared_scans"] == 4
    assert res["attempted"] > 4 + 8 and res["failed"] == 0


def test_a_traced_run_refuses_a_missing_entry_point(root, monkeypatch):
    from msst_torch.ops import registration

    from slambench.spans import MissingTargets

    monkeypatch.delattr(registration, "scan_to_map")
    with pytest.raises(MissingTargets, match="registration.scan_to_map"):
        _run(root, "tiny-live", trace=True)
