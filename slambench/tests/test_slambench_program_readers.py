"""The readers of the program's own spans and counters
(``metrics/gn_iter_ms.py``, ``metrics/host_reads_per_scan.py``): None
without a traced part or without a log, and the right value from a
synthetic log put in place of the program's."""

import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(stem):
    spec = importlib.util.spec_from_file_location(
        f"slambench.metrics.{stem}", METRICS / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, parent, t0, t1, d=None, counts=None):
    return {"i": i, "name": name, "scans": [0, 1], "tid": 1,
            "thread": "MainThread", "parent": parent, "t0": t0, "t1": t1,
            "d0": d[0] if d else None, "d1": d[1] if d else None,
            "args": {}, "counts": counts or {}}


def _log(device):
    ms = 1_000_000

    def d(a, b):
        return (a * ms, b * ms) if device else None

    spans = [
        _span(0, "pipeline", None, 0, 100 * ms, d(0, 100)),
        _span(1, "step", 0, 0, 60 * ms, d(0, 60)),
        _span(2, "core", 1, 10 * ms, 60 * ms, d(10, 60),
              {"host_read:core.gates": 1}),
        _span(3, "s2m", 2, 20 * ms, 50 * ms, d(20, 50)),
        # two odometry iterations: host 4 and 6 ms, device 3 and 5 ms
        _span(4, "gn_iter", 3, 20 * ms, 24 * ms, d(20, 23),
              {"host_read:s2m.stop_flag": 1}),
        _span(5, "gn_iter", 3, 30 * ms, 36 * ms, d(30, 35),
              {"host_read:s2m.stop_flag": 1}),
        # a loop attempt's fine stage: its iterations are not the odometry's
        _span(6, "loop_attempt", 0, 60 * ms, 100 * ms, d(60, 100),
              {"host_read:loop.eligible": 1}),
        _span(7, "fine", 6, 70 * ms, 99 * ms, d(70, 99)),
        _span(8, "s2m", 7, 70 * ms, 90 * ms, d(70, 90)),
        _span(9, "gn_iter", 8, 70 * ms, 90 * ms, d(70, 90),
              {"host_read:s2m.stop_flag": 1}),
    ]
    return {"spans": spans, "counts": {"host_read:export.count": 1}}


@pytest.fixture
def program(monkeypatch):
    """The program's tracer with its log replaced by the test's."""
    from msst_torch.utils import profiling

    box = {}
    monkeypatch.setattr(profiling, "log", lambda *a, **k: box["log"])
    return box


RUN = {"trace": {"prof_scans": 2}}


@pytest.mark.parametrize("stem", ["gn_iter_ms", "host_reads_per_scan"])
def test_none_without_a_trace(stem, program):
    program["log"] = _log(True)
    read = _reader(stem)
    assert read({"trace": None}) is None
    assert read({}) is None
    assert read({"trace": {"prof_scans": 0}}) is None
    program["log"] = {"spans": [], "counts": {}}
    assert read(RUN) is None


def test_gn_iter_ms_is_the_mean_odometry_device_interval(program):
    program["log"] = _log(True)
    assert _reader("gn_iter_ms")(RUN) == pytest.approx(4.0)


def test_gn_iter_ms_falls_back_to_the_host_interval(program):
    program["log"] = _log(False)
    assert _reader("gn_iter_ms")(RUN) == pytest.approx(5.0)


def test_gn_iter_ms_none_without_odometry_iterations(program):
    lg = _log(True)
    lg["spans"] = [r for r in lg["spans"] if r["i"] not in (4, 5)]
    program["log"] = lg
    assert _reader("gn_iter_ms")(RUN) is None


def test_host_reads_per_scan_counts_every_site(program):
    program["log"] = _log(True)
    # 1 gates + 3 stop flags + 1 eligible + 1 outside any span, 2 scans
    assert _reader("host_reads_per_scan")(RUN) == pytest.approx(3.0)


def test_none_where_the_program_has_no_tracer(monkeypatch):
    from msst_torch.utils import profiling

    monkeypatch.delattr(profiling, "log")
    for stem in ("gn_iter_ms", "host_reads_per_scan"):
        assert _reader(stem)(RUN) is None
