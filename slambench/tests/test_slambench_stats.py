"""The latency and rate arithmetic, on made-up stamps, and the open-loop
schedule of the live driver through a stall."""

import math

import numpy as np
import pytest

from slambench import cell as cell_mod
from slambench import stats


def test_nearest_rank():
    v = list(range(1, 101))
    assert stats.nearest_rank(v, 50) == 50
    assert stats.nearest_rank(v, 95) == 95
    assert stats.nearest_rank(v, 100) == 100
    assert stats.nearest_rank([7.0], 95) == 7.0
    assert stats.nearest_rank([], 50) == math.inf


def test_missing_scans_raise_the_tail():
    lat = stats.latencies([0.0, 0.1, 0.2, 0.3], [0.04, 0.14, None, math.nan])
    np.testing.assert_allclose(lat[:2], [0.04, 0.04])
    assert math.isinf(lat[2]) and math.isinf(lat[3])
    assert stats.nearest_rank(lat, 50) == pytest.approx(0.04)
    assert stats.nearest_rank(lat, 95) == math.inf


def test_rate():
    assert stats.rate(640, 10.0, 42.0) == pytest.approx(20.0)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class _Out:
    class pose_matrix:
        @staticmethod
        def cpu():
            return None


class _Lio:
    """Takes 40 ms a scan, 520 ms for scan 3 (a stall)."""

    def __init__(self, clock):
        self.clock, self.k = clock, 0

    def process_scan(self, *a, **kw):
        self.clock.t += 0.52 if self.k == 3 else 0.04
        self.k += 1
        return _Out()

    def flush(self):
        pass


class _Drive:
    n = 100
    scans = [dict(xyz=None, ring=None, time_rel=None, scan_start=0.0,
                  imu_t=None, imu_gyro=None, imu_acc=None, imu_rpy=None)
             for _ in range(100)]


def test_open_loop_schedule_counts_the_wait_of_a_stall(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(cell_mod.time, "sleep", clock.sleep)
    cell = {"traffic": {"rate_hz": 10.0, "max_late_s": 60.0}}
    rec = cell_mod._window_live(cell_mod.Session(lambda: _Lio(clock)),
                                _Drive(), cell, 0, 2.0, clock,
                                lambda n: None)
    lat = rec["latencies"]
    assert rec["attempted"] == 20 and len(lat) == 20
    np.testing.assert_allclose(lat[:3], 0.04, atol=1e-9)
    # scan 3 is due at 0.3 s and done at 0.82 s; the scans that fell due
    # during the stall wait for it, and the backlog drains 60 ms a period
    np.testing.assert_allclose(lat[3], 0.52, atol=1e-9)
    np.testing.assert_allclose(
        lat[4:11], [0.46, 0.40, 0.34, 0.28, 0.22, 0.16, 0.10], atol=1e-9)
    np.testing.assert_allclose(lat[11:], 0.04, atol=1e-9)
    assert stats.nearest_rank(lat, 50) == pytest.approx(0.04)
    assert stats.nearest_rank(lat, 95) == pytest.approx(0.46)


def test_a_scan_past_the_late_cap_counts_as_failed(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(cell_mod.time, "sleep", clock.sleep)
    cell = {"traffic": {"rate_hz": 10.0, "max_late_s": 0.1}}
    rec = cell_mod._window_live(cell_mod.Session(lambda: _Lio(clock)),
                                _Drive(), cell, 0, 0.5, clock,
                                lambda n: None)
    assert np.isinf(rec["latencies"]).sum() >= 1
