"""The simulator copy: the source's geometry and IMU, and a drive that does
not depend on how its sweeps were split over workers."""

import json
from pathlib import Path

import numpy as np
import pytest

from slambench import sim
from slambench.drive import Drive

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("n_scan,elev", [(16, (-15.0, 15.0)),
                                         (64, (-24.9, 2.0))])
def test_sweep_is_the_sources_without_noise(n_scan, elev):
    from msst_torch.utils import sim as source

    sensor = sim.Sensor(n_scan=n_scan, horizon=360, elev_limits=elev,
                        noise=0.0)
    t0 = 1.3
    r = sim.sweep_ranges(sim.World(), sim.SimTrajectory(), sensor, t0,
                         sim.scan_rng(0, 0))
    xyz, ring, time_rel, ri = source.raycast_scan(
        source.World(), source.SimTrajectory().pose(t0), n_scan=n_scan,
        horizon=360, noise=0.0, traj=source.SimTrajectory(), t0=t0,
        elev_limits=elev)
    d, ring2, time2, _ = sensor.rays()
    assert np.array_equal(ri["ranges"], np.maximum(r, 0).astype(np.float32))
    assert np.array_equal(xyz, (d * r[:, None]).astype(np.float32))
    assert np.array_equal(ring, ring2) and np.array_equal(time_rel, time2)
    grids = sensor.grids()
    assert all(np.array_equal(grids[k], ri[k]) for k in grids)


def test_imu_is_the_sources_without_noise():
    from msst_torch.utils import sim as source

    sensor = sim.Sensor(horizon=90)
    ds = source.make_dataset(source.World(), source.SimTrajectory(),
                             n_scans=20, n_scan=16, horizon=90, seed=0,
                             imu_noise_gyr=0.0, imu_noise_acc=0.0)
    imu = sim.make_imu(sim.SimTrajectory(), sensor, 20, 0,
                       imu_noise_gyr=0.0, imu_noise_acc=0.0)
    for i in (0, 7, 19):
        s = sim.scan_sensors(imu, sensor, i)
        for k, v in s.items():
            np.testing.assert_allclose(v, ds[i][k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(imu["gt"][i * 20], ds[i]["gt_pose"],
                                   atol=1e-12)


def _tiny_cfg():
    cfg = json.loads((ROOT / "slambench/configs/vlp16.json").read_text())
    cfg["sensor"] = dict(cfg["sensor"], horizon=90)
    return cfg


def test_workers_give_the_drive_one_process_gives():
    cfg = _tiny_cfg()
    seed = 2**31 + 977
    one = Drive(cfg, 40, seed, points=True, grids=True, workers=1)
    two = Drive(cfg, 40, seed, points=True, grids=True, workers=2)
    for a, b in zip(one.scans, two.scans):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_a_sweep_does_not_depend_on_the_drive_length():
    cfg = _tiny_cfg()
    short = Drive(cfg, 12, 5, points=False, grids=True, workers=1)
    long = Drive(cfg, 30, 5, points=False, grids=True, workers=1)
    for a, b in zip(short.scans, long.scans[:12]):
        assert np.array_equal(a["ranges"], b["ranges"])
        assert np.array_equal(a["imu_gyro"][:5], b["imu_gyro"][:5])


def test_seeds_change_the_noise_not_the_drive():
    cfg = _tiny_cfg()
    a = Drive(cfg, 6, 1, points=True, grids=False, workers=1)
    b = Drive(cfg, 6, 2, points=True, grids=False, workers=1)
    assert not np.array_equal(a.scans[3]["xyz"], b.scans[3]["xyz"])
    assert np.abs(a.scans[3]["xyz"] - b.scans[3]["xyz"]).max() < 0.2
    assert np.array_equal(a.gt, b.gt)

