"""The port's host API of ``LioSam`` against msst_tpu's on one shared state:
``Trajectory.ate_rmse``, ``save_map`` (arrays and PCD files),
``imu_rate_pose``; and ``readback_interval``, ``timings`` and the demo
entry point on the CPU.

The state is the port's after a short tiny-profile drive; msst_tpu's
``LioSam`` gets the same keyframe store and filter, carried over as numpy.
Tolerances: the trajectory, keyframe times and map arrays are the same
numpy arithmetic on the same arrays and must be equal, as must the PCD
files written without downsampling (byte for byte).  With a resolution,
the downsampled clouds hold the same voxels, centroids within 1e-4 m
(test_torch_frontend's voxel tolerance).  The IMU-rate pose agrees to
1e-5 (float32 preintegration of the same samples, summed in another
order)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.models.liosam import demo as tdemo
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.models.liosam.pipeline import LioSam as TLioSam
from msst_torch.models.liosam.pipeline import Trajectory as TTrajectory
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.models.liosam.pipeline import LioSam as JLioSam
from msst_tpu.models.liosam.pipeline import Trajectory as JTrajectory
from msst_tpu.utils import sim
from tests.test_torch_frontend import _same_point_sets

N_SCANS = 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (as tests/test_torch_slice.py
    does: the suite's parallel workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


def _data(n=N_SCANS):
    return sim.make_dataset(sim.World(), sim.SimTrajectory(kind="circle"),
                            n_scans=n, scan_dt=0.1, n_scan=16, horizon=360,
                            seed=2)


def _to_ref(obj, template):
    """A port NamedTuple of numpy arrays as msst_tpu's NamedTuple of the
    same fields (the template gives the types)."""
    if hasattr(template, "_fields"):
        return type(template)(**{f: _to_ref(getattr(obj, f),
                                            getattr(template, f))
                                 for f in template._fields})
    return jnp.asarray(obj)


@pytest.fixture(scope="module")
def shared():
    """(port LioSam after the drive, msst_tpu LioSam holding its keyframe
    store, filter and time epoch)."""
    p_kw = dict(loop_closure_enabled=False)
    tlio = TLioSam(ttiny(**p_kw), device="cpu")
    for s in _data():
        _feed(tlio, s)
    tlio.flush()
    jlio = JLioSam(jtiny(**p_kw))
    st = convert.to_numpy(tlio.state)
    jlio.state = jlio.state._replace(
        kf=_to_ref(st.kf, jlio.state.kf),
        filter=_to_ref(st.filter, jlio.state.filter))
    jlio._epoch = tlio._epoch
    assert int(tlio.state.kf.count) >= 3
    return tlio, jlio


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_matches_reference(align):
    """Umeyama-aligned and raw ATE on a rotated, shifted, noisy copy of a
    ground-truth circle: equal to msst_tpu's (the same float64 numpy)."""
    rng = np.random.default_rng(7)
    a = np.linspace(0, 3, 50)
    gt = np.stack([10 * np.cos(a), 10 * np.sin(a), 0.1 * a], 1)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = gt @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.05,
                                                              gt.shape)
    mats = np.tile(np.eye(4, dtype=np.float32), (len(est), 1, 1))
    mats[:, :3, 3] = est
    t = TTrajectory(list(range(len(est))), list(mats))
    j = JTrajectory(list(range(len(est))), list(mats))
    got, want = t.ate_rmse(gt, align=align), j.ate_rmse(gt, align=align)
    assert got == want
    assert (got < 0.1) if align else (got > 1.0)


def test_save_map_arrays_match_reference(shared):
    tlio, jlio = shared
    got, want = tlio.save_map(), jlio.save_map()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert len(got["surf_map"]) > 1000 and len(got["corner_map"]) > 10


def test_save_map_files_match_reference(shared, tmp_path):
    """Without downsampling the four files are byte-equal to msst_tpu's."""
    tlio, jlio = shared
    tlio.save_map(str(tmp_path / "t"))
    jlio.save_map(str(tmp_path / "j"))
    names = ("trajectory.txt", "corner_map.pcd", "surf_map.pcd",
             "global_map.pcd")
    for name in names:
        a = (tmp_path / "t" / name).read_bytes()
        b = (tmp_path / "j" / name).read_bytes()
        assert a == b, name
    out = tlio.save_map()
    head = (tmp_path / "t" / "global_map.pcd").read_bytes().split(b"DATA")[0]
    n = len(out["corner_map"]) + len(out["surf_map"])
    assert f"POINTS {n}".encode() in head


def _pcd_points(path):
    raw = open(path, "rb").read()
    head, _, body = raw.partition(b"DATA binary\n")
    return np.frombuffer(body, np.float32).reshape(-1, 3)


def test_save_map_downsampled_matches_reference(shared, tmp_path):
    tlio, jlio = shared
    tlio.save_map(str(tmp_path / "t"), resolution=0.5)
    jlio.save_map(str(tmp_path / "j"), resolution=0.5)
    full = tlio.save_map()
    for name in ("corner_map", "surf_map"):
        a = _pcd_points(tmp_path / "t" / f"{name}.pcd")
        b = _pcd_points(tmp_path / "j" / f"{name}.pcd")
        assert 0 < len(a) < len(full[name])
        _same_point_sets(b, a)


def test_imu_rate_pose_matches_reference(shared):
    tlio, jlio = shared
    rng = np.random.default_rng(3)
    t0 = tlio._last_scan_time
    imu_t = t0 + np.arange(20) * 0.005
    gyro = rng.normal(0, 0.1, (20, 3)).astype(np.float32)
    acc = (rng.normal(0, 0.2, (20, 3)) + [0, 0, 9.80511]).astype(np.float32)
    tp, tv = tlio.imu_rate_pose(imu_t, gyro, acc)
    jp, jv = jlio.imu_rate_pose(imu_t, gyro, acc)
    np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), atol=1e-5)
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-5)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5)
    # it moved the pose forward from the filter's
    assert np.linalg.norm(tp.t.numpy() - tlio.state.filter.nav.p.numpy()) > 1e-3


@pytest.mark.parametrize("interval", [None, 3])
def test_readback_interval(interval):
    """Poses reach the host in batches of `readback_interval` scans (8 by
    default at window 1, as msst_tpu's max(8, 4 * window))."""
    p = ttiny(loop_closure_enabled=False, dynamic_init=False)
    lio = TLioSam(p, device="cpu", readback_interval=interval)
    want = 8 if interval is None else interval
    assert lio._readback_interval == want
    for s in _data(want + 2):
        _feed(lio, s)
    assert len(lio._trajectory.times) == want
    assert len(lio._pending) == 2
    assert len(lio.trajectory.times) == want + 2


def test_timings():
    """The host stages the port shares with msst_tpu add up in `timings`:
    pack and flush_get on every drive, resync after a closed loop's flush,
    loop_dispatch on an attempt."""
    p = ttiny(loop_closure_enabled=True)
    lio = TLioSam(p, device="cpu", readback_interval=2)
    for s in _data(10):
        _feed(lio, s)
    assert set(lio.timings) >= {"pack", "flush_get"}
    lio._loop_plausible = lambda t_cur=None: True
    lio._try_loop_closure()
    lio._resync_needed = True
    lio.flush()
    assert set(lio.timings) == {"pack", "flush_get", "loop_dispatch",
                                "resync"}
    assert all(v > 0.0 for v in lio.timings.values())


def test_demo_main_runs_on_cpu(capsys, tmp_path):
    """``python -m msst_torch.models.liosam.demo --cpu``: the per-scan lines
    and the ATE report; the LioSam it returns saves its map."""
    lio = tdemo.main(["--cpu", "--scans", "12", "--horizon", "360"])
    text = capsys.readouterr().out
    assert text.count("scan ") == 2 and "ATE RMSE:" in text
    assert int(lio.state.kf.count) >= 2
    out = lio.save_map(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["corner_map.pcd",
                                            "global_map.pcd", "surf_map.pcd",
                                            "trajectory.txt"]
    assert len(_pcd_points(tmp_path / "global_map.pcd")) == (
        len(out["corner_map"]) + len(out["surf_map"]))
    assert dataclasses.is_dataclass(lio.trajectory)
