"""The port's exact greedy LOAM features (``feature_method="exact"``)
against msst_tpu's ``extract_features`` on simulator scans, and one step
of the slice with them.

Tolerances: the corner and surface masks are discrete and must be equal,
bit for bit, on msst_tpu's own packed rings (the picks' order is part of
the contract).  The frontend's clouds agree as test_torch_frontend's do
(1e-4 m, order-free surface set)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch.models.liosam import frontend as tfront
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.models.liosam.pipeline import LioSam as TLioSam
from msst_torch.ops import features as tfeat
from msst_torch.ops import range_image as tri
from msst_tpu.models.liosam import frontend as jfront
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.ops import features as jfeat
from msst_tpu.ops import range_image as jri
from msst_tpu.ops.pointcloud import Cloud as JCloud
from msst_tpu.utils import sim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (as tests/test_torch_slice.py
    does: the suite's parallel workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packed():
    """Packed step inputs of four sim scans (tiny profile): a circle drive
    and a straight one (longer flat runs, other corner spacing)."""
    out = []
    for kind, seed in (("circle", 3), ("line", 5)):
        data = sim.make_dataset(sim.World(), sim.SimTrajectory(kind=kind),
                                n_scans=2, scan_dt=0.1, n_scan=16,
                                horizon=360, seed=seed)
        packer = TLioSam(ttiny(loop_closure_enabled=False), device="cpu")
        for s in data:
            out.append(packer._make_input_np(
                s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
                imu_t=s["imu_t"], imu_gyro=s["imu_gyro"],
                imu_acc=s["imu_acc"], imu_rpy=s["imu_rpy"]))
            packer._last_scan_time = float(s["scan_start"])
    return out


def _rings(pk):
    """msst_tpu's packed rings of one scan, and the same as tensors."""
    p = jtiny()
    pts, aux = pk
    jinp = jmap.unpack_step_input(jnp.asarray(pts), jnp.asarray(aux), p)
    jext = jri.extract_rings(jri.project(
        JCloud.create(jinp.scan.xyz, jinp.scan.mask), jinp.scan.ring,
        p.n_scan, p.horizon_scan, p.lidar_min_range, p.lidar_max_range))
    return jext, tri.ExtractedScan(*(torch.from_numpy(np.array(x))
                                     for x in jext))


@pytest.mark.parametrize("scan", range(4))
@pytest.mark.parametrize("edge", [1.0, 0.1])
def test_exact_masks_match_jax(packed, scan, edge):
    """Masks equal at the default edge threshold and at a low one, where
    most sectors reach their 20 picks and suppression walks overlap."""
    p = jtiny()
    jext, text = _rings(packed[scan])
    jm = jax.jit(lambda e: jfeat.extract_features(e, edge, p.surf_threshold)
                 )(jext)
    tm = tfeat.extract_features(text, edge, p.surf_threshold)
    np.testing.assert_array_equal(tm.corner.numpy(), np.asarray(jm.corner))
    np.testing.assert_array_equal(tm.surface.numpy(), np.asarray(jm.surface))
    assert 0 < int(tm.corner.sum()) < int(tm.surface.sum())


def test_exact_differs_from_nms(packed):
    """The two methods are different selections on the same rings (the
    switch is not a no-op)."""
    p = jtiny()
    _, text = _rings(packed[0])
    ex = tfeat.extract_features(text, 0.1, p.surf_threshold)
    nms = tfeat.extract_features_nms(text, 0.1, p.surf_threshold)
    assert not torch.equal(ex.corner, nms.corner)


def test_run_frontend_exact_matches_jax(packed):
    """``run_frontend`` with feature_method="exact": the same counts and
    corner cloud, the surface cloud as an order-free set."""
    from tests.test_torch_frontend import _cloud_rows, _same_point_sets

    p_j, p_t = jtiny(feature_method="exact"), ttiny(feature_method="exact")
    for pk in packed[:2]:
        pts, aux = pk
        jinp = jmap.unpack_step_input(jnp.asarray(pts), jnp.asarray(aux), p_j)
        tinp = tmap.unpack_step_input(torch.from_numpy(pts),
                                      torch.from_numpy(aux), p_t)
        jo = jax.jit(lambda s: jfront.run_frontend(s, p_j, carry_time=True))(
            jinp.scan)
        to = tfront.run_frontend(tinp.scan, p_t)
        assert int(to.n_corner) == int(jo.n_corner)
        assert int(to.n_surf) == int(jo.n_surf)
        np.testing.assert_allclose(_cloud_rows(*to.corner),
                                   _cloud_rows(*jo.corner), atol=1e-4)
        _same_point_sets(_cloud_rows(*jo.surf), _cloud_rows(*to.surf))


def test_step_drive_exact_matches_reference():
    """A 10-scan drive with feature_method="exact", step by step: each of
    msst_tpu's recorded steps (through tests/test_torch_slice.py's
    test-local reference step) through the port's step, with the slice's
    voxel tolerances; registered steps may stop one Gauss-Newton iteration
    apart on the cost plateau (tests/test_torch_evict.py), at most one in
    ten."""
    from msst_tpu.models.liosam import pipeline as jpipe
    from tests.test_torch_slice import (_assert_step_matches, _feed,
                                        _reference_step)
    from msst_torch import convert

    kw = dict(loop_closure_enabled=False, feature_method="exact")
    p_j, p_t = jtiny(**kw), ttiny(**kw)
    data = sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=10, scan_dt=0.1, n_scan=16, horizon=360,
                            seed=5)
    jstep = jax.jit(_reference_step, static_argnames=("p",))
    calls = []

    def recording_step(state, points, aux, p):
        new_state, out = jstep(state, points, aux, p)
        calls.append((jax.tree.map(np.asarray, state), np.asarray(points),
                      np.asarray(aux), jax.tree.map(np.asarray, out)))
        return new_state, out

    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "odometry_step_packed", recording_step)
    try:
        lio = jpipe.LioSam(p_j)
        for s in data:
            _feed(lio, s)
    finally:
        mp.undo()
    n_reg = n_same = 0
    for state_np, points, aux, want in calls:
        _, got = tmap.odometry_step_packed(
            convert.from_numpy(state_np, "cpu"),
            torch.from_numpy(np.array(points)),
            torch.from_numpy(np.array(aux)), p_t)
        _assert_step_matches(got, want, same_iterations=False)
        assert int(got.n_corner) == int(want.n_corner)
        n_reg += int(want.s2m_iterations) > 0
        n_same += (int(want.s2m_iterations) > 0
                   and int(got.s2m_iterations) == int(want.s2m_iterations))
    assert len(calls) == 10 + 8 and n_reg >= 10
    assert n_same / n_reg >= 0.9
