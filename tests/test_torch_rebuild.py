"""The voxel method's rebuild local map (``map_update="rebuild"``) for both
``vox_source`` modes: the port's ``_rebuild_local_map`` against msst_tpu's
on a recorded keyframe store, and the 20-scan drive step by step against
msst_tpu's step (the test-local reference step of
tests/test_torch_slice.py; see its docstring for why the step is run
that way).

Tolerances: the voxel tables' masks, validity flags, counts and coords
are discrete and equal; voxel means agree to 1e-4 m (as the map clouds of
tests/test_torch_slice.py's knn rebuild: msst_tpu sums a voxel's members as
differences of prefix sums over the whole cloud, the port sums each voxel
on its own); directions up to sign where 4+ points fit them (COS_4PLUS).  The steps take the slice's voxel tolerances:
pose 1e-4, velocity 1e-3, occupancy 1e-6, and at least 90 % of them the
same Gauss-Newton iterations (VOXEL_SAME_ITERATIONS)."""

import jax
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam import pipeline as jpipe
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.utils import sim
from tests.test_torch_slice import (N_SCANS, _assert_step_matches, _feed,
                                    _reference_step)

SOURCES = ["downsampled", "direct"]
# least share of registered steps with equal Gauss-Newton iterations: the
# voxel GN stops on a cost plateau, and a step whose plateau test sits on
# its threshold stops one iteration apart (tests/test_torch_evict.py)
VOXEL_SAME_ITERATIONS = 0.9
# least |cos| between the two packages' voxel directions for cells of 4+
# points (measured worst 0.99829, a 4-point plane of the "direct" map); a
# 3-point cell's plane normal is set by rounding when its points are near
# collinear (tiny profile: vox_plane_min_spread = 0; measured down to 0.60)
COS_4PLUS = 0.995


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (as tests/test_torch_slice.py
    does: the suite's parallel workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(source):
    kw = dict(loop_closure_enabled=False, map_update="rebuild",
              vox_source=source)
    return jtiny(**kw), ttiny(**kw)


def _record(source):
    p, _ = _params(source)
    data = sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=N_SCANS, scan_dt=0.1, n_scan=16,
                            horizon=360, seed=5)
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
        lio = jpipe.LioSam(p)
        for s in data:
            _feed(lio, s)
    finally:
        mp.undo()
    return calls


@pytest.fixture(scope="module")
def recorded():
    return {source: _record(source) for source in SOURCES}


@pytest.mark.parametrize("source", SOURCES)
def test_step_by_step_matches_reference(recorded, source):
    """Every recorded step through the port's step: the same keyframe
    decision, iterations and degeneracy; pose, velocity and the voxel
    tables' occupancy within the slice's tolerances."""
    _, p = _params(source)
    calls = recorded[source]
    n_kf = n_reg = n_same = 0
    for state_np, points, aux, want in calls:
        _, got = tmap.odometry_step_packed(
            convert.from_numpy(state_np, "cpu"),
            torch.from_numpy(np.array(points)),
            torch.from_numpy(np.array(aux)), p)
        _assert_step_matches(got, want, same_iterations=False)
        n_kf += bool(want.is_keyframe)
        n_reg += int(want.s2m_iterations) > 0
        n_same += (int(want.s2m_iterations) > 0
                   and int(got.s2m_iterations) == int(want.s2m_iterations))
    assert n_kf >= 3
    assert n_same / n_reg >= VOXEL_SAME_ITERATIONS, (n_same, n_reg)


@pytest.mark.parametrize("source", SOURCES)
def test_rebuild_local_map_matches_reference(recorded, source):
    """``_rebuild_local_map`` on the last recorded keyframe store: the voxel
    feature tables of both maps."""
    p_j, p_t = _params(source)
    st = recorded[source][-1][0]
    n = int(st.kf.count)
    assert n >= 3
    pos, when = st.kf.pose6[n - 1, 3:], st.kf.time[n - 1]
    kf_j = jax.tree.map(jax.numpy.asarray, st.kf)
    want = jax.tree.map(np.asarray, jmap._rebuild_local_map(
        kf_j, jax.numpy.asarray(pos), jax.numpy.asarray(when), p_j))
    got = convert.to_numpy(tmap._rebuild_local_map(
        convert.from_numpy(st.kf, "cpu"), torch.from_numpy(pos),
        torch.from_numpy(np.asarray(when)), p_t))
    for name in ("corner_vox", "surf_vox"):
        g, w = getattr(got, name), getattr(want, name)
        for f in ("mask", "valid", "count", "coords"):
            a, b = getattr(g, f), getattr(w, f)
            m = w.mask
            np.testing.assert_array_equal(a[m], b[m], err_msg=f"{name}.{f}")
        m = w.mask
        np.testing.assert_allclose(g.mean[m], w.mean[m], atol=1e-4)
        # directions up to sign, where 4+ points fit them (COS_4PLUS)
        ok = m & w.valid & (w.count >= 4)
        assert ok.sum() > 10
        cos = (np.abs(np.sum(g.direction * w.direction, axis=1))
               / np.maximum(np.sum(w.direction ** 2, axis=1), 1e-12))
        assert np.all(cos[ok] >= COS_4PLUS), cos[ok].min()
    np.testing.assert_array_equal(got.anchor, pos)
    assert bool(got.valid)
    # the rebuild map keeps 8-row moment placeholders
    assert got.corner_mom.key.shape == (8,) == want.corner_mom.key.shape
