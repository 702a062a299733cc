"""Keyframe eviction with marginalization: the port's
``_evict_oldest_keyframe`` against msst_tpu's, and drives that fill a
3-keyframe store step by step against msst_tpu's step.

msst_tpu's step is run through the test-local jitted reference step of
tests/test_torch_slice.py (its ``odometry_core`` reads an undefined name;
see that module's docstring).  Its own ``_evict_oldest_keyframe`` reads no
such name and is jitted as it is.

Tolerances: indices, masks, counts and keyframe clouds (rolled, not
computed) are equal (a masked GPS row's index excepted: the port keeps it
at pose 0, msst_tpu lets it run below 0).  Poses, measurements and the marginal prior's
information agree to 1e-5 (float32 rounding of the same 6x6 algebra in
another order).  The moment tables' keys and counts are equal; their
position sums to 4 float32 ULPs of the largest prefix sum of the table
(6.1e-5 m on the surf table here): msst_tpu sums merged cells as
differences of float32 prefix sums over the table, rounding at the
prefix's magnitude, where the port sums each cell's rows directly.  The step-by-step drives take
tests/test_torch_slice.py's step tolerances (voxel 1e-4; knn its KNN_STEP,
whose docstring gives the reason)."""

import dataclasses

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
from tests.test_torch_slice import (KNN_STEP, _assert_step_matches, _feed,
                                    _reference_step)

K = 3
N_SCANS = 34
# least share of registered voxel steps with equal Gauss-Newton iterations:
# the voxel GN stops on a cost plateau, and a step whose plateau test sits
# on its threshold stops one iteration apart (measured: 1 of 34 recorded
# steps, an ordinary one, 4 against 3 iterations, pose 3.4e-5 apart)
VOXEL_SAME_ITERATIONS = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (as tests/test_torch_slice.py
    does: the suite's parallel workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(method):
    kw = dict(loop_closure_enabled=False, max_keyframes=K,
              scan2map_method=method)
    return jtiny(**kw), ttiny(**kw)


def _record(method):
    """msst_tpu's LioSam over the N_SCANS-scan circle drive (seed 5) with a
    K-keyframe store, every step call recorded as (state, points, aux,
    output) in numpy."""
    p, _ = _params(method)
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
def voxel_calls():
    return _record("voxel")


@pytest.fixture(scope="module")
def knn_calls():
    return _record("knn")


def _evictions(calls):
    """Indices of the recorded steps that evicted (a keyframe step from a
    full store)."""
    return [n for n, (state, _, _, out) in enumerate(calls)
            if bool(out.is_keyframe) and int(state.kf.count) == K]


@pytest.mark.parametrize("method", ["voxel", "knn"])
def test_step_by_step_with_eviction(method, voxel_calls, knn_calls):
    """Every recorded step through the port's step, the evicting ones
    included: same keyframe decision and count, pose within the slice's
    tolerance, and after each eviction the same graph indices and masks."""
    calls = voxel_calls if method == "voxel" else knn_calls
    _, p = _params(method)
    tol = dict(same_iterations=False) if method == "voxel" else KNN_STEP
    evicting = _evictions(calls)
    assert len(evicting) >= 3
    n_reg = n_same = 0
    for n, (state_np, points, aux, want) in enumerate(calls):
        state = convert.from_numpy(state_np, "cpu")
        new, got = tmap.odometry_step_packed(
            state, torch.from_numpy(np.array(points)),
            torch.from_numpy(np.array(aux)), p)
        _assert_step_matches(got, want, **tol)
        n_reg += int(want.s2m_iterations) > 0
        n_same += (int(want.s2m_iterations) > 0
                   and int(got.s2m_iterations) == int(want.s2m_iterations))
        if n in evicting and n + 1 < len(calls):
            after = calls[n + 1][0]
            g, w = convert.to_numpy(new.graph), after.graph
            for f in ("i", "j", "mask"):
                np.testing.assert_array_equal(getattr(g.betweens, f),
                                              getattr(w.betweens, f))
            np.testing.assert_array_equal(g.priors.mask, w.priors.mask)
            np.testing.assert_array_equal(g.gps.mask, w.gps.mask)
    if method == "voxel":
        assert n_same / n_reg >= VOXEL_SAME_ITERATIONS


def _hand_state(calls, baked):
    """A full-store state of the voxel drive with, added by hand: loop
    factors at i == 0 (0 -> 2) and at j == 0 (2 -> 0), a reversed 1 -> 0
    factor, GPS factors on slot 0 and slot 2; slot 0 baked or not."""
    n = _evictions(calls)[0]
    st = jax.tree.map(np.array, calls[n][0])
    rng = np.random.default_rng(4)
    g = st.graph
    b = g.betweens
    q, t = g.poses.q, g.poses.t
    for row, (i, j) in zip(range(K - 1, K + 2), ((0, 2), (2, 0), (1, 0))):
        # the current relative pose, perturbed: a residual the solve sees
        b.i[row], b.j[row] = i, j
        dq = np.concatenate([[1.0], rng.normal(0, 0.01, 3)])
        b.meas.q[row] = dq / np.linalg.norm(dq)
        b.meas.t[row] = (t[j] - t[i]) + rng.normal(0, 0.05, 3)
        b.sqrt_info[row] = rng.uniform(1.0, 20.0, 6)
        b.mask[row] = True
    gps = g.gps
    for row, idx in ((0, 0), (1, 2)):
        gps.idx[row] = idx
        gps.xyz[row] = t[idx] + rng.normal(0, 0.1, 3)
        gps.sqrt_info[row] = rng.uniform(0.5, 2.0, 3)
        gps.mask[row] = True
    st = st._replace(n_gps=np.asarray(2, np.int32),
                     n_loop=np.asarray(3, np.int32))
    st.kf.baked[0] = baked
    assert bool(st.local_map.valid)
    return st


@pytest.mark.parametrize("baked", [True, False])
def test_evict_matches_reference(voxel_calls, baked):
    """The port's _evict_oldest_keyframe against msst_tpu's (jitted) on a
    state carried over by convert.from_numpy, with the hand-added factors
    of _hand_state."""
    st = _hand_state(voxel_calls, baked)
    p_j, p_t = _params("voxel")
    want = jax.tree.map(np.asarray, jax.jit(
        jmap._evict_oldest_keyframe, static_argnames=("p",))(st, p=p_j))
    got = convert.to_numpy(tmap._evict_oldest_keyframe(
        convert.from_numpy(st, "cpu"), p_t))

    kf_g, kf_w = got.kf, want.kf
    for f in ("corner_xyz", "corner_mask", "surf_xyz", "surf_mask", "count",
              "baked", "time"):
        np.testing.assert_array_equal(getattr(kf_g, f), getattr(kf_w, f))
    np.testing.assert_allclose(kf_g.pose6, kf_w.pose6, atol=1e-5)
    np.testing.assert_allclose(kf_g.baked_pose6, kf_w.baked_pose6, atol=1e-5)

    g, w = got.graph, want.graph
    np.testing.assert_allclose(g.poses.q, w.poses.q, atol=1e-5)
    np.testing.assert_allclose(g.poses.t, w.poses.t, atol=1e-5)
    for tab in ("priors", "betweens", "gps"):
        tg, tw = getattr(g, tab), getattr(w, tab)
        for f in tg._fields:
            a, e = getattr(tg, f), getattr(tw, f)
            if f == "idx" and tab == "gps":
                # a masked GPS row points at pose 0 in the port; msst_tpu
                # shifts it below 0 (its gathers clamp)
                np.testing.assert_array_equal(a[tw.mask], e[tw.mask])
                assert np.all(a[~tw.mask] == 0)
            elif f in ("idx", "i", "j", "mask"):
                np.testing.assert_array_equal(a, e, err_msg=f"{tab}.{f}")
            elif f == "meas":
                np.testing.assert_allclose(a.q, e.q, atol=1e-5)
                np.testing.assert_allclose(a.t, e.t, atol=1e-5)
            else:
                np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{tab}.{f}")
    # the reparented loops, the masked self-factor, the shifted GPS
    assert list(g.betweens.mask[K - 1:K + 2]) == [True, True, False]
    assert list(g.gps.mask[:2]) == [False, True] and g.gps.idx[1] == 1
    # the marginal prior is no longer the first keyframe's prior
    assert not np.allclose(g.priors.sqrt_info[0], st.graph.priors.sqrt_info[0])

    for name in ("corner_mom", "surf_mom"):
        mg, mw = getattr(got.local_map, name), getattr(want.local_map, name)
        np.testing.assert_array_equal(mg.key, mw.key)
        np.testing.assert_array_equal(mg.cnt, mw.cnt)
        # msst_tpu's cell sums round at the magnitude of its float32 prefix
        # over the table (measured: 2 ULPs of it at most)
        prefix = np.abs(np.cumsum(getattr(st.local_map, name).rsum, 0)).max()
        np.testing.assert_allclose(mg.rsum, mw.rsum, rtol=0,
                                   atol=4 * np.spacing(np.float32(prefix)))
    before = st.local_map.surf_mom.cnt.sum()
    after = got.local_map.surf_mom.cnt.sum()
    assert (after < before) if baked else (after == before)


def test_evict_cg_solver_drive():
    """A drive that fills a 3-keyframe store solved by the CG solver (the
    solver of the default 1024-keyframe store) on the CPU: every eviction
    keeps the store full and the poses finite."""
    _, p = _params("voxel")
    p = dataclasses.replace(p, graph_solver="cg", graph_lazy_solve=False)
    from msst_torch.models.liosam import LioSam

    lio = LioSam(p, device="cpu")
    data = sim.make_dataset(sim.World(), sim.SimTrajectory(kind="circle"),
                            n_scans=30, scan_dt=0.1, n_scan=16, horizon=360,
                            seed=5)
    counts = [int(_feed(lio, s).kf_count) for s in data]
    assert max(counts) == K and counts[-1] == K
    traj = lio.trajectory.as_matrices()
    assert np.isfinite(traj).all()
