"""Loop closure and the CG pose-graph solver of the port against msst_tpu.

Module by module on numpy inputs from a seed: ``se3.matrix_to_quat``,
``linalg.weighted_kabsch``, ``knn.nearest1_brute``, the brute ICP and its
curvature probes, ``graph.optimize_cg``; then ``loop.loop_closure_step``
from one state of the shuttle drive of tests/test_liosam_incmap.py (50
scans, seed 4: the robot comes back past its start), the port's
``LioSam(device="cpu")`` with loop closure on over that drive, and the
drive's steps with the CG solver held step by step.

msst_tpu's ``odometry_core`` cannot be traced at HEAD (it reads an
undefined ``inp``; see tests/test_torch_slice.py), so the reference drive
runs through a test-local jitted step that binds ``mapping.inp = ps`` only
while it traces.  ``loop_closure_step`` itself does not read it: it is
called as it is, on a copy of the recorded state (it donates its input).

Tolerances, each with its reason:

* ICP: the correspondence sweep expands ``|q|^2 - 2 q.x + |x|^2`` and the
  two packages round that 3-term product differently, so near-equal
  neighbours can swap; poses agree to 1e-4 m / rad on clouds whose
  neighbours are well apart, and to 2e-3 on noisy ones.
* loop_closure_step: ``found``, ``cand`` (where found), ``n_loop``, the
  coarse ICP's iterations, the loop factor's slot and endpoints are equal;
  the fitness to 2e-4 relative, the factor's information to 1e-3, the
  keyframe poses after the 7-iteration re-solve and the baked poses to
  1e-4 m / rad (measured 1.7e-6).
* CG: 1e-4 m on the 4-pose loop graph, 1e-3 m / rad on the 64-pose ring
  (50 f32 CG iterations in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rs

import bench
from msst_torch import convert
from msst_torch.models.liosam import LioSam as TLioSam
from msst_torch.models.liosam import loop as tloop
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.ops import graph as tgraph
from msst_torch.ops import knn as tknn
from msst_torch.ops import linalg as tlinalg
from msst_torch.ops import registration as treg
from msst_torch.ops import se3 as tse3
from msst_torch.utils.ring_graph import make_ring_graph
from msst_tpu.models.liosam import loop as jloop
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam import pipeline as jpipe
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.ops import graph as jgraph
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import linalg as jlinalg
from msst_tpu.ops import registration as jreg
from msst_tpu.ops import se3 as jse3
from msst_tpu.utils import sim

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small and many: with the suite's parallel
    workers, each torch intra-op pool of one thread per core oversubscribes
    the CPU and slows every worker.  One thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(21)
J, T = jnp.asarray, torch.from_numpy

# the shuttle drive of test_incremental_loop_closure_rebakes; the drive's
# graph uses the CG solver at every keyframe, so its steps check it too
SHUTTLE = dict(map_update="incremental", history_keyframe_search_time_diff=3.0,
               history_keyframe_search_num=3, loop_closure_frequency=1.0)
DRIVE = dict(SHUTTLE, graph_solver="cg", graph_lazy_solve=False)
# the loop attempts fit their voxel planes with the bench profile's
# plane_min_spread: at the tiny profile's 0, 3-point planes of near-collinear
# points have normals set by rounding (tests/test_torch_slice.py), which
# moved the "plane" fine stage's result by 6.6e-4 m between the packages
# (fitness 0.9 %); at 0.05 the gap is 7e-7 m
LOOP = dict(DRIVE, vox_plane_min_spread=0.05)
LOOP_CASES = [("plane", 0.05), ("plane", 0.0), ("p2p", 0.05), ("p2p", 0.0)]
LOOP_POSE_ATOL = 1e-4
FIT_RTOL = 2e-4
STEP_POSE_ATOL = 1e-4


def _pose_np(rpy, t):
    return (Rs.from_euler("xyz", rpy).as_matrix().astype(np.float32),
            np.asarray(t, np.float32))


def _jpose(m):
    return jse3.Pose(jse3.matrix_to_quat(J(m[0])), J(m[1]))


def _tpose(m):
    return tse3.Pose(tse3.matrix_to_quat(T(m[0])), T(m[1]))


def _pose_close(got, want, atol):
    """Same rotation (up to the quaternion's sign) and translation."""
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=atol)
    dot = np.abs(np.sum(got.q.numpy() * np.asarray(want.q), axis=-1))
    np.testing.assert_allclose(dot, 1.0, atol=atol)


# ---------------------------------------------------------------------------
# se3, linalg, nearest neighbours
# ---------------------------------------------------------------------------


def test_matrix_to_quat_matches_jax():
    """Random rotations and ones whose largest pivot is each of the four
    decodes (angles near pi about x, y, z), to 1e-6."""
    rots = [Rs.random(256, random_state=3).as_matrix()]
    for axis in np.eye(3):
        rots.append(Rs.from_rotvec(np.outer([3.1, np.pi, -3.13], axis))
                    .as_matrix())
    R = np.concatenate(rots).astype(np.float32)
    want = np.asarray(jse3.matrix_to_quat(J(R)))
    got = tse3.matrix_to_quat(T(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    back = tse3.quat_to_matrix(T(got)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-5)


@pytest.mark.parametrize("reflect", [False, True])
def test_weighted_kabsch_matches_jax(reflect):
    """(R, t) to 1e-5 on 500 weighted pairs (a third of the weights 0); the
    reflected case makes the det correction flip the last axis."""
    src = RNG.uniform(-5, 5, (500, 3)).astype(np.float32)
    R, t = _pose_np([0.2, -0.1, 0.7], [1.0, -2.0, 0.5])
    dst = src @ R.T + t + RNG.normal(scale=0.01, size=src.shape)
    if reflect:
        dst[:, 2] *= -1.0
    dst = dst.astype(np.float32)
    w = (RNG.random(500) > 0.33).astype(np.float32)
    jr, jt = jlinalg.weighted_kabsch(J(src), J(dst), J(w))
    tr, tt = tlinalg.weighted_kabsch(T(src), T(dst), T(w))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    assert abs(np.linalg.det(tr.numpy()) - 1.0) < 1e-5


@pytest.mark.parametrize("chunk", [8192, 64])
def test_nearest1_brute_matches_jax(chunk):
    """1000 masked queries against 3001 masked targets (not a multiple of
    either chunk).  Indices equal wherever the float64 best and second-best
    squared distances are more than 1e-3 apart (the expansion's rounding,
    ~1e-5 at these magnitudes, can swap only closer pairs: measured none);
    squared distances to 1e-4 of JAX's and of float64's; masked queries
    invalid with inf."""
    tgt = RNG.uniform(-10, 10, (3001, 3)).astype(np.float32)
    tm = RNG.random(3001) > 0.1
    q = RNG.uniform(-11, 11, (1000, 3)).astype(np.float32)
    qm = RNG.random(1000) > 0.2
    want = jknn.nearest1_brute(J(tgt), J(tm), J(q), J(qm), chunk=chunk)
    got = tknn.nearest1_brute(T(tgt), T(tm), T(q), T(qm), chunk=chunk)
    d64 = np.sum((q[:, None, :].astype(np.float64) - tgt[None]) ** 2, axis=2)
    d64[:, ~tm] = np.inf
    two = np.sort(d64, axis=1)[:, :2]
    apart = qm & (two[:, 1] - two[:, 0] > 1e-3)
    assert apart.sum() > 700
    np.testing.assert_array_equal(got.idx.numpy()[apart, 0],
                                  np.asarray(want.idx)[apart, 0])
    np.testing.assert_array_equal(got.idx.numpy()[apart, 0],
                                  np.argmin(d64, axis=1)[apart])
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.valid.numpy()[:, 0], qm)
    assert np.all(np.isinf(got.sqdist.numpy()[~qm]))
    np.testing.assert_allclose(got.sqdist.numpy()[qm],
                               np.asarray(want.sqdist)[qm], atol=1e-4)
    np.testing.assert_allclose(got.sqdist.numpy()[qm, 0], two[qm, 0],
                               atol=1e-4)


# ---------------------------------------------------------------------------
# brute ICP (mirrors tests/test_registration.py on the brute path, and each
# case against msst_tpu on the same clouds)
# ---------------------------------------------------------------------------


def _icp_both(src, sm, tgt, tm, **kw):
    want = jreg.icp_point2point_brute(J(src), J(sm), J(tgt), J(tm),
                                      jse3.Pose.identity(), **kw)
    got = treg.icp_point2point_brute(T(src), T(sm), T(tgt), T(tm),
                                     tse3.Pose.identity(), **kw)
    return got, want


@pytest.mark.parametrize("masked", [False, True])
def test_icp_brute_recovers_transform(masked):
    """test_registration.py:95-111 on the brute path (all targets: the
    transform to 1e-3 / 5e-3, fitness < 1e-4) and :301-321 (1/13 of the
    targets masked, so their sources match ~0.9 m away and the fitness
    stays under 0.2; on this draw the pose lands within 2e-3 / 1e-2).  Both
    against JAX: the same iteration count, its pose to 1e-4, its fitness to
    1e-3 relative or 5e-6 absolute (at a perfect fit the fitness is the
    expansion's rounding, ~1e-6 for coordinates of 5 m)."""
    pts = RNG.uniform(-5, 5, size=(1500, 3)).astype(np.float32)
    R, t = _pose_np([0.03, 0.02, 0.1], [0.3, -0.1, 0.2])
    tgt = (pts @ R.T + t).astype(np.float32)
    tm = np.ones(len(tgt), bool)
    if masked:
        tm[::13] = False
    got, want = _icp_both(pts, np.ones(1500, bool), tgt, tm, max_iters=50,
                          max_corr_dist=2.0, chunk=512)
    Tm = got.pose.to_matrix().numpy()
    np.testing.assert_allclose(Tm[:3, :3], R, atol=2e-3 if masked else 1e-3)
    np.testing.assert_allclose(Tm[:3, 3], t, atol=1e-2 if masked else 5e-3)
    assert float(got.fitness) < (0.2 if masked else 1e-4)
    assert bool(got.converged)
    assert int(got.iters) == int(want.iters)
    _pose_close(got.pose, want.pose, 1e-4)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               rtol=1e-3, atol=5e-6)
    np.testing.assert_allclose(float(got.matched_frac),
                               float(want.matched_frac), atol=1e-6)


def test_icp_brute_converges_early_not_at_iteration_cap():
    """test_registration.py:114-136 on the brute path: PCL's criteria stop
    a noisy alignment long before the cap, at the cap-bound run's pose; the
    cap-bound run ends at 100 iterations in both packages, the early stop
    within 2 iterations of JAX's, at its pose to 2e-3."""
    pts = RNG.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
    R, t = _pose_np([0.02, -0.03, 0.08], [0.2, 0.1, -0.15])
    tgt = (pts @ R.T + t + 0.01 * RNG.normal(size=pts.shape)).astype(np.float32)
    sm, tm = np.ones(2000, bool), np.ones(2000, bool)
    kw = dict(max_iters=100, max_corr_dist=2.0, chunk=1024)
    res, want = _icp_both(pts, sm, tgt, tm, **kw)
    full, want_full = _icp_both(pts, sm, tgt, tm, transformation_eps=0.0,
                                rel_mse_eps=0.0, abs_mse_eps=0.0, **kw)
    assert int(full.iters) == int(want_full.iters) == 100
    assert int(res.iters) < 40
    assert abs(int(res.iters) - int(want.iters)) <= 2
    np.testing.assert_allclose(res.pose.to_matrix().numpy(),
                               full.pose.to_matrix().numpy(), atol=2e-3)
    np.testing.assert_allclose(float(res.fitness), float(full.fitness),
                               rtol=0.1, atol=1e-5)
    _pose_close(res.pose, want.pose, 2e-3)
    _pose_close(full.pose, want_full.pose, 2e-3)


def test_icp_brute_fitness_reflects_mismatch():
    """test_registration.py:139-147: random clouds cannot align; the
    fitness agrees with JAX's to 1e-4 relative."""
    src = RNG.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    tgt = RNG.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    m = np.ones(500, bool)
    got, want = _icp_both(src, m, tgt, m, max_iters=10, max_corr_dist=2.0,
                          chunk=128)
    assert float(got.fitness) > 1e-3
    assert int(got.iters) == int(want.iters)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               rtol=1e-4)


def _curvature_both(src, tgt, pose_np=None, compare=True, **kw):
    jp = jse3.Pose.identity() if pose_np is None else _jpose(pose_np)
    tp = tse3.Pose.identity() if pose_np is None else _tpose(pose_np)
    jk, jc = jreg.icp_curvature_brute(J(src), J(np.ones(len(src), bool)),
                                      J(tgt), J(np.ones(len(tgt), bool)), jp,
                                      **kw)
    tk, tc = treg.icp_curvature_brute(T(src), T(np.ones(len(src), bool)),
                                      T(tgt), T(np.ones(len(tgt), bool)), tp,
                                      **kw)
    if compare:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4,
                                   atol=1e-6)
    return tk.numpy(), float(tc)


def test_icp_curvature_flags_corridor_axis():
    """test_registration.py:380-405: near-zero curvature along a corridor,
    strong across it; kappa equal to JAX's to 1e-3 relative."""
    n = 1200
    x = RNG.uniform(-12, 12, n).astype(np.float32)
    y = np.where(RNG.integers(0, 2, n), 2.0, -2.0).astype(np.float32)
    z = RNG.uniform(0, 3, n).astype(np.float32)
    pts = np.stack([x, y + RNG.normal(scale=0.01, size=n).astype(np.float32),
                    z], axis=1)
    k, _ = _curvature_both(pts[: n // 2], pts, max_corr_dist=2.0, chunk=512)
    assert k[3] < 0.05 * k[4], k


def test_icp_curvature_translation_invariant():
    """test_registration.py:408-441: rotation probes about the cloud's
    centroid make kappa independent of the scene's offset.  Against JAX at
    the origin (also from a pose off the identity), not at the 430 m offset:
    there |q|^2 ~ 2e5 and the expansion's rounding (~1e-2 m^2) differs
    between the packages by as much as the invariance tolerance allows."""
    n = 600
    x = RNG.uniform(-10, 10, n)
    y = np.where(RNG.integers(0, 2, n), 2.0, -2.0)
    walls = np.stack([x, y, RNG.uniform(0, 3, n)], axis=1)
    floor = np.stack([RNG.uniform(-10, 10, n), RNG.uniform(-2, 2, n),
                      np.zeros(n)], axis=1)
    th = RNG.uniform(0, 2 * np.pi, 200)
    pillar = np.stack([5.0 + 0.3 * np.cos(th), 0.3 * np.sin(th),
                       RNG.uniform(0, 3, 200)], axis=1)
    pts = np.concatenate([walls, floor, pillar]).astype(np.float32)
    k0, _ = _curvature_both(pts[::2], pts, max_corr_dist=2.0, chunk=512)
    off = (pts + np.float32([400.0, -150.0, 0.0])).astype(np.float32)
    k1, _ = _curvature_both(off[::2], off, compare=False, max_corr_dist=2.0,
                            chunk=512)
    assert np.all(k0[:3] > 0.0), k0
    np.testing.assert_allclose(k1, k0, rtol=0.35, atol=1e-4)
    _curvature_both(pts[::2], pts, pose_np=_pose_np([0.01, 0.0, 0.02],
                                                    [0.05, -0.02, 0.0]),
                    max_corr_dist=2.0, chunk=512)


def test_icp_curvature_lost_correspondences_saturate():
    """test_registration.py:444-460: a probe that loses every match costs
    max_corr_dist**2, so kappa is large, as in JAX."""
    pts = RNG.normal(scale=0.1, size=(200, 3)).astype(np.float32)
    k, c0 = _curvature_both(pts[::2], pts, max_corr_dist=0.5, delta_t=1.5,
                            chunk=256)
    assert c0 < 0.05
    assert np.all(k[3:] > 0.05), k


# ---------------------------------------------------------------------------
# the CG pose-graph solver
# ---------------------------------------------------------------------------


def _loop_graph_np():
    """The square loop of tests/test_graph.py:137 (4 poses, prior, 3 chain
    factors and the closing one, drifted initial positions)."""
    gt_pts = np.array([[0, 0, 0], [10, 0, 0], [10, 10, 0], [0, 10, 0]],
                      np.float32)
    g = jgraph.empty_graph(8, 2, 8, 2)
    rng = np.random.default_rng(3)
    drift = np.cumsum(rng.normal(scale=0.3, size=(4, 3)), axis=0)
    t = np.zeros((8, 3), np.float32)
    t[:4] = gt_pts + drift
    nxt = [1, 2, 3, 0]
    meas_t = np.zeros((8, 3), np.float32)
    meas_t[:4] = gt_pts[nxt] - gt_pts
    b = g.betweens._replace(
        i=J(np.array([0, 1, 2, 3, 0, 0, 0, 0], np.int32)),
        j=J(np.array(nxt + [0] * 4, np.int32)),
        meas=jse3.Pose(g.betweens.meas.q, J(meas_t)),
        sqrt_info=jnp.full((8, 6), 10.0),
        mask=J(np.arange(8) < 4))
    g = g._replace(poses=jse3.Pose(g.poses.q, J(t)),
                   pose_mask=J(np.arange(8) < 4), betweens=b,
                   priors=g.priors._replace(
                       sqrt_info=g.priors.sqrt_info.at[0].set(1e4),
                       mask=J(np.array([True, False]))))
    return jax.tree.map(np.asarray, g), gt_pts


def test_optimize_cg_matches_jax_on_loop_graph():
    """CG (10 GN iterations of 60 CG steps) lands on the truth to 2e-2 as
    test_graph.py:137 asks, and on JAX's poses to 1e-4."""
    gnp, gt_pts = _loop_graph_np()
    want = jgraph.optimize_cg(jax.tree.map(J, gnp), iters=10, cg_iters=60)
    got = tgraph.optimize_cg(convert.from_numpy(gnp, "cpu"), iters=10,
                             cg_iters=60)
    np.testing.assert_allclose(got.poses.t.numpy()[:4], gt_pts, atol=2e-2)
    _pose_close(got.poses, want.poses, 1e-4)


def test_optimize_cg_matches_jax_on_ring_graph():
    """The 64-pose ring of bench.py's graph-scale phase: the port's copy of
    the generator gives bench.py's graph to 1e-6; CG (5 x 50) with a free
    mask gives JAX's poses to 1e-3, and lowers the error like the dense
    solve does."""
    jg = bench._make_ring_graph(64)
    tg = make_ring_graph(64)
    for w, g in zip(jax.tree.leaves(jax.tree.map(np.asarray, jg)),
                    jax.tree.leaves(convert.to_numpy(tg))):
        np.testing.assert_allclose(g, w, atol=1e-6)
    free = np.arange(64) > 0
    want = jgraph.optimize_cg(jg, free_mask=J(free), iters=5)
    got = tgraph.optimize_cg(tg, free_mask=T(free), iters=5)
    _pose_close(got.poses, want.poses, 1e-3)
    np.testing.assert_array_equal(got.poses.t.numpy()[0], tg.poses.t.numpy()[0])
    dense = tgraph.optimize(tg, free_mask=T(free), iters=5)
    _pose_close(got.poses, dense.poses, 1e-2)


# ---------------------------------------------------------------------------
# the shuttle drive: loop_closure_step, the pipeline, the CG step
# ---------------------------------------------------------------------------


def _reference_step(state, points, aux, p):
    ps = jmap.prepare_scan(jmap.unpack_step_input(points, aux, p), p)
    jmap.inp = ps   # the name msst_tpu's odometry_core reads; see docstring
    try:
        return jmap.odometry_core(state, ps, p)
    finally:
        del jmap.inp


def _shuttle_data():
    return sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="shuttle", speed=3.0,
                                              period=5.0),
                            n_scans=50, scan_dt=0.1, n_scan=16, horizon=360,
                            seed=4)


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


@pytest.fixture(scope="module")
def shuttle():
    """msst_tpu over the shuttle drive (loop closure off, CG solver at every
    keyframe), recording every step call; then msst_tpu's loop_closure_step
    from the final state for each LOOP_CASES entry.  Everything JAX is
    computed here once (the suite drops compiled programs every 25 tests)."""
    data = _shuttle_data()
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
        lio = jpipe.LioSam(jtiny(loop_closure_enabled=False, **DRIVE))
        for s in data:
            _feed(lio, s)
        lio.flush()
    finally:
        mp.undo()
    state = jax.tree.map(np.asarray, lio.state)
    loops = {}
    for fine, ratio in LOOP_CASES:
        p = jtiny(loop_closure_enabled=True, loop_fine=fine,
                  loop_degeneracy_ratio=ratio, **LOOP)
        new, res = jloop.loop_closure_step(jax.tree.map(J, state), p)
        loops[fine, ratio] = (jax.tree.map(np.asarray, new),
                              jax.tree.map(np.asarray, res))
    return dict(data=data, calls=calls, state=state, loops=loops)


@pytest.mark.parametrize("fine,ratio", LOOP_CASES)
def test_loop_closure_step_matches_reference(shuttle, fine, ratio):
    """One loop attempt from the drive's final state (9 keyframes; the
    newest is back near the first).  The old state is not written."""
    want_state, want = shuttle["loops"][fine, ratio]
    p = ttiny(loop_closure_enabled=True, loop_fine=fine,
              loop_degeneracy_ratio=ratio, **LOOP)
    before = convert.from_numpy(shuttle["state"], "cpu")
    kept = [x.clone() for x in jax.tree.leaves(before)]
    new, got = tloop.loop_closure_step(before, p)
    for a, b in zip(jax.tree.leaves(before), kept):
        assert torch.equal(a, b)
    got_state = convert.to_numpy(new)
    assert bool(want.found) and bool(got.found)
    assert int(got.cur) == int(want.cur)
    assert int(got.cand) == int(want.cand)
    assert int(got.icp_iters) == int(want.icp_iters)
    assert int(got.tried) >= 1
    # carried across, msst_tpu's result has no `tried`: it keeps its default
    assert convert.from_numpy(want, "cpu").tried is None
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               rtol=FIT_RTOL)
    assert int(got_state.n_loop) == int(want_state.n_loop) == 1
    assert bool(got_state.loop_closed)
    b_w, b_g = want_state.graph.betweens, got_state.graph.betweens
    for f in ("i", "j", "mask"):
        np.testing.assert_array_equal(getattr(b_g, f), getattr(b_w, f))
    slot = int(np.flatnonzero(b_w.i == want.cur)[-1])
    assert b_w.j[slot] == want.cand
    np.testing.assert_allclose(b_g.sqrt_info[slot], b_w.sqrt_info[slot],
                               rtol=1e-3)
    n = int(want_state.kf.count)
    for name in ("pose6", "baked_pose6"):
        np.testing.assert_allclose(getattr(got_state.kf, name)[:n],
                                   getattr(want_state.kf, name)[:n],
                                   atol=LOOP_POSE_ATOL)
    np.testing.assert_array_equal(got_state.kf.baked, want_state.kf.baked)
    np.testing.assert_allclose(got_state.pose6, want_state.pose6,
                               atol=LOOP_POSE_ATOL)
    # the loop moved the history (the re-solve ran)
    moved = np.abs(got_state.kf.pose6[:n] - shuttle["state"].kf.pose6[:n])
    assert moved.max() > 1e-3


def test_loop_closure_step_without_candidate_is_a_no_op(shuttle):
    """A session younger than the age gate: no candidate, no attempt, the
    same state returned, found False with inf fitness."""
    p = ttiny(loop_closure_enabled=True,
              **dict(DRIVE, history_keyframe_search_time_diff=300.0))
    state = convert.from_numpy(shuttle["state"], "cpu")
    new, res = tloop.loop_closure_step(state, p)
    assert new is state
    assert not bool(res.found) and np.isinf(float(res.fitness))
    assert int(res.tried) == 0
    assert int(res.cur) == int(state.kf.count) - 1


def test_cg_drive_steps_match_reference(shuttle):
    """Each recorded step of the drive (the CG solve at every keyframe)
    through the port's step: same keyframe decision and keyframe count,
    pose to 1e-4 m / rad, and the keyframe poses after the step equal to
    the next recorded state's to 1e-4 (measured 1.4e-6 and 5.8e-7)."""
    p = ttiny(loop_closure_enabled=False, **DRIVE)
    calls = shuttle["calls"]
    n_kf = 0
    for k, (state_np, points, aux, want) in enumerate(calls):
        new, got = tmap.odometry_step_packed(
            convert.from_numpy(state_np, "cpu"), T(points), T(aux), p)
        assert bool(got.is_keyframe) == bool(want.is_keyframe)
        assert int(got.kf_count) == int(want.kf_count)
        np.testing.assert_allclose(got.pose6.numpy(), want.pose6,
                                   atol=STEP_POSE_ATOL)
        nxt = calls[k + 1][0].kf if k + 1 < len(calls) else None
        if want.is_keyframe and nxt is not None and nxt.count == want.kf_count:
            n = int(want.kf_count)
            np.testing.assert_allclose(new.kf.pose6.numpy()[:n],
                                       nxt.pose6[:n], atol=STEP_POSE_ATOL)
            n_kf += 1
    assert n_kf >= 5


def test_liosam_closes_loop_on_shuttle_drive():
    """The port's pipeline with loop closure on (an attempt every 10 scans
    behind the host pre-gate), over the shuttle drive: a loop closes, the
    trajectory stays within 1 m of the truth, and the recorded poses of the
    keyframe scans are rewritten from the optimized keyframes."""
    data = _shuttle_data()
    lio = TLioSam(ttiny(loop_closure_enabled=True, **SHUTTLE), device="cpu")
    calls = []
    real = lio._try_loop_closure

    def counting():
        calls.append(lio._scan_count)
        real()

    lio._try_loop_closure = counting
    for s in data:
        _feed(lio, s)
    traj = lio.trajectory
    assert calls == [10, 20, 30, 40, 50]
    assert int(lio.state.n_loop) >= 1
    assert not lio._resync_needed and not lio._pending_loops
    gt = np.stack([s["gt_pose"][:3, 3] - data[0]["gt_pose"][:3, 3]
                   for s in data])
    est = traj.as_matrices()[:, :3, 3]
    assert est.shape == gt.shape
    assert np.linalg.norm(est - gt, axis=1).max() < 1.0
    kf = convert.to_numpy(lio.state.kf)
    n = int(kf.count)
    t_abs = kf.time[:n].astype(np.float64) + lio._epoch
    rows = [int(np.argmin(np.abs(np.asarray(traj.times) - t))) for t in t_abs]
    want = tse3.Pose.from_vec6(T(kf.pose6[:n])).to_matrix().numpy()
    np.testing.assert_allclose(traj.as_matrices()[rows], want, atol=1e-6)


def test_host_loop_gate_skips_impossible_dispatches():
    """The pre-gate cases of tests/test_liosam.py:121-157 on the port: skip
    a session younger than the age gate and one whose old poses all lie
    outside the radius; dispatch on a revisit and when nothing is flushed."""
    lio = TLioSam(ttiny(loop_closure_enabled=True,
                        history_keyframe_search_time_diff=3.0,
                        history_keyframe_search_radius=2.0), device="cpu")

    def fake(times, positions, t_cur):
        lio._epoch = times[0]
        lio._last_scan_time = t_cur
        lio._trajectory.times = list(times)
        lio._trajectory.poses = []
        for pos in positions:
            m = np.eye(4)
            m[:3, 3] = pos
            lio._trajectory.poses.append(m)

    fake([100.0, 100.5], [[0, 0, 0], [1, 0, 0]], 102.0)
    assert lio._loop_plausible() is False
    ts = [100.0 + 0.1 * i for i in range(100)]
    ps = [[2.0 * 0.1 * i, 0, 0] for i in range(100)]
    fake(ts, ps, ts[-1])
    assert lio._loop_plausible() is False
    ps2 = list(ps)
    ps2[-1] = [0.5, 0, 0]
    fake(ts, ps2, ts[-1])
    assert lio._loop_plausible() is True
    lio._trajectory.times = []
    lio._trajectory.poses = []
    lio._last_scan_time = 200.0
    assert lio._loop_plausible() is True
