"""The calibration path's ops in the port (msst_torch) against msst_tpu, on
the CPU: ``linalg.inv3x3`` / ``solve3x3``, ``pointcloud.crop_box``,
``se3.Pose.from_rpy_xyz`` / ``so3_exp_matrix``, ``voxel.voxel_coords``, the
RANSAC module, ``registration.point_covariances`` / ``gicp`` /
``build_ndt_map`` / ``ndt`` and the Allan variance of ``ops.imu``.

On a CPU tensor every k-NN is kernel B2's plain twin (``knn.query_plain``);
``chip_smoke.py`` phase 3b holds the kernel bit-equal to it on the card.

RANSAC: torch cannot reproduce ``jax.random``'s bits, so the tests replace
the port's one draw function (``ransac.draw_hypotheses``) by one that
returns the indices ``jax.random.choice`` draws for the same key, computed
here with msst_tpu's own calls; the fits are then compared exactly (counts,
the winning hypothesis, inlier masks) and their floats to 1e-6.

Tolerances, each stated where it is used: float32 ops of one formula agree
to 1e-6 (a few ULPs: XLA and PyTorch contract and order sums differently);
GICP and NDT poses to 1e-5 with equal iteration counts; the NDT map's means
to 1e-5 m and inverse covariances to 1e-3 relative (the voxel moments are
summed in another order: msst_tpu differences float32 prefix sums over the
whole sorted cloud, the port adds each voxel's rows in row order, and in
1 % of the voxels msst_tpu's sums are the ones far from float64); the
Allan variance of a 200,000-sample log to 1e-4 relative around 0 and 1e-2
around an offset (a float32 cumulative sum of the whole log, then second
differences; see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rs

from msst_torch import convert
from msst_torch.ops import imu as timu
from msst_torch.ops import knn as tknn
from msst_torch.ops import linalg as tlinalg
from msst_torch.ops import pointcloud as tpc
from msst_torch.ops import ransac as transac
from msst_torch.ops import registration as treg
from msst_torch.ops import se3 as tse3
from msst_torch.ops import voxel as tvoxel
from msst_tpu.ops import imu as jimu
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import linalg as jlinalg
from msst_tpu.ops import pointcloud as jpc
from msst_tpu.ops import ransac as jransac
from msst_tpu.ops import registration as jreg
from msst_tpu.ops import se3 as jse3
from msst_tpu.ops import voxel as jvoxel

F32_ATOL = 1e-6
POSE_ATOL = 1e-5
NDT_MEAN_ATOL = 1e-5
NDT_INV_RTOL = 1e-4
ALLAN_RTOL = 1e-4


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def N(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while the module runs: the suite's parallel workers
    would otherwise oversubscribe the CPU with one thread per core each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def structured_scene(rng, n=4000):
    """tests/test_calibration.py's scene: ground + two walls + 4 pillars
    (world frame), 1 cm noise."""
    g = rng.uniform(-15, 15, size=(n // 2, 2))
    ground = np.column_stack([g, np.zeros(n // 2)])
    w = rng.uniform(-15, 15, size=(n // 4, 2))
    wall1 = np.column_stack([w[:, 0], np.full(n // 4, 12.0), w[:, 1] % 4])
    w2 = rng.uniform(-15, 15, size=(n // 4, 2))
    wall2 = np.column_stack([np.full(n // 4, 13.5), w2[:, 0], w2[:, 1] % 4])
    pts = np.concatenate([ground, wall1, wall2])
    k = 400
    px = rng.uniform(-10, 10, size=(4, 2))
    pillars = np.concatenate([
        np.column_stack([np.full(k // 4, x), np.full(k // 4, y),
                         rng.uniform(0, 4, k // 4)]) for x, y in px])
    pts = np.concatenate([pts, pillars])
    return (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)


def view_from(pts, rpy, t):
    """World points in the frame of a sensor at pose (rpy, t)."""
    R = Rs.from_euler("xyz", rpy).as_matrix().astype(np.float32)
    return ((pts - np.asarray(t, np.float32)) @ R).astype(np.float32)


def jax_draw(key, mask, n_hyp):
    """The (3, n_hyp) indices msst_tpu's RANSAC draws with `key` over
    `mask` (ransac.py:60-65)."""
    n = mask.shape[0]
    probs = J(N(mask)).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    ks = jax.random.split(key, 3)
    idx = jax.vmap(lambda k: jax.random.choice(k, n, shape=(n_hyp,),
                                               p=probs))(jnp.stack(ks))
    return np.asarray(idx)


def use_jax_draws(monkeypatch, keys):
    """Make the port's draws those of msst_tpu with `keys`, one key per
    call, in call order."""
    it = iter(list(keys))

    def draw(mask, n_hyp, generator=None):
        return torch.from_numpy(jax_draw(next(it), mask, n_hyp)).long().to(
            mask.device)

    monkeypatch.setattr(transac, "draw_hypotheses", draw)


def assert_pose_close(jp, tp, atol=POSE_ATOL):
    np.testing.assert_allclose(N(tp.to_matrix()), N(jp.to_matrix()),
                               atol=atol)


# ---------------------------------------------------------------------------
# linalg, crop_box, se3, voxel_coords
# ---------------------------------------------------------------------------


def test_inv3x3_and_solve3x3():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(500, 3, 3)).astype(np.float32)
    A[:50] = A[:50] @ np.swapaxes(A[:50], 1, 2) + 1e-3 * np.eye(3)
    A[50:53] = 0.0                       # det 0: the +eps branch
    A[53, 2] = A[53, 0] + A[53, 1]       # rank 2
    b = rng.normal(size=(500, 3)).astype(np.float32)
    ji, ti = N(jlinalg.inv3x3(J(A))), N(tlinalg.inv3x3(T(A)))
    # 1e-5 relative: adjugate over a rounded determinant
    np.testing.assert_allclose(ti, ji, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(tlinalg.solve3x3(T(A), T(b))),
                               N(jlinalg.solve3x3(J(A), J(b))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("keep_inside", [True, False])
def test_crop_box(keep_inside):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-30, 30, (2000, 3)).astype(np.float32)
    mask = rng.random(2000) > 0.1
    lo, hi = (-20.0, -20.0, -20.0), (20.0, 10.0, 5.0)
    jc = jpc.crop_box(jpc.Cloud.create(J(xyz), mask=J(mask)), J(lo), J(hi),
                      keep_inside)
    tc = tpc.crop_box(tpc.Cloud.create(T(xyz), mask=T(mask)), lo, hi,
                      keep_inside)
    np.testing.assert_array_equal(N(tc.mask), N(jc.mask))


def test_pose_from_rpy_xyz_and_so3_exp_matrix():
    rng = np.random.default_rng(2)
    rpy = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    w = (rng.normal(size=(64, 3)) * np.array([[1.0], [1e-7]] * 32)).astype(
        np.float32)
    jp = jse3.Pose.from_rpy_xyz(J(rpy), J(xyz))
    tp = tse3.Pose.from_rpy_xyz(T(rpy), T(xyz))
    np.testing.assert_allclose(N(tp.q), N(jp.q), atol=F32_ATOL)
    np.testing.assert_array_equal(N(tp.t), N(jp.t))
    np.testing.assert_allclose(N(tse3.so3_exp_matrix(T(w))),
                               N(jse3.so3_exp_matrix(J(w))), atol=F32_ATOL)


def test_voxel_coords():
    rng = np.random.default_rng(3)
    xyz = (rng.uniform(-50, 50, (5000, 3)) * 0.999).astype(np.float32)
    xyz[:100] = np.round(xyz[:100] / 0.35) * 0.35     # on cell faces
    for leaf in (0.35, 1.0, 0.2):
        np.testing.assert_array_equal(N(tvoxel.voxel_coords(T(xyz), leaf)),
                                      N(jvoxel.voxel_coords(J(xyz), leaf)))


# ---------------------------------------------------------------------------
# RANSAC, with msst_tpu's draws
# ---------------------------------------------------------------------------


def _plane_cloud(rng, n_in=1500, n_out=500):
    uv = rng.uniform(-5, 5, (n_in, 2))
    plane = np.column_stack([uv, 0.2 * uv[:, 0] - 0.1 * uv[:, 1] + 1.0])
    plane += rng.normal(scale=0.01, size=plane.shape)
    pts = np.concatenate([plane, rng.uniform(-5, 5, (n_out, 3))])
    return pts.astype(np.float32), rng.random(len(pts)) > 0.05


def _assert_plane_fit_equal(jf, tf):
    np.testing.assert_array_equal(N(tf.inlier_mask), N(jf.inlier_mask))
    assert int(tf.inlier_count) == int(jf.inlier_count)
    assert bool(tf.ok) == bool(jf.ok)
    np.testing.assert_allclose(N(tf.normal), N(jf.normal), atol=F32_ATOL)
    np.testing.assert_allclose(float(tf.d), float(jf.d), atol=F32_ATOL)
    np.testing.assert_allclose(float(tf.rms), float(jf.rms), atol=F32_ATOL)


def test_draw_hypotheses_stays_in_the_mask():
    mask = torch.zeros(1000, dtype=torch.bool)
    mask[100:140] = True
    gen = torch.Generator().manual_seed(0)
    idx = transac.draw_hypotheses(mask, 300, gen)
    assert idx.shape == (3, 300) and bool(mask[idx].all())
    again = transac.draw_hypotheses(mask, 300,
                                    torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
    none = transac.draw_hypotheses(torch.zeros(50, dtype=torch.bool), 10, gen)
    assert int(none.min()) >= 0 and int(none.max()) < 50


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_plane_with_jax_draws(monkeypatch, seed):
    pts, mask = _plane_cloud(np.random.default_rng(10 + seed))
    key = jax.random.PRNGKey(seed)
    jf = jransac.ransac_plane(J(pts), J(mask), key, 200, 0.05)
    use_jax_draws(monkeypatch, [key])
    tf = transac.ransac_plane(T(pts), T(mask), None, 200, 0.05)
    _assert_plane_fit_equal(jf, tf)


def test_fit_plane_robust_with_jax_draws(monkeypatch):
    pts, mask = _plane_cloud(np.random.default_rng(12))
    key = jax.random.PRNGKey(7)
    jf = jransac.fit_plane_robust(J(pts), J(mask), key, 300, 0.1)
    use_jax_draws(monkeypatch, [key])
    tf = transac.fit_plane_robust(T(pts), T(mask), None, 300, 0.1)
    _assert_plane_fit_equal(jf, tf)


def test_ransac_circle_with_jax_draws(monkeypatch):
    rng = np.random.default_rng(13)
    ang = rng.uniform(0, 2 * np.pi, 150)
    circ = np.column_stack([1.5 + 0.2 * np.cos(ang), -0.7 + 0.2 * np.sin(ang)])
    circ += rng.normal(scale=0.003, size=circ.shape)
    xy = np.concatenate([circ, rng.uniform(-2, 2, (100, 2))]).astype(np.float32)
    mask = rng.random(len(xy)) > 0.05
    key = jax.random.PRNGKey(3)
    jf = jransac.ransac_circle(J(xy), J(mask), key)
    use_jax_draws(monkeypatch, [key])
    tf = transac.ransac_circle(T(xy), T(mask))
    assert int(tf.inlier_count) == int(jf.inlier_count)
    assert bool(tf.ok) == bool(jf.ok)
    for a, b in ((tf.center, jf.center), (tf.radius, jf.radius),
                 (tf.mean_error, jf.mean_error)):
        np.testing.assert_allclose(N(a), N(b), atol=F32_ATOL)


def test_fit_circle_algebraic():
    rng = np.random.default_rng(14)
    ang = rng.uniform(0, 2 * np.pi, 200)
    xy = np.column_stack([40.0 + 0.3 * np.cos(ang), -25.0 + 0.3 * np.sin(ang)])
    xy = (xy + rng.normal(scale=0.002, size=xy.shape)).astype(np.float32)
    mask = rng.random(200) > 0.2
    jf = jransac.fit_circle_algebraic(J(xy), J(mask))
    tf = transac.fit_circle_algebraic(T(xy), T(mask))
    assert int(tf.inlier_count) == int(jf.inlier_count)
    # 1e-5 m: a 3x3 solve of another LAPACK path on centred points
    np.testing.assert_allclose(N(tf.center), N(jf.center), atol=1e-5)
    np.testing.assert_allclose(float(tf.radius), float(jf.radius), atol=1e-5)
    np.testing.assert_allclose(float(tf.mean_error), float(jf.mean_error),
                               atol=1e-5)


def test_statistical_outlier_mask():
    rng = np.random.default_rng(15)
    pts = np.concatenate([rng.normal(scale=0.5, size=(1500, 3)),
                          rng.uniform(-6, 6, (60, 3))]).astype(np.float32)
    mask = rng.random(len(pts)) > 0.05
    jk = jransac.statistical_outlier_mask(J(pts), J(mask), k=10)
    tk = transac.statistical_outlier_mask(T(pts), T(mask), k=10)
    np.testing.assert_array_equal(N(tk), N(jk))
    assert 0 < int(tk.sum()) < int(mask.sum())


# ---------------------------------------------------------------------------
# GICP, NDT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """A source and a target view of the structured scene, 5 degrees and
    0.3 m apart, padded to 8192 points."""
    rng = np.random.default_rng(20)
    world = structured_scene(rng)
    tgt = view_from(world, [0, 0, 0], [0, 0, 1.5])
    src = view_from(world, [0.01, -0.02, 0.09], [0.3, -0.2, 1.45])
    cap = 8192

    def pad(a):
        out = np.zeros((cap, 3), np.float32)
        out[:len(a)] = a
        return out, np.arange(cap) < len(a)

    return pad(src), pad(tgt)


def _well_posed_rows(xyz, mask, grid, k):
    """Rows whose k-NN scatter (float64, from msst_tpu's neighbours) has a
    smallest eigenvalue set apart from the middle one by at least 5 % of
    the largest: there the smallest eigenvector is defined.  In a line-like
    neighbourhood (a pillar's edge) it turns freely in a plane, and float32
    rounding picks it."""
    res = jknn.query(grid, J(xyz), J(mask), k=k, candidates_per_cell=24)
    nbrs = xyz[N(res.idx)].astype(np.float64)
    w = N(res.valid)[..., None].astype(np.float64)
    mu = (nbrs * w).sum(1) / np.maximum(w.sum(1), 1.0)
    dev = (nbrs - mu[:, None]) * w
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", dev, dev))
    return mask & (ev[:, 1] - ev[:, 0] > 0.05 * ev[:, 2])


def test_point_covariances(pair):
    (_, _), (tx, tm) = pair
    jg = jknn.build(J(tx), J(tm), 1.0, 8192)
    tg = tknn.build(T(tx), T(tm), 1.0, 8192)
    for k in (10, 16):
        jc = N(jreg.point_covariances(J(tx), J(tm), jg, k=k))
        tc = N(treg.point_covariances(T(tx), T(tm), tg, k=k))
        rows = _well_posed_rows(tx, tm, jg, k)
        assert rows.sum() > 0.8 * tm.sum()
        # 1e-4: unit-scale (eps, 1, 1) eigenframes of a 3x3 scatter whose
        # sums run in another order
        np.testing.assert_allclose(tc[rows], jc[rows], atol=1e-4)


def _iters_of_jax(run, n):
    """Whether msst_tpu's loop ran exactly n iterations: it stops short of a
    cap of n + 1 and does not stop short of a cap of n."""
    return bool(run(n + 1).converged) and not bool(run(n).converged)


def test_gicp_pose_and_iterations(pair):
    (sx, sm), (tx, tm) = pair
    jg = jknn.build(J(tx), J(tm), 1.0, 8192)
    jsg = jknn.build(J(sx), J(sm), 1.0, 8192)
    js_cov = jreg.point_covariances(J(sx), J(sm), jsg, k=10)
    jt_cov = jreg.point_covariances(J(tx), J(tm), jg, k=10)
    init = jse3.Pose.identity()

    def run_jax(max_iters):
        return jreg.gicp(J(sx), J(sm), js_cov, jg, J(tx), jt_cov, init,
                         max_iters=max_iters)

    want = run_jax(50)
    # the port from msst_tpu's covariances, so that only GICP is compared
    tg = convert.from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    got = treg.gicp(T(sx), T(sm), T(js_cov), tg, T(tx), T(jt_cov),
                    tse3.Pose.identity(), max_iters=50)
    assert_pose_close(want.pose, got.pose)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               atol=F32_ATOL)
    assert float(got.matched_frac) == float(want.matched_frac)
    assert bool(got.converged) == bool(want.converged)
    n = int(got.iters)
    assert 1 < n < 50 and _iters_of_jax(run_jax, n), n


def _row_rel_err(a, b):
    """Largest |a - b| of each 3x3 row over the largest |b| of the row."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)


def test_build_ndt_map(pair):
    """Masks, grid and means as msst_tpu's; the inverse covariances to 1e-3
    relative, except where msst_tpu's own float32 prefix-sum moments lie
    1e-3 or more from the same map built in float64 (by the port): there
    the port must stay within NDT_INV_RTOL x 10 = 1e-3 of float64 itself."""
    (_, _), (tx, tm) = pair
    jm = jreg.build_ndt_map(J(tx), J(tm), 1.0, 4096)
    tmap = treg.build_ndt_map(T(tx), T(tm), 1.0, 4096)
    ref = treg.build_ndt_map(T(tx).double(), T(tm), 1.0, 4096)
    ok = N(jm.mask)
    np.testing.assert_array_equal(N(tmap.mask), ok)
    assert 100 < ok.sum() < 4096
    np.testing.assert_allclose(N(tmap.means)[ok], N(jm.means)[ok],
                               atol=NDT_MEAN_ATOL)
    np.testing.assert_array_equal(N(tmap.grid.orig_idx), N(jm.grid.orig_idx))
    ji, ti, fi = (N(m.inv_cov)[ok] for m in (jm, tmap, ref))
    jax_off = _row_rel_err(ji, fi) >= 10 * NDT_INV_RTOL
    assert jax_off.sum() <= 0.01 * ok.sum()
    assert (_row_rel_err(ti, ji)[~jax_off] < 10 * NDT_INV_RTOL).all()
    # the port's float32 map against float64: 1e-2 (a voxel whose clamped
    # eigenvalues nearly tie rounds its eigenframe)
    assert (_row_rel_err(ti, fi) < 1e-2).all()


def test_ndt_pose_and_iterations(pair):
    (sx, sm), (tx, tm) = pair
    jm = jreg.build_ndt_map(J(tx), J(tm), 1.0, 4096)
    init = jse3.Pose.identity()

    def run_jax(max_iters):
        return jreg.ndt(J(sx), J(sm), jm, init, max_iters=max_iters)

    want = run_jax(35)
    tmap = convert.from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    got = treg.ndt(T(sx), T(sm), tmap, tse3.Pose.identity(), max_iters=35)
    assert_pose_close(want.pose, got.pose)
    np.testing.assert_allclose(float(got.score), float(want.score),
                               atol=F32_ATOL)
    assert bool(got.converged) == bool(want.converged)
    n = int(got.iters)
    assert 1 < n < 35 and _iters_of_jax(run_jax, n), n


# ---------------------------------------------------------------------------
# Allan variance
# ---------------------------------------------------------------------------


def _imu_log(n, seed, offset):
    """White noise (0.01) plus a random-walk bias, around `offset`."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(scale=2e-5, size=n))
    return (offset + 0.01 * rng.normal(size=n) + walk).astype(np.float32)


def test_log_spaced_clusters():
    for n in (1000, 200_000, 1_440_000):
        np.testing.assert_array_equal(N(timu.log_spaced_clusters(n)),
                                      N(jimu.log_spaced_clusters(n)))


@pytest.mark.parametrize("offset", [0.0, 0.3])
def test_allan_variance_and_fit_200k(offset):
    """A 200,000-sample log (1000 s at 200 Hz).  Around 0 the two float32
    estimates agree to ALLAN_RTOL (1e-4).  Around 0.3 the cumulative sum
    reaches 300 and its float32 rounding is as large as the second
    differences at small clusters: both packages then sit up to ~5 % from
    the float64 estimate and ~0.3 % from each other, so they are held to
    1e-2 of each other and the port to no farther from float64 than
    msst_tpu + 1e-2."""
    dt = 0.005
    sig = _imu_log(200_000, 30, offset)
    ms = N(jimu.log_spaced_clusters(len(sig)))
    jav = N(jimu.allan_variance(J(sig), dt, J(ms)))
    tav = N(timu.allan_variance(T(sig), dt, ms.tolist()))
    if offset == 0.0:
        np.testing.assert_allclose(tav, jav, rtol=ALLAN_RTOL)
    else:
        fav = N(timu.allan_variance(T(sig).double(), dt, ms.tolist()))
        np.testing.assert_allclose(tav, jav, rtol=1e-2)
        assert (np.abs(tav / fav - 1) <= np.abs(jav / fav - 1) + 1e-2).all()
    taus = (ms.astype(np.float64) * dt).astype(np.float32)
    jfit = jimu.fit_allan(J(taus), J(jav))
    tfit = timu.fit_allan(T(taus), T(jav))
    for name in ("Q", "N", "B", "K", "R", "white_noise", "bias_instability"):
        # 1e-3 relative: an SVD least-squares solve of a badly scaled
        # 5-column system, the same method in both
        np.testing.assert_allclose(float(getattr(tfit, name)),
                                   float(getattr(jfit, name)), rtol=1e-3,
                                   atol=1e-9, err_msg=name)
