"""The calibration features in the port against msst_tpu, on the CPU: kernel
B2's twin at the FPFH shape (k = 48, C = 64, radius-capped) and on a
lattice whose candidates tie at the 48th slot, the normals, SPFH and FPFH
(``models/calibration/features.py``), the mutual feature matches with
``lax.top_k``'s order on ties, and GNC-TLS (``coarse.py``).

Tolerances: neighbour indices, valid flags and match indices are exact;
squared distances agree to 1e-5 (tests/test_torch_knn.py's bound);
normals to 1e-4 on rows whose neighbourhood scatter has a defined smallest
eigenvector (a line-like neighbourhood leaves it free in a plane, where
float32 rounding picks it); SPFH exactly (whole-neighbour bin counts);
FPFH to 1e-3 of its 0-200 scale given the same normals; GNC-TLS poses to
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rs

from msst_torch import convert
from msst_torch.models.calibration import coarse as tcoarse
from msst_torch.models.calibration import features as tfeat
from msst_torch.ops import knn as tknn
from msst_torch.ops import pointcloud as tpc
from msst_torch.ops import voxel as tvoxel
from msst_tpu.models.calibration import coarse as jcoarse
from msst_tpu.models.calibration import features as jfeat
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import pointcloud as jpc
from msst_tpu.ops import voxel as jvoxel
from msst_tpu.ops.knn_pallas import query_pallas
from tests.test_torch_calib_ops import (J, N, T, _one_torch_thread,  # noqa: F401
                                        structured_scene, view_from)

SQDIST_ATOL = 1e-5
NORMAL_ATOL = 1e-4
FPFH_ATOL = 1e-3
VOXEL, RADIUS, K, C = 0.35, 1.4, 48, 64     # MultiLicaConfig's FPFH shape


@pytest.fixture(scope="module")
def cloud():
    """The structured scene as Multi_LiCa's prep stage sees it: cropped to
    the 20 m cube and voxel downsampled at 0.35 m into 8192 slots
    (msst_tpu's crop and downsample, so that both packages start from the
    same points), a 1.4 m grid of 8192 buckets."""
    world = structured_scene(np.random.default_rng(40))
    pts = view_from(world, [0.02, -0.03, 0.5], [2.0, 1.0, 1.4])
    cl = jpc.crop_box(jpc.Cloud.create(J(pts)), J([-20.0] * 3),
                      J([20.0] * 3))
    cl = jvoxel.voxel_downsample(cl, VOXEL, capacity=8192)
    xyz, mask = N(cl.xyz), N(cl.mask)
    jg = jknn.build(J(xyz), J(mask), RADIUS, 8192)
    tg = convert.from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    return xyz, mask, jg, tg


def _assert_knn_equal(want, got, check_invalid_idx=False):
    v = N(want.valid)
    np.testing.assert_array_equal(N(got.valid), v)
    gi, wi = N(got.idx), N(want.idx)
    if check_invalid_idx:
        np.testing.assert_array_equal(gi, wi)
    else:
        np.testing.assert_array_equal(np.where(v, gi, -1), np.where(v, wi, -1))
    fin = np.isfinite(N(want.sqdist))
    np.testing.assert_array_equal(np.isfinite(N(got.sqdist)), fin)
    np.testing.assert_allclose(N(got.sqdist)[fin], N(want.sqdist)[fin],
                               atol=SQDIST_ATOL)


def test_knn_at_the_fpfh_shape(cloud):
    """k = 48 of up to 27 x 64 candidates within 1.4 m.  msst_tpu's XLA form
    takes lax.top_k above k = 16, whose short rows' index slots differ from
    the twin's (lane 0): those slots are invalid, and compared only against
    the Pallas kernel, which takes k argmins as the twin does."""
    xyz, mask, jg, tg = cloud
    got = tknn.query(tg, T(xyz), T(mask), k=K, candidates_per_cell=C,
                     max_sqdist=RADIUS ** 2)
    want = jknn.query(jg, J(xyz), J(mask), k=K, candidates_per_cell=C,
                      max_sqdist=RADIUS ** 2)
    _assert_knn_equal(want, got)
    assert (N(got.valid).sum(1) == K).any() and (~N(got.valid)).any()
    q = slice(0, 512)
    pal = query_pallas(jg, J(xyz[q]), J(mask[q]), k=K, candidates_per_cell=C,
                       max_sqdist=RADIUS ** 2, interpret=True)
    sub = tknn.KnnResult(*(x[q] for x in got))
    _assert_knn_equal(pal, sub, check_invalid_idx=True)


def test_knn_k48_lattice_ties():
    """Points on a 0.5 m lattice in a 1 m grid (8 a cell, so C = 64 never
    overflows), queries at lattice-symmetric positions: many candidates tie
    at the 48th slot, and which of them are kept decides FPFH's neighbour
    set.  Equal distances come out in ascending (probe, lane) order in both
    packages."""
    gen = np.random.default_rng(6)
    ax = np.arange(-8, 8) * 0.5
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[gen.permutation(len(pts))].astype(np.float32)
    mask = gen.random(len(pts)) > 0.05
    base = gen.integers(-3, 3, (600, 3)).astype(np.float32)
    q = np.concatenate([base[:300] + 0.75, base[300:] * 0.5]).astype(np.float32)
    qm = gen.random(len(q)) > 0.1
    jg = jknn.build(J(pts), J(mask), 1.0, 1024)
    tg = tknn.build(T(pts), T(mask), 1.0, 1024)
    for max_sq in (np.inf, 0.75 ** 2):
        want = jknn.query(jg, J(q), J(qm), k=K, candidates_per_cell=C,
                          max_sqdist=max_sq)
        got = tknn.query(tg, T(q), T(qm), k=K, candidates_per_cell=C,
                         max_sqdist=max_sq)
        _assert_knn_equal(want, got)
        d = N(got.sqdist)
        tie_at_k = np.isfinite(d[:, K - 1]) & (d[:, K - 1] == d[:, K - 2])
        assert tie_at_k.sum() > 100


def _well_posed(xyz, mask, res):
    nbrs = xyz[N(res.idx)].astype(np.float64)
    w = N(res.valid)[..., None].astype(np.float64)
    mu = (nbrs * w).sum(1) / np.maximum(w.sum(1), 1.0)
    dev = (nbrs - mu[:, None]) * w
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", dev, dev))
    return mask & (ev[:, 1] - ev[:, 0] > 0.05 * ev[:, 2])


def test_estimate_normals(cloud):
    xyz, mask, jg, tg = cloud
    jn = N(jfeat.estimate_normals(J(xyz), J(mask), jg, K, C, RADIUS))
    tn = N(tfeat.estimate_normals(T(xyz), T(mask), tg, K, C, RADIUS))
    res = jknn.query(jg, J(xyz), J(mask), k=K, candidates_per_cell=C,
                     max_sqdist=RADIUS ** 2)
    rows = _well_posed(xyz, mask, res)
    assert rows.sum() > 0.9 * mask.sum()
    np.testing.assert_allclose(tn[rows], jn[rows], atol=NORMAL_ATOL)


def test_spfh_and_fpfh_given_the_same_normals(cloud, monkeypatch):
    xyz, mask, jg, tg = cloud
    jn = jfeat.estimate_normals(J(xyz), J(mask), jg, K, C, RADIUS)
    res = jknn.query(jg, J(xyz), J(mask), k=K, candidates_per_cell=C,
                     max_sqdist=RADIUS ** 2)
    ok = N(res.valid) & (N(res.sqdist) > 1e-12)
    idx = np.where(ok, N(res.idx), 0)
    js = N(jfeat._spfh(J(xyz), jn, J(idx), J(ok)))
    ts = N(tfeat._spfh(T(xyz), T(jn), T(idx).long(), T(ok)))
    # exact but for the final normalisation's rounding (h / s * 100)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-5)
    monkeypatch.setattr(tfeat, "estimate_normals",
                        lambda *a, **k: T(jn))
    jf = N(jfeat.fpfh(J(xyz), J(mask), jg, K, C, RADIUS))
    tf = N(tfeat.fpfh(T(xyz), T(mask), tg, K, C, RADIUS))
    np.testing.assert_allclose(tf, jf, atol=FPFH_ATOL)
    assert np.abs(tf[~mask]).max() == 0.0


@pytest.mark.parametrize("max_pairs", [64, 600])
def test_mutual_correspondences_distinct(max_pairs):
    """Random features: the same mutual pairs.  The ranking of near-equal
    scores follows each package's float32 matmul rounding (|a|^2 - 2ab +
    |b|^2 of large features), so the pairs are compared as a set and the
    scores' order only through the tie test below."""
    rng = np.random.default_rng(41)
    fa = rng.uniform(0, 100, (700, 33)).astype(np.float32)
    perm = rng.permutation(700)[:500]
    fb = (fa[perm] + rng.normal(scale=0.5, size=(500, 33))).astype(np.float32)
    ma, mb = rng.random(700) > 0.1, rng.random(500) > 0.1
    want = jfeat.mutual_correspondences(J(fa), J(ma), J(fb), J(mb), 700)
    got = tfeat.mutual_correspondences(T(fa), T(ma), T(fb), T(mb), max_pairs)
    n_mutual = int(N(want[2]).sum())
    assert 0 < n_mutual < 700
    n = min(n_mutual, max_pairs)
    assert N(got[2]).sum() == n and not N(got[2])[n:].any()
    pairs = set(zip(N(want[0])[:n_mutual].tolist(),
                    N(want[1])[:n_mutual].tolist()))
    got_pairs = set(zip(N(got[0])[:n].tolist(), N(got[1])[:n].tolist()))
    assert got_pairs <= pairs and len(got_pairs) == n
    if n == n_mutual:
        assert got_pairs == pairs


def test_mutual_correspondences_ties():
    """Integer-valued features, so every squared distance is exact in both
    packages: repeated rows make argmin ties (the first index wins), equal
    mutual scores tie in the ranking and every invalid slot scores -1e18;
    lax.top_k ranks equal scores lower index first, the port's stable sort
    likewise."""
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, (40, 33)).astype(np.float32)
    fa = base[rng.integers(0, 40, 300)]
    fb = base[rng.integers(0, 40, 200)]
    ma, mb = rng.random(300) > 0.1, rng.random(200) > 0.1
    want = jfeat.mutual_correspondences(J(fa), J(ma), J(fb), J(mb), 128)
    got = tfeat.mutual_correspondences(T(fa), T(ma), T(fb), T(mb), 128)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(N(g), N(w))
    valid = N(got[2])
    assert 0 < valid.sum() < 128        # invalid slots tie at -1e18 too


def test_gnc_tls_registration():
    rng = np.random.default_rng(43)
    src = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
    R = Rs.from_euler("xyz", [0.05, -0.1, 0.4]).as_matrix().astype(np.float32)
    t = np.array([1.0, -0.5, 0.3], np.float32)
    dst = src @ R.T + t
    dst[:120] = rng.uniform(-5, 5, size=(120, 3))
    valid = rng.random(300) > 0.05
    want = jcoarse.gnc_tls_registration(J(src), J(dst), J(valid), 0.1)
    got = tcoarse.gnc_tls_registration(T(src), T(dst), T(valid), 0.1)
    np.testing.assert_allclose(N(got.pose.to_matrix()),
                               N(want.pose.to_matrix()), atol=1e-4)
    assert int(got.n_inliers) == int(want.n_inliers) >= 160
    assert bool(got.ok)
    np.testing.assert_allclose(N(got.inliers), N(want.inliers), atol=1e-4)


def test_prep_shapes_through_the_port(cloud):
    """The port's own downsample gives the clouds the features were held on
    (the crop and the voxel filter of Multi_LiCa's prep stage)."""
    world = structured_scene(np.random.default_rng(40))
    pts = view_from(world, [0.02, -0.03, 0.5], [2.0, 1.0, 1.4])
    cl = tpc.crop_box(tpc.Cloud.create(T(pts)), (-20.0,) * 3, (20.0,) * 3)
    cl = tvoxel.voxel_downsample(cl, VOXEL, capacity=8192)
    xyz, mask, _, _ = cloud
    np.testing.assert_array_equal(N(cl.mask), mask)
    np.testing.assert_allclose(N(cl.xyz)[mask], xyz[mask], atol=1e-5)
