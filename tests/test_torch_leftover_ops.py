"""The ops the port's paths do not call, each against msst_tpu on the CPU:
``se3.pose_log``, ``graph.total_error``, ``knn.nearest_in_set`` (with
``_small_topk_min``'s and ``lax.top_k``'s tie orders), ``voxel.
voxel_downsample_first`` and ``voxel_downsample(return_stats=True)``, the
grid ``registration.icp_point2point`` (its correspondences from
``knn.query`` at k = 1, the k-NN kernel's twin here), ``voxelmap.
plane_residuals`` / ``line_residuals``, and the options of ``voxelmap.
build`` (the absolute grid, ``plane_spread_min_count`` with ``weights``),
``merge_moments`` (``method="rank"``, ``return_stats=False``, and
msst_tpu's positional call) and ``moments_centroids(return_counts=True)``;
``se3.Pose.from_matrix``, ``state.kf_pose`` and ``modbus.ImuModbusDriver``
(polled over loopback from the port's ``ModbusTcpServer``).

Tolerances: discrete results (indices, masks, keys, counts, iteration
counts) equal; float32 results computed in the same order to 1e-6, and
where the two packages sum in another order (matmul distances, prefix
against direct segment sums, the Kabsch SVD) as stated at each test.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.ops import graph as tgraph
from msst_torch.ops import knn as tknn
from msst_torch.ops import registration as treg
from msst_torch.ops import se3 as tse3
from msst_torch.ops import voxel as tvox
from msst_torch.ops import voxelmap as tvm
from msst_torch.ops.pointcloud import Cloud as TCloud
from msst_tpu.ops import graph as jgraph
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import registration as jreg
from msst_tpu.ops import se3 as jse3
from msst_tpu.ops import voxel as jvox
from msst_tpu.ops import voxelmap as jvm
from msst_tpu.ops.pointcloud import Cloud as JCloud
from tests.test_torch_base import _graph_np
from tests.test_torch_voxelmap import _scene_194

RNG = np.random.default_rng(23)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_pose_log_matches():
    """Rotations to 2e-5 (arctan2 of the two packages), translations
    equal; the small-angle branch included."""
    rpy = RNG.uniform(-3.0, 3.0, (64, 3)).astype(np.float32)
    rpy[:4] = [[0, 0, 0], [1e-8, 0, 0], [0, 1e-6, 0], [0, 0, np.pi - 1e-3]]
    xyz = RNG.normal(size=(64, 3)).astype(np.float32) * 10
    v6 = np.concatenate([rpy, xyz], axis=1)
    want = np.asarray(jse3.pose_log(jse3.Pose.from_vec6(jnp.asarray(v6))))
    got = tse3.pose_log(tse3.Pose.from_vec6(_t(v6))).numpy()
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-5)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])


def test_total_error_matches():
    """tests/test_torch_base.py's graph (prior, chain, loop, GPS) off its
    optimum: the sum of squared whitened residuals to 1e-4 relative."""
    gnp = _graph_np()
    want = float(jgraph.total_error(jax.tree.map(jnp.asarray, gnp)))
    got = float(tgraph.total_error(convert.from_numpy(gnp, "cpu")))
    assert want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _set_case():
    """1024 set points with 64 exact duplicates (tied distances) and 10 %
    masked; 200 queries with 10 % masked, some on set points."""
    xyz = RNG.uniform(-20, 20, (1024, 3)).astype(np.float32)
    xyz[960:] = xyz[:64]
    mask = RNG.random(1024) > 0.1
    mask[:64] = mask[960:] = True
    q = RNG.uniform(-20, 20, (200, 3)).astype(np.float32)
    q[:32] = xyz[:32] + 0.01
    q_mask = RNG.random(200) > 0.1
    return xyz, mask, q, q_mask


@pytest.mark.parametrize("k", [1, 5, 24])
def test_nearest_in_set_matches(k):
    """Indices equal, the ties at duplicates to the lower index (k = 24 runs
    msst_tpu's ``lax.top_k``, the lower index first among the masked
    queries' inf too); distances to 1e-4 (|q|^2 - 2 q.x + |x|^2 in the two
    packages' matmul order)."""
    xyz, mask, q, q_mask = _set_case()
    want = _np(jknn.nearest_in_set(jnp.asarray(xyz), jnp.asarray(mask),
                                   jnp.asarray(q), jnp.asarray(q_mask), k=k))
    got = convert.to_numpy(tknn.nearest_in_set(_t(xyz), _t(mask), _t(q),
                                               _t(q_mask), k=k))
    assert got.idx.dtype == np.int32
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.sqdist[want.valid], want.sqdist[want.valid],
                               atol=1e-4)
    # the duplicates' tie went to the lower index
    assert np.all(want.idx[:32, 0] < 64)


def _cloud_case(n=4000):
    xyz = RNG.uniform(-10, 10, (n, 3)).astype(np.float32)
    attrs = RNG.normal(size=(n, 2)).astype(np.float32)
    mask = RNG.random(n) > 0.2
    return xyz, mask, attrs


@pytest.mark.parametrize("capacity", [None, 500])
def test_voxel_downsample_first_matches(capacity):
    """The first point of each voxel, in input order, bit for bit (with a
    capacity short of the occupied voxels, the first in input order
    survive)."""
    xyz, mask, attrs = _cloud_case()
    want = _np(jvox.voxel_downsample_first(
        JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(attrs)), 1.5,
        capacity=capacity))
    got = convert.to_numpy(tvox.voxel_downsample_first(
        TCloud(_t(xyz), _t(mask), _t(attrs)), 1.5, capacity=capacity))
    for f in ("xyz", "mask", "attrs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert 0 < want.mask.sum() <= (capacity or len(xyz))


def test_voxel_downsample_return_stats_matches():
    """The overflow count equal; the cloud as the option-less call's (its
    own test holds those to msst_tpu)."""
    xyz, mask, attrs = _cloud_case()
    want, wd = jvox.voxel_downsample(
        JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(attrs)), 0.5,
        capacity=1000, return_stats=True)
    cloud = TCloud(_t(xyz), _t(mask), _t(attrs))
    got, gd = tvox.voxel_downsample(cloud, 0.5, capacity=1000,
                                    return_stats=True)
    assert int(wd) > 0
    assert gd.dtype == torch.int32 and int(gd) == int(wd)
    plain = tvox.voxel_downsample(cloud, 0.5, capacity=1000)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def _room(n=6000):
    """Floor and three walls of a room, 2 cm noise."""
    u = RNG.uniform(-6, 6, (n, 2)).astype(np.float32)
    which = RNG.integers(0, 4, n)
    pts = np.zeros((n, 3), np.float32)
    pts[which == 0] = np.c_[u[which == 0], np.zeros((which == 0).sum())]
    pts[which == 1] = np.c_[np.full((which == 1).sum(), 6.0), u[which == 1]]
    pts[which == 2] = np.c_[u[which == 2, 0], np.full((which == 2).sum(), 6.0),
                            u[which == 2, 1]]
    pts[which == 3] = np.c_[np.full((which == 3).sum(), -6.0), u[which == 3]]
    return pts + RNG.normal(scale=0.02, size=pts.shape).astype(np.float32)


def test_icp_point2point_grid_matches():
    """A room cloud against itself moved by (2 deg, 0.15 m): the same
    iteration count and a pose within 1e-4 (the Kabsch SVDs), fitness to
    1e-6, both recovering the offset; on msst_tpu's grid and on the
    port's own build of it."""
    tgt = _room()
    src = tgt[::3].copy()
    off = np.array([0.0, 0.0, np.deg2rad(2.0), 0.15, -0.1, 0.05], np.float32)
    jp = jse3.Pose.from_vec6(jnp.asarray(off))
    src = np.asarray(jp.inverse().apply(jnp.asarray(src)))
    tmask, smask = np.ones(len(tgt), bool), np.ones(len(src), bool)
    jgrid = jknn.build(jnp.asarray(tgt), jnp.asarray(tmask), 1.0, 8192)
    want = _np(jreg.icp_point2point(
        jnp.asarray(src), jnp.asarray(smask), jgrid, jnp.asarray(tgt),
        jse3.Pose.identity(), max_iters=30, max_corr_dist=1.0))
    grids = (convert.from_numpy(_np(jgrid), "cpu"),
             tknn.build(_t(tgt), _t(tmask), 1.0, 8192))
    for grid in grids:
        got = convert.to_numpy(treg.icp_point2point(
            _t(src), _t(smask), grid, _t(tgt), tse3.Pose.identity(),
            max_iters=30, max_corr_dist=1.0))
        assert int(got.iters) == int(want.iters) < 30
        np.testing.assert_allclose(got.pose.t, want.pose.t, atol=1e-4)
        np.testing.assert_allclose(np.abs(np.sum(got.pose.q * want.pose.q)),
                                   1.0, atol=1e-6)
        np.testing.assert_allclose(got.fitness, want.fitness, atol=1e-6)
        np.testing.assert_allclose(got.matched_frac, want.matched_frac)
        assert bool(got.converged) and bool(want.converged)
        np.testing.assert_allclose(
            np.asarray(jse3.Pose(jnp.asarray(got.pose.q),
                                 jnp.asarray(got.pose.t)).to_vec6()), off,
            atol=5e-3)


def test_plane_and_line_residuals_match():
    """On msst_tpu's lookup of its own maps (the twin equals it, as
    test_torch_voxelmap.py holds): residuals and gradients to 1e-6."""
    pa, pb, qa, qb, ma, mb = _scene_194()
    va = jvm.build(jnp.asarray(pa), jnp.ones(4096, bool), 0.5, 1024, "plane",
                   table_size=2048, origin=jnp.asarray([0.2, -0.1, 0.0]))
    vb = jvm.build(jnp.asarray(pb), jnp.ones(2048, bool), 1.0, 512, "line",
                   table_size=1024, origin=jnp.zeros(3))
    for vmap, q, m, fn in ((va, qa, ma, "plane_residuals"),
                           (vb, qb, mb, "line_residuals")):
        hit = jvm.lookup(vmap, jnp.asarray(q), jnp.asarray(m))
        want = _np(getattr(jvm, fn)(vmap, jnp.asarray(q), hit))
        thit = tvm.VoxelLookup(*(_t(np.asarray(x)) for x in hit))
        got = getattr(tvm, fn)(convert.from_numpy(_np(vmap), "cpu"), _t(q),
                               thit)
        assert want[2].sum() > 10
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6)


def _assert_builds_match(tm, jm, min_count):
    """test_torch_voxelmap.py's table checks: keys, buckets and masks equal,
    means to 1e-4 (prefix against direct segment sums), directions up to
    sign to 2e-3 on cells of `min_count`+ points.  A cell of a few points
    can be near degenerate, where rounding sets the eigenvector: on every
    usable cell of 4+ points |cos| >= 0.99 between the two.  A 3-point
    plane through nearly collinear points has no defined normal (the thin
    cells ``plane_spread_min_count`` keeps as planes are such cells), so
    3-point cells are held by their keys and means alone."""
    for f in ("coords", "count", "valid", "mask", "bucket_start",
              "bucket_count", "leaf", "origin"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    np.testing.assert_array_equal(tm.probe[:, 0::8].view(np.int32),
                                  jm.probe[:, 0::8].view(np.int32))
    m = jm.mask
    np.testing.assert_allclose(tm.mean[m], jm.mean[m], atol=1e-4)
    sign = np.sign(np.sum(tm.direction * jm.direction, axis=1))
    sign[sign == 0] = 1.0
    ok = m & jm.valid & (jm.count >= min_count)
    np.testing.assert_allclose((tm.direction * sign[:, None])[ok],
                               jm.direction[ok], atol=2e-3)
    usable = m & jm.valid & (jm.count >= 4)
    cos = (np.abs(np.sum(tm.direction * jm.direction, axis=1))
           / np.maximum(np.sum(jm.direction ** 2, axis=1), 1e-12))
    assert np.all(cos[usable] >= 0.99), (cos[usable].min(),
                                         jm.count[usable][cos[usable].argmin()])
    assert ok.sum() > 10


def _spread_case(rng):
    """Thin floor arcs (1-D support) and full patches, each row a fine-cell
    centroid with a true point count of 1-12."""
    pa = _scene_194()[0]
    arcs = rng.uniform(-8, 8, (1024, 3)).astype(np.float32)
    arcs[:, 1] = np.round(arcs[:, 1]) + 0.25
    arcs[:, 2] = 0.01 * rng.standard_normal(1024)
    pts = np.concatenate([pa, arcs])
    w = rng.integers(1, 13, len(pts)).astype(np.float32)
    return pts, w


@pytest.mark.parametrize("case", ["absolute_plane", "absolute_line",
                                  "spread_min_count", "spread_min_count_abs"])
def test_build_options_match(case):
    """The absolute grid (``origin=None``) and ``plane_spread_min_count``
    with per-row ``weights``: the tables as test_torch_voxelmap.py holds
    the origin grid's; with a min count, some thin cells stay planes."""
    pa, pb, *_ = _scene_194()
    rng = np.random.default_rng(31)
    kw, min_count = {}, 8
    if case == "absolute_plane":
        pts, leaf, cap, kind, origin = pa - [40.0, 0, 0], 1.0, 512, "plane", None
    elif case == "absolute_line":
        pts, leaf, cap, kind, origin = pb, 1.0, 512, "line", None
        min_count = 4
    else:
        pts, w = _spread_case(rng)
        leaf, cap, kind = 1.0, 2048, "plane"
        origin = None if case.endswith("abs") else np.float32([0.1, 0.2, 0])
        kw = dict(plane_min_spread=0.2, plane_spread_min_count=30.0,
                  weights=w)
    pts = np.asarray(pts, np.float32)
    mask = rng.random(len(pts)) > 0.05
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jo = None if origin is None else jnp.asarray(origin)
    to = None if origin is None else _t(origin)
    jm = _np(jvm.build(jnp.asarray(pts), jnp.asarray(mask), leaf, cap, kind,
                       table_size=2 * cap, origin=jo, **jkw))
    tm = convert.to_numpy(tvm.build(_t(pts), _t(mask), leaf, cap, kind,
                                    table_size=2 * cap, origin=to, **tkw))
    _assert_builds_match(tm, jm, min_count)
    if kw:
        # lines (|dir| = LINE_DIR_SCALE) and planes both present; without
        # the count every thin cell would be a line
        norms = np.linalg.norm(jm.direction[jm.valid], axis=1)
        thin = np.abs(norms - tvm.LINE_DIR_SCALE) < 1e-3
        assert 0 < thin.sum() < len(norms)
        np.testing.assert_array_equal(
            np.abs(np.linalg.norm(tm.direction[jm.valid], axis=1)
                   - tvm.LINE_DIR_SCALE) < 1e-3, thin)
        base = convert.to_numpy(tvm.build(
            _t(pts), _t(mask), leaf, cap, kind, table_size=2 * cap,
            origin=to, plane_min_spread=0.2))
        assert (np.abs(np.linalg.norm(base.direction[base.valid], axis=1)
                       - tvm.LINE_DIR_SCALE) < 1e-3).sum() > thin.sum()


def test_merge_moments_options_match():
    """``method="rank"`` gives the table ``"sort"`` gives, and msst_tpu's
    rank merge's, keys and counts equal, sums to 1e-4; ``return_stats=
    False`` returns the table alone; ``moments_centroids(return_counts=
    True)`` counts equal."""
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    a = RNG.uniform(-20, 20, (3000, 3)).astype(np.float32)
    b = RNG.uniform(-25, 25, (2000, 3)).astype(np.float32)
    b[:500] = a[:500]          # shared cells: the merge sums them
    out = {}
    for name, mod, T in (("jax", jvm, jnp.asarray), ("torch", tvm, _t)):
        o = T(origin)
        A = mod.points_to_moments(T(a), T(np.ones(3000, bool)), 0.4, o, 2048,
                                  group_bits=1)
        B = mod.points_to_moments(T(b), T(np.ones(2000, bool)), 0.4, o, 2048,
                                  group_bits=1)
        for method in ("sort", "rank"):
            M = mod.merge_moments(A, B, 3000, method=method,
                                  return_stats=False)
            cx, cm, cc = mod.moments_centroids(M, 0.4, o, group_bits=1,
                                               return_counts=True)
            out[name, method] = [np.asarray(x) if name == "jax" else
                                 x.numpy() for x in (M.key, M.cnt, M.rsum,
                                                     cx, cm, cc)]
    want = out["jax", "rank"]
    for got in (out["torch", "rank"], out["torch", "sort"], out["jax", "sort"]):
        for i, (g, w) in enumerate(zip(got, want)):
            if i in (2, 3):
                np.testing.assert_allclose(g, w, atol=1e-4)
            else:
                np.testing.assert_array_equal(g, w)
    assert (want[1] > 1.5).sum() > 100   # cells shared by both tables
    M, dropped = tvm.merge_moments(*(tvm.points_to_moments(
        _t(x), _t(np.ones(len(x), bool)), 0.4, _t(origin), 2048,
        group_bits=1) for x in (a, b)), 1000, method="rank",
        return_stats=True)
    assert int(dropped) > 0 and M.key.shape == (1000,)


@pytest.mark.parametrize("method", ["sort", "rank"])
def test_merge_moments_positional_call_matches(method):
    """msst_tpu's positional form, ``merge_moments(a, b, cap)`` and
    ``merge_moments(a, b, cap, min_cnt)``, gives the same type in both
    packages (the table alone, by default) and the same table: keys and
    counts equal, sums to 1e-4."""
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    a = RNG.uniform(-20, 20, (3000, 3)).astype(np.float32)
    b = RNG.uniform(-25, 25, (2000, 3)).astype(np.float32)
    b[:500] = a[:500]
    out = {}
    for name, mod, T in (("jax", jvm, jnp.asarray), ("torch", tvm, _t)):
        o = T(origin)
        A, B = (mod.points_to_moments(T(x), T(np.ones(len(x), bool)), 0.4, o,
                                      2048, group_bits=1) for x in (a, b))
        if method == "sort":
            got = (mod.merge_moments(A, B, 2500),
                   mod.merge_moments(A, B, 2500, 0.5))
        else:
            got = (mod.merge_moments(A, B, 2500, method=method),
                   mod.merge_moments(A, B, 2500, 0.5, method=method))
        for M in got:
            assert type(M).__name__ == "VoxelMoments"
        out[name] = [[np.asarray(x) if name == "jax" else x.numpy()
                      for x in (M.key, M.cnt, M.rsum)] for M in got]
    for want, got in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=1e-4)


def test_pose_from_matrix_and_kf_pose_match():
    """``se3.Pose.from_matrix`` (batched and single) and ``state.kf_pose``
    against msst_tpu's: quaternions and translations to 1e-6."""
    from msst_torch.models.liosam import state as tstate
    from msst_tpu.models.liosam import state as jstate

    v6 = np.concatenate([RNG.uniform(-3, 3, (16, 3)),
                         RNG.uniform(-50, 50, (16, 3))], 1).astype(np.float32)
    v6[0, :3] = [np.pi, 0.0, 0.0]     # a half turn: the w ~ 0 branch
    mats = np.asarray(jse3.Pose.from_vec6(jnp.asarray(v6)).to_matrix())
    for m in (mats, mats[3]):
        want = jse3.Pose.from_matrix(jnp.asarray(m))
        got = tse3.Pose.from_matrix(_t(m))
        np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q),
                                   atol=1e-6)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   atol=1e-6)
    # kf_pose reads the store's pose6 alone
    jkf = SimpleNamespace(pose6=jnp.asarray(v6))
    tkf = SimpleNamespace(pose6=_t(v6))
    for i in (0, 5, 15):
        want = jstate.kf_pose(jkf, jnp.asarray(i))
        got = tstate.kf_pose(tkf, torch.tensor(i))
        np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q),
                                   atol=1e-6)
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


def test_imu_modbus_driver_polls_like_reference():
    """``ImuModbusDriver.poll`` over loopback against the port's
    ``ModbusTcpServer``: the same dict as msst_tpu's driver polling the same
    bank, without and with mounting extrinsics; a non-finite register pair
    gives None in both."""
    from msst_torch.utils import imu_adapter as tadapt
    from msst_torch.utils import modbus as tmod
    from msst_tpu.utils import imu_adapter as jadapt
    from msst_tpu.utils import modbus as jmod

    server = tmod.ModbusTcpServer("127.0.0.1", 0)
    server.start()
    try:
        vals = [0.1, -0.2, 1.5, 0.01, -0.02, 0.03, 0.2, -0.1, 9.8]
        for i, v in enumerate(vals):
            server.set_float(tmod.ImuModbusDriver.REG_START + 2 * i, v)
        rot = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
        for ext in (None, "rot"):
            tx = None if ext is None else tadapt.ImuExtrinsics.create(rot)
            jx = None if ext is None else jadapt.ImuExtrinsics.create(rot)
            got = tmod.ImuModbusDriver("127.0.0.1", server.port, tx).poll()
            want = jmod.ImuModbusDriver("127.0.0.1", server.port, jx).poll()
            assert got is not None and set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]))
        np.testing.assert_allclose(got["acc"], [0.1, 0.2, 9.8], atol=1e-6)
        server.set_float(tmod.ImuModbusDriver.REG_START + 2, float("nan"))
        assert tmod.ImuModbusDriver("127.0.0.1", server.port).poll() is None
        assert jmod.ImuModbusDriver("127.0.0.1", server.port).poll() is None
    finally:
        server.stop()
