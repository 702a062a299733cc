"""The port's voxel feature map and scan-to-map Gauss-Newton against
msst_tpu: hashes and keys bit for bit, the built tables, the moment tables,
the lookup (the CUDA kernel's plain twin) against both msst_tpu's XLA form
and its Pallas kernel, and the registration.

The kernel itself needs a card: chip_smoke.py holds it against this twin on
the GPU.  Here the wrapper takes the twin because the tensors are on the
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.ops import registration as treg
from msst_torch.ops import voxelmap as tvm
from msst_tpu.ops import registration as jreg
from msst_tpu.ops import se3 as jse3
from msst_tpu.ops import voxelmap as jvm
from msst_tpu.ops.voxelmap_pallas import lookup_pallas

RNG = np.random.default_rng(17)


def _np(x):
    return jax.tree.map(np.asarray, x)


# ---------------------------------------------------------------------------
# hashes and keys
# ---------------------------------------------------------------------------


def _cells():
    """1e5 random int32 cells incl. the extremes and sign boundaries."""
    c = RNG.integers(-2**31, 2**31, size=(100_000, 3), dtype=np.int64)
    c[:5000] = RNG.integers(-2000, 2000, size=(5000, 3))
    special = np.array([-2**31, 2**31 - 1, 0, -1, 1, -512, 511, 512, -513,
                        1023, 1024], np.int64)
    grid = np.stack(np.meshgrid(special, special, special), -1).reshape(-1, 3)
    return np.concatenate([c, grid]).astype(np.int32)


@pytest.mark.parametrize("table_size", [12289, 16384, 1])
def test_hash3_bit_exact(table_size):
    """Wrapping int32 multiplies, abs(INT32_MIN) and floor-mod, on a table
    size that is not a power of two too."""
    c = _cells()
    want = np.asarray(jvm._hash3(jnp.asarray(c), table_size))
    got = tvm._hash3(torch.from_numpy(c), table_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < table_size


def test_coord_key_bit_exact():
    c = _cells()
    np.testing.assert_array_equal(tvm._coord_key(torch.from_numpy(c)).numpy(),
                                  np.asarray(jvm._coord_key(jnp.asarray(c))))


@pytest.mark.parametrize("group_bits", [0, 1, 2])
def test_pack_rel_round_trip_matches_jax(group_bits):
    rel = RNG.integers(0, 1024, size=(5000, 3)).astype(np.int32)
    want = np.asarray(jvm._pack_rel(jnp.asarray(rel), group_bits))
    got = tvm._pack_rel(torch.from_numpy(rel), group_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvm._unpack_rel(got, group_bits).numpy(), rel)


# ---------------------------------------------------------------------------
# build + moment tables
# ---------------------------------------------------------------------------


def _scene_194():
    """The scene of tests/test_voxel.py::test_voxelmap_lookup_cat_matches_separate."""
    rng = np.random.default_rng(11)
    pa = rng.uniform(-8, 8, (4096, 3)).astype(np.float32)
    pa[:, 2] = 0.03 * rng.standard_normal(4096)
    pb = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    pb[:, :2] = np.round(pb[:, :2])
    qa = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    qb = rng.uniform(-6, 6, (768, 3)).astype(np.float32)
    ma = rng.random(512) > 0.1
    mb = rng.random(768) > 0.1
    return pa, pb, qa, qb, ma, mb


_BUILDS = {
    "plane_origin": lambda pa, pb: (pa, 0.5, 1024, "plane", 2048,
                                    np.array([0.2, -0.1, 0.0], np.float32)),
    "line_origin": lambda pa, pb: (pb, 1.0, 512, "line", 1024,
                                   np.array([0.5, -0.5, 0.25], np.float32)),
    "plane_spread": lambda pa, pb: (pa, 0.8, 1024, "plane", 2050,
                                    np.zeros(3, np.float32)),
}


@pytest.mark.parametrize("case", sorted(_BUILDS))
def test_build_tables_match_jax(case):
    """Probe-table key column equal as int32 bits, bucket tables and masks
    equal, means to 1e-4 (prefix-sum vs direct segment sums); directions
    equal up to sign (the sign of an eigenvector is not defined), with d
    following the sign, to 2e-3 for cells of 4+ points (d to 2e-3 per
    metre of |mean|).  A 3-point cell's
    plane is exact, so its normal is set by rounding when the points are
    near collinear: there only |cos| >= 0.99 between the two (measured
    worst 0.9978 on this scene)."""
    pa, pb, *_ = _scene_194()
    pts, leaf, cap, kind, table, origin = _BUILDS[case](pa, pb)
    kw = dict(table_size=table)
    if case == "plane_spread":
        kw["plane_min_spread"] = 0.05
    jm = _np(jvm.build(jnp.asarray(pts), jnp.ones(len(pts), bool), leaf, cap,
                       kind, origin=jnp.asarray(origin), **kw))
    tm = convert.to_numpy(tvm.build(
        torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool), leaf,
        cap, kind, origin=torch.from_numpy(origin), **kw))
    for f in ("coords", "count", "valid", "mask", "bucket_start",
              "bucket_count", "leaf", "origin"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    np.testing.assert_array_equal(tm.probe[:, 0::8].view(np.int32),
                                  jm.probe[:, 0::8].view(np.int32))
    np.testing.assert_array_equal(tm.stats[:, 0].view(np.int32),
                                  jm.stats[:, 0].view(np.int32))
    m = jm.mask
    np.testing.assert_allclose(tm.mean[m], jm.mean[m], atol=1e-4)
    sign = np.sign(np.sum(tm.direction * jm.direction, axis=1))
    sign[sign == 0] = 1.0
    ok = m & jm.valid & (jm.count >= 4)
    np.testing.assert_allclose((tm.direction * sign[:, None])[ok],
                               jm.direction[ok], atol=2e-3)
    # d = -n.mean: the normal's tolerance scales with the mean's range
    d_tol = 2e-3 * (1.0 + np.linalg.norm(jm.mean, axis=1))
    assert np.all(np.abs(tm.d * sign - jm.d)[ok] <= d_tol[ok])
    three = m & jm.valid & (jm.count == 3)
    cos = (np.abs(np.sum(tm.direction * jm.direction, axis=1))
           / np.maximum(np.sum(jm.direction ** 2, axis=1), 1e-12))
    assert np.all(cos[three] >= 0.99)
    assert ok.sum() > 10


def test_moments_match_jax():
    """points_to_moments / merge_moments (with trim and overflow) /
    moments_centroids: keys equal, counts exact, sums to 1e-4."""
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    a = RNG.uniform(-20, 20, (3000, 3)).astype(np.float32)
    b = RNG.uniform(-25, 25, (2000, 3)).astype(np.float32)
    ma, mb = RNG.random(3000) > 0.05, RNG.random(2000) > 0.05
    res = []
    for mod, T in ((jvm, jnp.asarray), (tvm, torch.from_numpy)):
        o = T(origin)
        A, da = mod.points_to_moments(T(a), T(ma), 0.4, o, 2048, group_bits=1,
                                      return_stats=True)
        B = mod.points_to_moments(T(b), T(mb), 0.4, o, 2048, group_bits=1)
        merge_kw = dict(trim_center=T(np.zeros(3, np.float32)),
                        trim_radius=22.0, leaf=0.4, origin=o, group_bits=1)
        if mod is jvm:
            M, dm = mod.merge_moments(A, B, 1500, return_stats=True, **merge_kw)
            cx, cm, cc = mod.moments_centroids(M, 0.4, o, group_bits=1,
                                               return_counts=True)
        else:
            M, dm = mod.merge_moments(A, B, 1500, return_stats=True,
                                      **merge_kw)
            cx, cm = mod.moments_centroids(M, 0.4, o, group_bits=1)
            cc = torch.where(cm, M.cnt, 0.0)
        res.append([np.asarray(x) if not hasattr(x, "numpy") else x.numpy()
                    for x in (A.key, A.cnt, A.rsum, da, M.key, M.cnt, M.rsum,
                              dm, cx, cm, cc)])
    (jA, jAc, jAr, jda, jM, jMc, jMr, jdm, jcx, jcm, jcc) = res[0]
    (tA, tAc, tAr, tda, tM, tMc, tMr, tdm, tcx, tcm, tcc) = res[1]
    assert jda > 0 and jdm > 0   # both tables overflowed: drops counted
    for w, g in ((jA, tA), (jAc, tAc), (jda, tda), (jM, tM), (jMc, tMc),
                 (jdm, tdm), (jcm, tcm), (jcc, tcc)):
        np.testing.assert_array_equal(g, w)
    for w, g in ((jAr, tAr), (jMr, tMr), (jcx, tcx)):
        np.testing.assert_allclose(g, w, atol=1e-4)


# ---------------------------------------------------------------------------
# lookup: the twin against msst_tpu
# ---------------------------------------------------------------------------


def test_lookup_cat_plain_matches_jax_lookup_cat():
    """On msst_tpu's own tables (carried over), the twin equals msst_tpu's
    lookup_cat field for field, bit for bit; and the CPU wrapper took the
    twin (no kernel launch counted)."""
    pa, pb, qa, qb, ma, mb = _scene_194()
    va = jvm.build(jnp.asarray(pa), jnp.ones(4096, bool), 0.5, 1024, "plane",
                   table_size=2048, origin=jnp.asarray([0.2, -0.1, 0.0]))
    vb = jvm.build(jnp.asarray(pb), jnp.ones(2048, bool), 1.0, 512, "line",
                   table_size=1024)
    q = np.concatenate([qa, qb])
    m = np.concatenate([ma, mb])
    want = _np(jvm.lookup_cat(va, vb, jnp.asarray(q), jnp.asarray(m), 512))
    launches = tvm.lookup_cat.launches
    got = tvm.lookup_cat(convert.from_numpy(_np(va), "cpu"),
                         convert.from_numpy(_np(vb), "cpu"),
                         torch.from_numpy(q), torch.from_numpy(m), 512)
    assert tvm.lookup_cat.launches == launches
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    assert 0 < int(got.found.sum()) < len(q)


def test_lookup_plain_matches_pallas_kernel():
    """The twin against msst_tpu's Pallas kernel in interpret mode, on the
    scene of tests/test_voxel.py::test_voxelmap_lookup_pallas_matches_xla:
    `found` everywhere; mean, direction and d where found (the Pallas idx
    is a voxel index, not a candidate slot, so it is not compared)."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-8, 8, (4096, 3)).astype(np.float32)
    pts[:, 2] = 0.05 * rng.standard_normal(4096)
    vm = jvm.build(jnp.asarray(pts), jnp.ones(4096, bool), 1.0, 1024, "plane",
                   table_size=2048)
    q = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    q[:, 2] = 0.3 * rng.standard_normal(512)
    qm = np.ones(512, bool)
    want = _np(lookup_pallas(vm, jnp.asarray(q), jnp.asarray(qm), interpret=True))
    tv = convert.from_numpy(_np(vm), "cpu")
    got = convert.to_numpy(tvm.lookup(tv, torch.from_numpy(q), torch.from_numpy(qm)))
    np.testing.assert_array_equal(got.found, want.found)
    f = want.found
    assert f.sum() > 100
    for name in ("mean", "direction", "d"):
        np.testing.assert_array_equal(getattr(got, name)[f],
                                      getattr(want, name)[f], err_msg=name)


def test_lookup_finds_member_voxels_on_port_built_map():
    """On a map the port builds itself: every member point of a valid voxel
    finds a voxel, and the nearest-mean winner never lies farther than the
    containing voxel's mean."""
    pts = RNG.uniform(-6, 6, (3000, 3)).astype(np.float32)
    pts[:, 2] = 0.02 * RNG.standard_normal(3000)
    vm = tvm.build(torch.from_numpy(pts), torch.ones(3000, dtype=torch.bool),
                   1.0, 512, "plane", table_size=1024,
                   origin=torch.zeros(3))
    hit = tvm.lookup(vm, torch.from_numpy(pts), torch.ones(3000, dtype=torch.bool))
    assert bool(hit.found.all())


@pytest.mark.parametrize("fault", ["q_dtype", "probe_dtype", "misaligned",
                                   "table_size", "n_a_below", "n_a_above"])
def test_kernel_launcher_raises_on_what_the_kernel_does_not_take(fault):
    """The launcher's checks run before anything needs the card, so on CPU
    tensors each fault raises and nothing is launched."""
    pts = RNG.uniform(-4, 4, (600, 3)).astype(np.float32)
    vm = tvm.build(torch.from_numpy(pts), torch.ones(600, dtype=torch.bool),
                   1.0, 256, "plane", table_size=512, origin=torch.zeros(3))
    q = torch.from_numpy(pts[:40].copy())
    qm = torch.ones(40, dtype=torch.bool)
    va, vb, n_a = vm, vm, 20
    if fault == "q_dtype":
        q = q.double()
    elif fault == "probe_dtype":
        vb = vm._replace(probe=vm.probe.double())
    elif fault == "misaligned":
        # the same rows one float past a 16-byte boundary
        flat = torch.zeros(vm.probe.numel() + 1)
        vb = vm._replace(probe=flat[1:].view(vm.probe.shape))
        assert vb.probe.data_ptr() % 16 and vb.probe.is_contiguous()
    elif fault == "table_size":
        # probe rows that disagree with the bucket table the twin hashes by
        vb = vm._replace(probe=vm.probe[:256].clone())
    elif fault == "n_a_below":
        n_a = -1
    else:
        n_a = 41
    before = tvm.lookup_cat.launches
    with pytest.raises(ValueError):
        tvm._lookup_cat_cuda(va, vb, q, qm, n_a)
    assert tvm.lookup_cat.launches == before


# ---------------------------------------------------------------------------
# scan-to-map Gauss-Newton
# ---------------------------------------------------------------------------


def _scene_256():
    """The scene of tests/test_voxel.py::test_scan_to_map_voxel_pallas_matches_xla."""
    rng = np.random.default_rng(9)
    n = 4096
    ground = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ground[:, 2] = 0.02 * rng.standard_normal(n)
    wall = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    wall[:, 1] = 8.0 + 0.02 * rng.standard_normal(n)
    wall[:, 2] = np.abs(wall[:, 2]) % 3
    map_pts = np.concatenate([ground, wall])
    svm = jvm.build(jnp.asarray(map_pts), jnp.ones(len(map_pts), bool), 1.0,
                    4096, "plane", table_size=8192)
    cvm = jvm.build(jnp.zeros((8, 3), jnp.float32), jnp.zeros(8, bool), 1.0, 8,
                    "line", table_size=16)
    scan = map_pts[rng.choice(len(map_pts), 1024, replace=False)]
    true_pose = np.asarray([0.01, -0.02, 0.05, 0.3, -0.2, 0.1], np.float32)
    T = jse3.Pose.from_vec6(jnp.asarray(true_pose))
    scan_local = np.asarray(T.inverse().apply(jnp.asarray(scan)))
    return cvm, svm, scan_local, true_pose


@pytest.mark.parametrize("reassoc", [(0.0, 0.0), (0.01, 0.02)])
def test_scan_to_map_voxel_matches_jax(reassoc):
    """Same pose (1e-5), degenerate flag and iteration count, with
    per-iteration and with frozen re-association."""
    cvm, svm, scan_local, true_pose = _scene_256()
    kw = dict(max_iters=10, eig_threshold=10.0, reassoc_rot=reassoc[0],
              reassoc_trans=reassoc[1])
    cm = np.zeros(8, bool)
    sm = np.ones(1024, bool)
    want = jreg.scan_to_map_voxel(
        jnp.zeros((8, 3), jnp.float32), jnp.asarray(cm), jnp.asarray(scan_local),
        jnp.asarray(sm), cvm, svm, jnp.zeros(6, jnp.float32), **kw)
    got = treg.scan_to_map_voxel(
        torch.zeros((8, 3)), torch.from_numpy(cm), torch.from_numpy(scan_local),
        torch.from_numpy(sm), convert.from_numpy(_np(cvm), "cpu"),
        convert.from_numpy(_np(svm), "cpu"), torch.zeros(6), **kw)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    assert bool(got.degenerate) == bool(want.degenerate)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.n_surf) == int(want.n_surf)
    pose = got.pose.numpy()
    assert abs(pose[5] - true_pose[5]) < 0.05
    assert abs(pose[4] - true_pose[4]) < 0.1


@pytest.mark.parametrize("reassoc", [(0.0, 0.0), (0.01, 0.02)])
def test_scan_to_map_voxel_counts_lookups(reassoc, monkeypatch):
    """``lookups`` is the number of voxel-map lookups the loop took: one an
    iteration without a re-association gate, the first and one after each
    move past the gate with it."""
    cvm, svm, scan_local, _ = _scene_256()
    calls = []
    inner = tvm.lookup_cat

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(tvm, "lookup_cat", counted)
    got = treg.scan_to_map_voxel(
        torch.zeros((8, 3)), torch.zeros(8, dtype=torch.bool),
        torch.from_numpy(scan_local), torch.ones(1024, dtype=torch.bool),
        convert.from_numpy(_np(cvm), "cpu"), convert.from_numpy(_np(svm), "cpu"),
        torch.zeros(6), max_iters=10, eig_threshold=10.0,
        reassoc_rot=reassoc[0], reassoc_trans=reassoc[1])
    assert got.lookups == len(calls)
    if reassoc == (0.0, 0.0):
        assert got.lookups == int(got.iterations)
    else:
        assert 1 < got.lookups < int(got.iterations)


def test_scan_to_map_voxel_flags_degenerate_plane():
    """A single ground plane leaves x, y and yaw unobserved: the degeneracy
    projection must fire in both packages."""
    rng = np.random.default_rng(2)
    ground = rng.uniform(-10, 10, (4096, 3)).astype(np.float32)
    ground[:, 2] = 0.01 * rng.standard_normal(4096)
    svm = jvm.build(jnp.asarray(ground), jnp.ones(4096, bool), 1.0, 2048,
                    "plane", table_size=4096)
    cvm = jvm.build(jnp.zeros((8, 3), jnp.float32), jnp.zeros(8, bool), 1.0, 8,
                    "line", table_size=16)
    scan = ground[:1024] + np.array([0.0, 0.0, -0.05], np.float32)
    got = treg.scan_to_map_voxel(
        torch.zeros((8, 3)), torch.zeros(8, dtype=torch.bool),
        torch.from_numpy(scan), torch.ones(1024, dtype=torch.bool),
        convert.from_numpy(_np(cvm), "cpu"), convert.from_numpy(_np(svm), "cpu"),
        torch.zeros(6), max_iters=10, eig_threshold=10.0)
    want = jreg.scan_to_map_voxel(
        jnp.zeros((8, 3), jnp.float32), jnp.zeros(8, bool), jnp.asarray(scan),
        jnp.ones(1024, bool), cvm, svm, jnp.zeros(6, jnp.float32),
        max_iters=10, eig_threshold=10.0)
    assert bool(got.degenerate) and bool(want.degenerate)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    assert abs(float(got.pose[5]) - 0.05) < 0.01
