"""The port's hash-grid k-NN (msst_torch.ops.knn) and packed voxel
downsample against msst_tpu, on the CPU.

On a CPU tensor ``knn.query`` runs its plain twin ``query_plain``; the CUDA
kernel ``msst_torch/csrc/knn_query.cu`` is held bit-equal to that twin on
the card by ``chip_smoke.py``.  Here the twin is held against msst_tpu's
XLA form ``knn.query`` and its Pallas kernel ``query_pallas`` in interpret
mode.

Tolerances: every discrete result (hash, bucket tables, sort order, valid
flags, neighbour indices) is exact.  Squared distances agree to 1e-5 (the
three squares are summed in an order XLA is free to choose; the existing
Pallas-vs-XLA test uses the same bound), plus 5e-7 relative (a few float32
ULPs) for the far points that a colliding bucket brings in, whose squared
distances run to hundreds.  Voxel centroids agree to 1e-5 m
(msst_tpu sums a voxel's residuals as a difference of float32 prefix sums,
the port with a scatter-add)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch.ops import knn as tknn
from msst_torch.ops import segments as tseg
from msst_torch.ops import voxel as tvoxel
from msst_torch.ops.pointcloud import Cloud as TCloud
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import segments as jseg
from msst_tpu.ops import voxel as jvoxel
from msst_tpu.ops.knn_pallas import query_pallas
from msst_tpu.ops.pointcloud import Cloud as JCloud

SQDIST_ATOL = 1e-5
SQDIST_RTOL = 5e-7
CENTROID_ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.asarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def _jgrid(pts, mask, cell, table):
    return jknn.build(J(pts), J(mask), cell, table)


def _tgrid(pts, mask, cell, table):
    return tknn.build(T(pts), T(mask), cell, table)


# ---------------------------------------------------------------------------
# hash, segment boundaries, build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table_size", [64, 4096, 32768, 1000003])
def test_hash_coords_bit_exact(table_size):
    """10^5 cells with the int32 extremes, a hash that is exactly INT32_MIN
    aside, and a table size that is not a power of two."""
    rng = np.random.default_rng(11)
    c = rng.integers(-2**31, 2**31, size=(100000, 3), dtype=np.int64)
    c[:20000] = rng.integers(-600, 600, size=(20000, 3))
    ext = np.array([-2**31, 2**31 - 1, 0, -1, 1], np.int64)
    c[20000:20125] = np.stack(np.meshgrid(ext, ext, ext), -1).reshape(-1, 3)
    c = c.astype(np.int32)
    want = np.asarray(jknn._hash_coords(J(c), table_size))
    got = tknn._hash_coords(T(c), table_size).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # batched cells (Q, 27, 3), as the query hashes them
    np.testing.assert_array_equal(
        tknn._hash_coords(T(c[:2700].reshape(100, 27, 3)), table_size).numpy(),
        want[:2700].reshape(100, 27))


def test_offsets_order_matches_jax():
    np.testing.assert_array_equal(np.array(tknn._OFFSETS, np.int32),
                                  np.asarray(jknn._OFFSETS))


@pytest.mark.parametrize("case", ["dense", "gaps", "excluded_tail", "empty"])
def test_segment_boundaries_match_jax(case):
    rng = np.random.default_rng(2)
    S = 40
    if case == "dense":
        seg = np.sort(rng.integers(0, S, size=500))
    elif case == "gaps":
        seg = np.sort(rng.choice([0, 3, 4, 17, 38], size=200))
    elif case == "excluded_tail":
        seg = np.sort(np.where(rng.random(300) < 0.3, S,
                               rng.integers(0, S - 5, size=300)))
    else:
        seg = np.full(50, S)
    seg = seg.astype(np.int32)
    jlo, jhi = jseg.segment_boundaries(J(seg), S)
    tlo, thi = tseg.segment_boundaries(T(seg), S)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def _build_case(case):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-10, 10, size=(1500, 3)).astype(np.float32)
    mask = np.ones(1500, bool)
    table = 2048
    if case == "masked":
        mask[rng.random(1500) < 0.3] = False
    elif case == "duplicates":
        # repeated points: equal hashes, so only a stable sort keeps JAX's
        # order within a bucket
        pts[500:1000] = pts[:500]
        pts[1000:1200] = pts[0]
    elif case == "tiny_table":
        table = 64
    elif case == "all_masked":
        mask[:] = False
    return pts, mask, table


@pytest.mark.parametrize("case", ["plain", "masked", "duplicates",
                                  "tiny_table", "all_masked"])
def test_build_matches_jax_exactly(case):
    pts, mask, table = _build_case(case)
    jg, tg = _jgrid(pts, mask, 1.0, table), _tgrid(pts, mask, 1.0, table)
    assert tg.table_size == jg.table_size == table
    for f in ("xyz", "orig_idx", "bucket_start", "bucket_count", "cell_size"):
        got, want = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def _query_case(case):
    """(pts, mask, table, cell, q, q_mask, k, C, max_sqdist)"""
    rng = np.random.default_rng(3)
    if case == "test_knn_case":
        # the case of tests/test_knn.py::test_pallas_query_interpret_matches_xla
        pts = rng.uniform(-10, 10, size=(1500, 3)).astype(np.float32)
        q = rng.uniform(-9, 9, size=(256, 3)).astype(np.float32)
        mask = np.ones(1500, bool)
        mask[:100] = False
        return pts, mask, 2048, 1.0, q, np.ones(256, bool), 5, 32, 1.0
    pts = rng.uniform(-6, 6, size=(3000, 3)).astype(np.float32)
    q = rng.uniform(-6.5, 6.5, size=(200, 3)).astype(np.float32)
    mask = np.ones(3000, bool)
    q_mask = np.ones(200, bool)
    table, cell, k, C, max_sq = 4096, 1.0, 5, 24, np.inf
    if case == "k1":
        k = 1
    elif case == "k5_default_inf":
        pass
    elif case == "bucket_overflow":
        C = 2            # ~1.7 points a cell: many buckets hold more than 2
    elif case == "table_64":
        table, C = 64, 4   # most of the 27 probes collide; buckets overflow
    elif case == "masked_queries":
        q_mask[::3] = False
    elif case == "few_neighbours":
        # a sparse cloud: most queries find fewer than k points, many none
        pts = rng.uniform(-20, 20, size=(300, 3)).astype(np.float32)
        mask = np.ones(300, bool)
        mask[::4] = False
        table = 512
    elif case == "duplicate_points":
        # exact distance ties, resolved by lane order
        pts[1500:] = pts[:1500]
        q = pts[:200] + np.float32(0.01)
    elif case == "max_sqdist":
        max_sq = 0.25
    elif case == "cell_2m":
        cell = 2.0
    else:
        raise KeyError(case)
    return pts, mask, table, cell, q, q_mask, k, C, max_sq


_QUERY_CASES = ["test_knn_case", "k1", "k5_default_inf", "bucket_overflow",
                "table_64", "masked_queries", "few_neighbours",
                "duplicate_points", "max_sqdist", "cell_2m"]


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", _QUERY_CASES)
def test_query_matches_jax(case, reference):
    pts, mask, table, cell, q, q_mask, k, C, max_sq = _query_case(case)
    jg = _jgrid(pts, mask, cell, table)
    if reference == "xla":
        want = jknn.query(jg, J(q), J(q_mask), k=k, candidates_per_cell=C,
                          max_sqdist=max_sq)
    else:
        want = query_pallas(jg, J(q), J(q_mask), k=k, candidates_per_cell=C,
                            max_sqdist=max_sq, tile=128, interpret=True)
    got = tknn.query(_tgrid(pts, mask, cell, table), T(q), T(q_mask), k=k,
                     candidates_per_cell=C, max_sqdist=max_sq)
    w_valid, w_idx = np.asarray(want.valid), np.asarray(want.idx)
    w_d = np.asarray(want.sqdist)
    g_valid, g_idx, g_d = (got.valid.numpy(), got.idx.numpy(),
                           got.sqdist.numpy())
    assert g_idx.dtype == np.int32 and g_idx.shape == (len(q), k)
    np.testing.assert_array_equal(g_valid, w_valid)
    # every slot's index is usable, valid or not
    assert g_idx.min() >= 0 and g_idx.max() < len(pts)
    np.testing.assert_array_equal(g_idx[w_valid], w_idx[w_valid])
    np.testing.assert_allclose(g_d[w_valid], w_d[w_valid], atol=SQDIST_ATOL,
                               rtol=SQDIST_RTOL)
    # a slot that found nothing holds inf, and the same index as JAX's
    found = np.isfinite(w_d)
    np.testing.assert_array_equal(np.isfinite(g_d), found)
    np.testing.assert_array_equal(g_idx[~found], w_idx[~found])
    if case in ("few_neighbours", "masked_queries"):
        assert (~found).any() and found.any()
    if case == "table_64":
        # the case does what it is for: probes collide on most queries
        hb = np.asarray(jknn._hash_coords(
            np.floor(q / cell).astype(np.int32)[:, None, :]
            + np.asarray(jknn._OFFSETS)[None], table))
        dup = np.array([len(set(r)) < 27 for r in hb])
        assert dup.mean() > 0.5


def test_query_indices_point_to_original_array():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    q = pts[:50] + np.float32(1e-3)
    res = tknn.query(_tgrid(pts, np.ones(500, bool), 1.0, 1024), T(q),
                     torch.ones(50, dtype=torch.bool), k=1,
                     candidates_per_cell=32)
    np.testing.assert_array_equal(res.idx.numpy()[:, 0], np.arange(50))


def test_radius_count_matches_jax():
    """The case of tests/test_knn.py::test_radius_count (k = C = 64, where
    msst_tpu selects by lax.top_k: only the count is compared)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, size=(1000, 3)).astype(np.float32)
    q = rng.uniform(-4, 4, size=(50, 3)).astype(np.float32)
    ones = np.ones(1000, bool)
    want = np.asarray(jknn.radius_count(_jgrid(pts, ones, 1.0, 2048), J(q),
                                        jnp.ones(50, bool), radius=1.0,
                                        candidates_per_cell=64))
    got = tknn.radius_count(_tgrid(pts, ones, 1.0, 2048), T(q),
                            torch.ones(50, dtype=torch.bool), radius=1.0,
                            candidates_per_cell=64).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() > 3


def test_query_on_cuda_tensor_never_takes_the_twin(monkeypatch):
    """The dispatch sends only CPU tensors to ``query_plain``: for any
    other device it goes to the kernel launcher (which raises where it
    cannot launch)."""
    called = []
    monkeypatch.setattr(tknn, "query_plain",
                        lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(tknn, "_query_cuda",
                        lambda *a, **k: called.append("cuda"))

    class OnCard:
        device = torch.device("cuda", 0)

    tknn.query(None, OnCard(), None)
    tknn.query(None, torch.zeros(1, 3), None)
    assert called == ["cuda", "plain"]


def _second_grid(pts, mask, cell, table):
    """A second map for query_cat: the points reversed and shrunk, in a
    table of another size."""
    return (np.ascontiguousarray(pts[::-1] * np.float32(0.9)),
            np.ascontiguousarray(mask[::-1]), cell, max(64, table // 2))


@pytest.mark.parametrize("case", _QUERY_CASES)
def test_query_cat_plain_matches_jax(case):
    """query_cat_plain over two maps equals two msst_tpu ``knn.query``
    calls, concatenated, at every case of test_query_matches_jax; the split
    n_a is not a multiple of any lane group."""
    pts, mask, table, cell, q, q_mask, k, C, max_sq = _query_case(case)
    pts_b, mask_b, cell_b, table_b = _second_grid(pts, mask, cell, table)
    n_a = len(q) // 3 + 1
    parts = [jknn.query(_jgrid(p, m, c, h), J(qq), J(qm), k=k,
                        candidates_per_cell=C, max_sqdist=max_sq)
             for p, m, c, h, qq, qm in (
                 (pts, mask, cell, table, q[:n_a], q_mask[:n_a]),
                 (pts_b, mask_b, cell_b, table_b, q[n_a:], q_mask[n_a:]))]
    w_valid, w_idx, w_d = (np.concatenate([np.asarray(getattr(w, f))
                                           for w in parts])
                           for f in ("valid", "idx", "sqdist"))
    got = tknn.query_cat_plain(_tgrid(pts, mask, cell, table),
                               _tgrid(pts_b, mask_b, cell_b, table_b), T(q),
                               T(q_mask), n_a, k=k, candidates_per_cell=C,
                               max_sqdist=max_sq)
    g_valid, g_idx, g_d = (got.valid.numpy(), got.idx.numpy(),
                           got.sqdist.numpy())
    assert g_idx.dtype == np.int32 and g_idx.shape == (len(q), k)
    np.testing.assert_array_equal(g_valid, w_valid)
    np.testing.assert_array_equal(g_idx[w_valid], w_idx[w_valid])
    np.testing.assert_allclose(g_d[w_valid], w_d[w_valid], atol=SQDIST_ATOL,
                               rtol=SQDIST_RTOL)
    found = np.isfinite(w_d)
    np.testing.assert_array_equal(np.isfinite(g_d), found)
    np.testing.assert_array_equal(g_idx[~found], w_idx[~found])


def test_query_cat_dispatch_equals_two_queries_on_cpu():
    """On CPU tensors query_cat takes the twin, launches nothing, and gives
    the two one-map queries' rows bit for bit."""
    pts, mask, table, cell, q, q_mask, k, C, max_sq = _query_case("table_64")
    pts_b, mask_b, cell_b, table_b = _second_grid(pts, mask, cell, table)
    ga = _tgrid(pts, mask, cell, table)
    gb = _tgrid(pts_b, mask_b, cell_b, table_b)
    before = tknn.query.launches
    got = tknn.query_cat(ga, gb, T(q), T(q_mask), 77, k=k,
                         candidates_per_cell=C)
    assert tknn.query.launches == before
    a = tknn.query(ga, T(q[:77]), T(q_mask[:77]), k=k, candidates_per_cell=C)
    b = tknn.query(gb, T(q[77:]), T(q_mask[77:]), k=k, candidates_per_cell=C)
    for f in ("idx", "sqdist", "valid"):
        assert torch.equal(getattr(got, f),
                           torch.cat([getattr(a, f), getattr(b, f)])), f


def test_query_cat_on_cuda_tensor_never_takes_the_twin(monkeypatch):
    """As for query: only CPU tensors go to ``query_cat_plain``; any other
    device goes to the kernel launcher (which raises where it cannot
    launch)."""
    called = []
    monkeypatch.setattr(tknn, "query_cat_plain",
                        lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(tknn, "_query_cat_cuda",
                        lambda *a, **k: called.append("cuda"))

    class OnCard:
        device = torch.device("cuda", 0)

    tknn.query_cat(None, None, OnCard(), None, 0)
    tknn.query_cat(None, None, torch.zeros(1, 3), None, 0)
    assert called == ["cuda", "plain"]


def _launch_args():
    """A valid call of the kernel launcher, on CPU tensors: each check runs
    before anything needs the card."""
    pts, mask, table, cell, q, q_mask, k, C, _ = _query_case("k5_default_inf")
    g = _tgrid(pts, mask, cell, table)
    return dict(grid_a=g, grid_b=g, q_xyz=T(q), q_mask=T(q_mask), n_a=50,
                k=k, candidates_per_cell=C, max_sqdist=np.inf)


@pytest.mark.parametrize("fault", ["q_dtype", "grid_dtype", "mask_dtype",
                                   "non_contiguous", "n_a_below",
                                   "n_a_above", "k_zero", "k_above",
                                   "no_candidates", "mask_shape"])
def test_kernel_launcher_raises_on_what_the_kernel_does_not_take(fault):
    args = _launch_args()
    g = args["grid_a"]
    if fault == "q_dtype":
        args["q_xyz"] = args["q_xyz"].double()
    elif fault == "grid_dtype":
        args["grid_b"] = g._replace(bucket_start=g.bucket_start.long())
    elif fault == "mask_dtype":
        args["q_mask"] = args["q_mask"].to(torch.uint8)
    elif fault == "non_contiguous":
        args["q_xyz"] = args["q_xyz"].T.contiguous().T
    elif fault == "n_a_below":
        args["n_a"] = -1
    elif fault == "n_a_above":
        args["n_a"] = args["q_xyz"].shape[0] + 1
    elif fault == "k_zero":
        args["k"] = 0
    elif fault == "k_above":
        args["k"] = tknn.KERNEL_MAX_K + 1
    elif fault == "no_candidates":
        args["candidates_per_cell"] = 0
    else:
        args["q_mask"] = args["q_mask"][:-1]
    before = tknn.query.launches
    with pytest.raises(ValueError):
        tknn._query_cat_cuda(**args)
    assert tknn.query.launches == before


# ---------------------------------------------------------------------------
# voxel_downsample_packed
# ---------------------------------------------------------------------------


def _packed_case(case):
    rng = np.random.default_rng(9)
    n, leaf, cap = 4000, 0.4, 4000
    origin = np.array([12.0, -7.0, 1.5], np.float32)
    pts = (origin + rng.uniform(-8, 8, size=(n, 3))).astype(np.float32)
    mask = rng.random(n) < 0.9
    if case == "out_of_domain":
        # beyond +-512 cells of the origin on one axis: dropped
        pts[:300, 0] += np.float32(513 * leaf)
        pts[300:500, 2] -= np.float32(600 * leaf)
    elif case == "overflow":
        cap = 700        # far fewer slots than occupied voxels
    elif case == "all_valid":
        mask[:] = True
        cap = 5000       # output larger than the input
    elif case == "clustered":
        pts = (origin + rng.normal(scale=0.5, size=(n, 3))).astype(np.float32)
    return pts, mask, leaf, origin, cap


@pytest.mark.parametrize("case", ["plain", "out_of_domain", "overflow",
                                  "all_valid", "clustered"])
def test_voxel_downsample_packed_matches_jax(case):
    pts, mask, leaf, origin, cap = _packed_case(case)
    want = jvoxel.voxel_downsample_packed(
        JCloud.create(J(pts), mask=J(mask)), leaf, J(origin), capacity=cap)
    got = tvoxel.voxel_downsample_packed(
        TCloud.create(T(pts), mask=T(mask)), leaf, T(origin), capacity=cap)
    w_mask = np.asarray(want.mask)
    assert got.xyz.shape == (cap, 3)
    np.testing.assert_array_equal(got.mask.numpy(), w_mask)
    assert w_mask.any()
    # same voxels in the same (ascending key) order, same centroids; the
    # rows past the last voxel agree too (the map cloud is hashed whole)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=CENTROID_ATOL)
    if case == "out_of_domain":
        kept = got.xyz.numpy()[w_mask]
        assert np.abs(kept - origin).max() <= 512 * leaf
        assert w_mask.sum() < (mask.sum() - 400)
    if case == "overflow":
        assert w_mask.all()


def test_voxel_downsample_packed_carries_attrs():
    rng = np.random.default_rng(10)
    pts = rng.uniform(-3, 3, size=(600, 3)).astype(np.float32)
    attrs = rng.normal(size=(600, 2)).astype(np.float32)
    mask = rng.random(600) < 0.8
    origin = np.zeros(3, np.float32)
    want = jvoxel.voxel_downsample_packed(
        JCloud.create(J(pts), mask=J(mask), attrs=J(attrs)), 0.5, J(origin))
    got = tvoxel.voxel_downsample_packed(
        TCloud.create(T(pts), mask=T(mask), attrs=T(attrs)), 0.5, T(origin))
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    np.testing.assert_allclose(got.attrs.numpy()[m], np.asarray(want.attrs)[m],
                               atol=1e-5)
