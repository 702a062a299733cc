"""The port's fixed-order segment sums (``segments.segment_sum``,
``segments.fixed_order_sum``) and the graph's fixed-order scatter, against
msst_tpu's ``sorted_segment_sum``, a float64 sum, and the sequential
scatter-add whose order they keep.

Tolerances: against msst_tpu and float64, 1e-4 absolute on 262k metric rows
(tests/test_segments.py's bound for msst_tpu against numpy): each segment
is a float32 sum of a few rows in row order.  Against a sequential
``index_add_`` on the CPU, bit for bit: the same additions in the same
order.  Counts are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch.ops import graph as tgraph
from msst_torch.ops import segments as tseg
from msst_torch.utils.ring_graph import make_ring_graph
from msst_tpu.ops import segments as jseg

N_ROWS, N_SEG = 262144, 49152


def _metric_rows(seed, cols=4, dropped=1000):
    """Sorted segment ids (the last `dropped` rows at or past the end, a run
    of empty ids in the middle) and cell-centred metric rows (|r| <= 0.2 m,
    plus a count column)."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, N_SEG, N_ROWS))
    seg[(seg > 1000) & (seg < 1100)] = 1000
    seg[-dropped:] = N_SEG + rng.integers(0, 3, dropped)
    seg = np.sort(seg).astype(np.int32)
    vals = rng.uniform(-0.2, 0.2, (N_ROWS, cols)).astype(np.float32)
    vals[:, -1] = 1.0
    return vals, seg


def _f64(vals, seg, n):
    keep = seg < n
    out = np.zeros((n,) + vals.shape[1:], np.float64)
    np.add.at(out, seg[keep], vals[keep].astype(np.float64))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_matches_reference_and_float64(seed):
    vals, seg = _metric_rows(seed)
    got = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                           N_SEG).numpy()
    want = np.asarray(jseg.sorted_segment_sum(jnp.asarray(vals),
                                              jnp.asarray(seg), N_SEG))
    exact = _f64(vals, seg, N_SEG)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, exact, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[:, -1], exact[:, -1])   # counts
    assert np.all(got[1001:1100] == 0.0)                      # empty ids


def test_segment_sum_is_the_sequential_scatter_add():
    """Bit for bit the row-order sums of ``index_add_`` on the CPU (the
    port's sums before they were made order-fixed), 1-D and 2-D."""
    vals, seg = _metric_rows(2, cols=10)
    v, s = torch.from_numpy(vals), torch.from_numpy(seg)
    ids = torch.clamp(s, max=N_SEG).long()
    want = v.new_zeros((N_SEG + 1, 10)).index_add_(0, ids, v)[:N_SEG]
    assert torch.equal(tseg.segment_sum(v, s, N_SEG), want)
    assert torch.equal(tseg.segment_sum(v[:, 0].contiguous(), s, N_SEG),
                       want[:, 0])


def test_fixed_order_sum_runs():
    """Runs by offsets: rows summed in row order from 0, empty runs 0, rows
    past the last offset unread, trailing dimensions kept."""
    v = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    offsets = torch.tensor([0, 2, 2, 5, 6])
    got = tseg.fixed_order_sum(v, offsets)
    want = torch.stack([v[0:2].sum(0), torch.zeros(3), v[2:5].sum(0),
                        v[5:6].sum(0)])
    assert torch.equal(got, want)
    blocks = torch.arange(8 * 36, dtype=torch.float32).reshape(8, 6, 6)
    got = tseg.fixed_order_sum(blocks, offsets)
    assert got.shape == (4, 6, 6)
    assert torch.equal(got[2], blocks[2] + blocks[3] + blocks[4])


def test_graph_fixed_scatter_is_the_sequential_scatter_add():
    """The graph's scatter onto poses: each pose's terms in input order, bit
    for bit as ``index_add_`` adds them on the CPU, for unsorted indices
    with repeats and poses without terms."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 50, 700))
    idx[idx == 7] = 8
    vals = torch.from_numpy(rng.normal(size=(700, 6, 6)).astype(np.float32))
    got = tgraph._fixed_scatter(idx, 60)(vals)
    want = torch.zeros((60, 6, 6)).index_add_(0, idx, vals)
    assert torch.equal(got, want)
    assert torch.equal(got[7], torch.zeros(6, 6))


@pytest.mark.parametrize("K", [64, 200])
def test_graph_solvers_on_ring_graphs(K):
    """The dense and the CG solver on bench.py's ring graph: the dense
    normal equations assembled by the fixed-order scatters equal those of
    sequential index_put accumulation (bit for bit), and the two solvers
    agree as tests/test_graph.py holds them (2e-2 m)."""
    g = make_ring_graph(K, device="cpu")
    free = g.pose_mask
    H, gv = tgraph._assemble_dense(g, free, tgraph._dense_scatters(g))
    # the same blocks, accumulated by index_put in the same order
    Hw = torch.zeros_like(H)
    gw = torch.zeros_like(gv)
    ar6 = torch.arange(6)
    f, b, gf = g.priors, g.betweens, g.gps
    rp, Jp = tgraph._prior_terms(g.poses, f)
    rb, Ji, Jj = tgraph._between_terms(g.poses, b)
    rg, Jg = tgraph._gps_terms(g.poses, gf)
    for J1, J2, i1, i2, r in ((Jp, Jp, f.idx, f.idx, rp),
                              (Ji, Ji, b.i, b.i, rb), (Jj, Jj, b.j, b.j, rb),
                              (Ji, Jj, b.i, b.j, None),
                              (Jj, Ji, b.j, b.i, None),
                              (Jg, Jg, gf.idx, gf.idx, rg)):
        blk = torch.einsum("nri,nrj->nij", J1, J2)
        rows = i1.long()[:, None] * 6 + ar6
        cols = i2.long()[:, None] * 6 + ar6
        Hw.index_put_((rows[:, :, None].expand_as(blk),
                       cols[:, None, :].expand_as(blk)), blk, accumulate=True)
        if r is not None:
            gw.index_put_((rows,), torch.einsum("nri,nr->ni", J1, r),
                          accumulate=True)
    assert torch.equal(H, Hw) and torch.equal(gv, gw)
    dense = tgraph.optimize(g, iters=3)
    cg = tgraph.optimize_cg(g, iters=3)
    assert float((dense.poses.t - cg.poses.t).abs().max()) < 2e-2
