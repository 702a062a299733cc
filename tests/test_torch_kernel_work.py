"""The work counts behind the bounds of kernels B1 and B2
(``msst_torch.utils.kernel_work``), on a tiny hand-built voxel map and hash
grid whose distinct probe rows, bucket entries and candidate points are
known by hand.  The counts are exact integers."""

import torch

from msst_torch.ops import knn, voxelmap
from msst_torch.ops.numeric import hash3
from msst_torch.utils import kernel_work as kw


def _cells(rows):
    return torch.tensor(rows, dtype=torch.int32)


def test_voxel_lookup_work_counts_distinct_rows():
    """Map a (4096 buckets): four live queries at one point hash the same 8
    octant cells, a masked query one more cell (octant 0 only): 9 rows.
    Map b (one bucket): three live queries all read row 0: 1 row."""
    plane = torch.tensor([[0.5, 0.5, 0.5], [0.6, 0.4, 0.5], [0.4, 0.6, 0.5],
                          [0.5, 0.5, 0.52]])
    ones = torch.ones(4, dtype=torch.bool)
    va = voxelmap.build(plane, ones, 1.0, 8, "plane", table_size=4096,
                        origin=torch.zeros(3))
    vb = voxelmap.build(plane, ones, 1.0, 1, "plane", table_size=1,
                        origin=torch.zeros(3))
    # at (0.25, 0.25, 0.25) every axis steps down: the 8 cells around the
    # corner at the origin; the masked query's octant 0 is cell (10, 0, 0)
    cells = _cells([[0, 0, 0], [-1, 0, 0], [0, -1, 0], [0, 0, -1],
                    [-1, -1, 0], [-1, 0, -1], [0, -1, -1], [-1, -1, -1],
                    [10, 0, 0]])
    assert len(set(hash3(cells, 4096).tolist())) == 9   # no collision
    q = torch.tensor([[0.25, 0.25, 0.25]] * 4 + [[10.75, 0.25, 0.25]]
                     + [[0.3, 0.7, 2.2], [5.1, -3.3, 0.4], [-7.0, 1.0, 9.9]])
    qm = torch.tensor([True] * 4 + [False] + [True] * 3)
    work = kw.voxel_lookup_work(va, vb, q, qm, 5)
    assert work["rows"] == [9, 1]
    assert work["bytes"] == 10 * 96 + 8 * (13 + 33) + 2 * 16
    assert work["ops"] == 7 * (8 * 10 + 24 * 9)
    # one map for all queries: its rows counted once
    one = kw.voxel_lookup_work(va, va, q[:5], qm[:5], 5)
    assert one["rows"] == [9]
    assert one["bytes"] == 9 * 96 + 5 * (13 + 33) + 16


def test_knn_query_work_counts_distinct_reads():
    """Grid a (4096 buckets): a live query in cell (3, 5, 7) reads its 27
    distinct buckets and, with C = 2, the first 2 of cell (3, 5, 7)'s 3
    points and both of cell (4, 5, 7)'s; a masked query reads probe 0's
    entry, cell (19, 19, 19).  Grid b (one bucket): its two live queries
    read that bucket's entry once and the same first 2 points."""
    pts = torch.tensor([[3.1, 5.1, 7.1], [3.2, 5.2, 7.2], [3.3, 5.3, 7.3],
                        [4.5, 5.5, 7.5], [4.6, 5.5, 7.5],
                        [20.5, 20.5, 20.5]])
    ones = torch.ones(6, dtype=torch.bool)
    ga = knn.build(pts, ones, 1.0, 4096)
    gb = knn.build(pts, ones, 1.0, 1)
    around = _cells(knn._OFFSETS) + _cells([3, 5, 7])
    hashed = set(hash3(around, 4096).tolist())
    assert len(hashed) == 27
    assert int(hash3(_cells([[19, 19, 19]]), 4096)) not in hashed
    q = torch.tensor([[3.5, 5.5, 7.5], [20.5, 20.5, 20.5],
                      [3.5, 5.5, 7.5], [8.0, 8.0, 8.0]])
    qm = torch.tensor([True, False, True, True])
    res = knn.query_cat_plain(ga, gb, q, qm, 2, k=5, candidates_per_cell=2)
    work = kw.knn_query_work(ga, gb, q, qm, 2, 2, res.idx)
    assert work["bucket_entries"] == 27 + 1 + 1
    assert work["points"] == 4 + 2
    assert work["candidates"] == 4 + 2 + 2
    winners = (len(set(res.idx[:2].reshape(-1).tolist()))
               + len(set(res.idx[2:].reshape(-1).tolist())))
    assert work["winners"] == winners
    assert work["bytes"] == (29 * 8 + 6 * 12 + winners * 4 + 4 * 13 + 2 * 4
                             + 4 * 5 * 9)
    assert work["ops"] == 3 * 27 * 10 + 8 * 9
