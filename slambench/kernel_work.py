# Frozen copy of msst_torch/utils/kernel_work.py at commit e686079, part of
# the benchmark's yardstick.  Changed: the hashing and bucket arithmetic come
# from the benchmark's reference copy (slambench/ref), and the table of the
# card's peaks and the least time of a call (least_seconds) are added.
"""The least work of kernels B1 (``voxelmap.lookup_cat``) and B2
(``knn.query_cat``) on given inputs, for their rooflines in the benchmark.

Each count is what these inputs need, not the whole tables: every input
byte the function must read counted once (each distinct probe row, bucket
entry, candidate point and ``orig_idx`` entry the queries reach, once however
many queries reach it), every output byte written once, and the operations
that the inputs' live queries need.  The counts use the twins' cell and
bucket arithmetic, so they run on the CPU as on the card.
"""

from __future__ import annotations

import torch

from .ref.ops import knn, voxelmap
from .ref.ops.voxelmap import PROBE_C

Tensor = torch.Tensor

ROW_BYTES = PROBE_C * 8 * 4      # one probe row of a voxel feature map
ENTRY_BYTES = 8                  # bucket_start + bucket_count of a bucket
POINT_BYTES = 12                 # one float32 point
QUERY_BYTES = 12 + 1             # a query point and its mask flag
LOOKUP_OUT_BYTES = 4 + 1 + 12 + 12 + 4   # idx, found, mean, direction, d
KNN_SLOT_BYTES = 4 + 4 + 1               # sqdist, idx, valid
HASH_OPS = 10                    # integer operations to hash one cell
DIST_OPS = 9                     # 3 differences, 3 products, 2 sums, 1 compare


def _parts(a, b, n_a: int, n_q: int):
    """[(table, query slice)]: one entry where both are the same table."""
    if a is b:
        return [(a, slice(0, n_q))]
    return [(a, slice(0, n_a)), (b, slice(n_a, n_q))]


def _lookup_rows(vmap: voxelmap.VoxelFeatureMap, q_xyz: Tensor,
                 q_mask: Tensor) -> Tensor:
    """The probe rows the queries read: 8 for a live query, octant 0's for
    a masked one."""
    rows = voxelmap._hash3(voxelmap.octant_cells(q_xyz, vmap.leaf,
                                                 vmap.origin),
                           vmap.table_size)
    return torch.cat([rows[q_mask].reshape(-1), rows[~q_mask, 0]])


def voxel_lookup_work(vmap_a, vmap_b, q_xyz: Tensor, q_mask: Tensor,
                      n_a: int) -> dict:
    """Bytes and operations of ``lookup_cat(vmap_a, vmap_b, q, mask, n_a)``:
    each distinct probe row read once (96 B), the queries, the maps' leaf
    and origin, the outputs; a live query hashes 8 cells and measures 24
    candidates."""
    Qn = q_xyz.shape[0]
    rows = []
    for vmap, part in _parts(vmap_a, vmap_b, n_a, Qn):
        rows.append(int(torch.unique(_lookup_rows(
            vmap, q_xyz[part], q_mask[part])).numel()))
    n_bytes = (sum(rows) * ROW_BYTES + Qn * (QUERY_BYTES + LOOKUP_OUT_BYTES)
               + len(rows) * 16)
    n_ops = int(q_mask.sum()) * (8 * HASH_OPS + 8 * PROBE_C * DIST_OPS)
    return {"bytes": n_bytes, "ops": n_ops, "rows": rows}


def _knn_reads(grid: knn.HashGrid, q_xyz: Tensor, q_mask: Tensor,
               candidates_per_cell: int):
    """(bucket entries, candidate positions, candidates measured) of one
    grid's queries: a live query reads its 27 probes' entries and the first
    C points of each bucket no earlier probe visited; a masked query reads
    probe 0's entry only."""
    hb, first = knn.probe_buckets(grid, q_xyz)
    entries = torch.cat([hb[q_mask].reshape(-1), hb[~q_mask, 0]])
    take = first & q_mask[:, None]
    start = grid.bucket_start[hb][take]
    count = torch.clamp(grid.bucket_count[hb][take], max=candidates_per_cell)
    lane = torch.arange(candidates_per_cell, device=q_xyz.device)
    pos = (start[:, None] + lane)[lane < count[:, None]]
    return entries, pos, int(count.sum())


def knn_query_work(grid_a, grid_b, q_xyz: Tensor, q_mask: Tensor, n_a: int,
                   candidates_per_cell: int, idx: Tensor) -> dict:
    """Bytes and operations of ``query_cat(grid_a, grid_b, q, mask, n_a,
    k, C)`` whose result's indices are `idx` (Q, k): each distinct bucket
    entry (8 B), candidate point (12 B) and winner's ``orig_idx`` entry
    (4 B, one per distinct output index) read once, the queries, the cell
    sizes, the outputs; a live query hashes 27 cells, and each candidate
    measured costs DIST_OPS."""
    Qn, k = idx.shape
    entries = points = winners = n_cand = 0
    for grid, part in _parts(grid_a, grid_b, n_a, Qn):
        e, pos, n = _knn_reads(grid, q_xyz[part], q_mask[part],
                               candidates_per_cell)
        entries += int(torch.unique(e).numel())
        points += int(torch.unique(pos).numel())
        winners += int(torch.unique(idx[part]).numel())
        n_cand += n
    n_grids = 1 if grid_a is grid_b else 2
    n_bytes = (entries * ENTRY_BYTES + points * POINT_BYTES
               + winners * 4 + Qn * QUERY_BYTES + n_grids * 4
               + Qn * k * KNN_SLOT_BYTES)
    n_ops = int(q_mask.sum()) * 27 * HASH_OPS + n_cand * DIST_OPS
    return {"bytes": n_bytes, "ops": n_ops, "bucket_entries": entries,
            "points": points, "winners": winners, "candidates": n_cand}


# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: HBM bandwidth and
# float32 outside the tensor cores (the kernels' arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def least_seconds(work: dict) -> float:
    """The least time the card could take for a call's work: the larger of
    its bytes at the memory peak and its operations at the float32 peak."""
    return max(work["bytes"] / PEAK_BYTES_PER_S,
               work["ops"] / PEAK_F32_OPS_PER_S)
