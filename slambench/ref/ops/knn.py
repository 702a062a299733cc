# Frozen copy of msst_torch/ops/knn.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
# Changed: query and query_cat always take the plain twins.
"""Hash-grid nearest-neighbour search (port of ``msst_tpu.ops.knn``).

Replaces the ``pcl::KdTreeFLANN`` 5-NN corner/surf map lookups inside
scan-to-map Gauss-Newton (``mapOptmization.cpp:987,1081``).  Points are
bucketed by a spatial hash of their cell (cell size >= the query radius, so
a query only needs the 27 neighbouring cells).  The bucket table is built
with one stable sort; a query gathers up to a fixed number of candidates a
cell and takes the exact k smallest among them.  It is exact k-NN as long
as no bucket overflows its candidate cap and the true neighbours lie within
one cell size of the query.

:func:`query_cat` (both maps' queries in one pass) is the hot op of the
knn scan-to-map path.  On a CUDA tensor it and :func:`query` run as the
hand-written kernel ``msst_torch/csrc/knn_query.cu``, on a CPU tensor as
their plain PyTorch twins :func:`query_cat_plain` and :func:`query_plain`.
:func:`nearest1_brute`, the exact 1-NN of the loop-closure ICP, is a
chunked dense sweep.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import segments
from .numeric import hash3 as _hash_coords

Tensor = torch.Tensor

# the 27 neighbour cells in probe order: dx outermost, dz innermost
_OFFSETS = tuple((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dz in (-1, 0, 1))

# largest k the CUDA kernel keeps in its per-lane sorted lists
KERNEL_MAX_K = 64


class HashGrid(NamedTuple):
    """Built spatial hash over a fixed-capacity point set."""

    xyz: Tensor           # (N, 3) points sorted by bucket
    orig_idx: Tensor      # (N,) int32 index into the original array
    bucket_start: Tensor  # (H,) int32 offset of each bucket in the sorted arrays
    bucket_count: Tensor  # (H,) int32
    cell_size: Tensor     # () float32

    @property
    def table_size(self) -> int:
        return self.bucket_start.shape[0]


class KnnResult(NamedTuple):
    idx: Tensor     # (Q, k) int32 indices into the ORIGINAL point array
    sqdist: Tensor  # (Q, k) squared distances, inf where no neighbour
    valid: Tensor   # (Q, k) bool


def build(xyz: Tensor, mask: Tensor, cell_size: float,
          table_size: int = 8192) -> HashGrid:
    """Hash, sort, bucket offsets.  The sort is stable, as msst_tpu's: the
    order within a bucket decides which points are among the first
    candidates when a bucket overflows, and every tie of a query.  Masked
    points go to an overflow bucket past the table."""
    cell = torch.tensor(cell_size, dtype=torch.float32, device=xyz.device)
    coords = torch.floor(xyz / cell).to(torch.int32)
    h = _hash_coords(coords, table_size)
    h = torch.where(mask, h, table_size)
    order = torch.argsort(h, stable=True)
    starts, ends = segments.segment_boundaries(h[order], table_size)
    return HashGrid(xyz=xyz[order], orig_idx=order.to(torch.int32),
                    bucket_start=starts.to(torch.int32),
                    bucket_count=(ends - starts).to(torch.int32),
                    cell_size=cell)


def _small_topk_min(d2: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k smallest of each row, ascending, by k masked argmin passes:
    equal values come out in ascending lane order, and once a row holds only
    inf the pick is lane 0.  (msst_tpu switches to ``lax.top_k`` above
    k = 16; that differs only in the order of equal values.)"""
    rows = torch.arange(d2.shape[0], device=d2.device)
    vals, idxs = [], []
    work = d2.clone()
    for _ in range(k):
        i = torch.argmin(work, dim=1)
        vals.append(work[rows, i])
        idxs.append(i)
        work[rows, i] = torch.inf
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def probe_buckets(grid: HashGrid, q_xyz: Tensor) -> tuple[Tensor, Tensor]:
    """(hb, first): the bucket (Q, 27) int64 of each query's 27 probes in
    probe order, and whether no earlier probe of the query hit that bucket
    (Q, 27) bool."""
    offsets = torch.tensor(_OFFSETS, dtype=torch.int32, device=q_xyz.device)
    qc = torch.floor(q_xyz / grid.cell_size).to(torch.int32)
    cells = qc[:, None, :] + offsets[None]                      # (Q, 27, 3)
    hb = _hash_coords(cells, grid.table_size).long()
    eq = hb[:, :, None] == hb[:, None, :]                       # (Q, 27, 27)
    earlier = torch.tril(torch.ones((27, 27), dtype=torch.bool,
                                    device=q_xyz.device), diagonal=-1)
    return hb, ~torch.any(eq & earlier[None], dim=2)


def query_plain(grid: HashGrid, q_xyz: Tensor, q_mask: Tensor, k: int = 5,
                candidates_per_cell: int = 16,
                max_sqdist: float = math.inf) -> KnnResult:
    """The query in plain PyTorch (the kernel's twin), step by step as
    msst_tpu's ``knn.query``: gather (Q, 27*C) candidates, k masked argmins.

    A probe whose bucket equals an earlier probe's contributes nothing.  A
    slot without a neighbour holds inf and the index of the first lane
    (the first point of probe 0's bucket, or the last sorted point when
    that bucket is empty), so every index lies in [0, N).  A masked query
    has no neighbour, so only its probe 0 is looked up."""
    C = candidates_per_cell
    dev = q_xyz.device
    n = grid.xyz.shape[0]
    offsets = torch.tensor(_OFFSETS[0], dtype=torch.int32, device=dev)
    hb0 = _hash_coords(torch.floor(q_xyz / grid.cell_size).to(torch.int32)
                       + offsets, grid.table_size).long()
    first_lane = torch.where(grid.bucket_count[hb0] > 0,
                             grid.bucket_start[hb0], n - 1).long()
    idx = first_lane[:, None].repeat(1, k)
    d2k = q_xyz.new_full((q_xyz.shape[0], k), math.inf)
    live = torch.nonzero(q_mask).squeeze(1)
    if live.numel():
        q = q_xyz[live]
        hb, first_probe = probe_buckets(grid, q)
        start = grid.bucket_start[hb]
        count = grid.bucket_count[hb]
        lane = torch.arange(C, dtype=torch.int32, device=dev)
        cand = start[..., None] + lane                          # (R, 27, C)
        ok = lane < count[..., None]
        cand = torch.where(ok, cand, n - 1).reshape(len(live), 27 * C).long()
        ok = (ok & first_probe[..., None]).reshape(len(live), 27 * C)
        diff = grid.xyz[cand] - q[:, None, :]                   # (R, 27C, 3)
        # written out in the kernel's order: (dx*dx + dy*dy) + dz*dz
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        d2 = torch.where(ok, d2, torch.inf)
        d2k[live], sel = _small_topk_min(d2, k)
        idx[live] = torch.gather(cand, 1, sel)
    valid = torch.isfinite(d2k) & (d2k <= max_sqdist)
    return KnnResult(grid.orig_idx[idx], d2k, valid)


def query_cat_plain(grid_a: HashGrid, grid_b: HashGrid, q_xyz: Tensor,
                    q_mask: Tensor, n_a: int, k: int = 5,
                    candidates_per_cell: int = 16,
                    max_sqdist: float = math.inf) -> KnnResult:
    """Two maps' queries in plain PyTorch (the kernel's twin): rows
    [0, n_a) against `grid_a`, the rest against `grid_b`, exactly the
    concatenation of two :func:`query_plain` calls."""
    _check_n_a(n_a, q_xyz.shape[0])
    a = query_plain(grid_a, q_xyz[:n_a], q_mask[:n_a], k,
                    candidates_per_cell, max_sqdist)
    b = query_plain(grid_b, q_xyz[n_a:], q_mask[n_a:], k,
                    candidates_per_cell, max_sqdist)
    return KnnResult(*(torch.cat([x, y]) for x, y in zip(a, b)))


def _check_n_a(n_a: int, n_q: int) -> None:
    if not 0 <= n_a <= n_q:
        raise ValueError(f"n_a={n_a} outside [0, {n_q}]")


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_GRID_DTYPES = (_F32, _I32, _I32, _I32, _F32)   # in HashGrid's field order
_GRID_NAMES = {label: tuple(f"{label}.{f}" for f in HashGrid._fields)
               for label in ("grid_a", "grid_b")}
_launch = None   # the kernel's C entry point, looked up at its first launch


def query_cat(grid_a: HashGrid, grid_b: HashGrid, q_xyz: Tensor,
              q_mask: Tensor, n_a: int, k: int = 5,
              candidates_per_cell: int = 16,
              max_sqdist: float = math.inf) -> KnnResult:
    """Two maps' k-NN in one pass: rows [0, n_a) of the queries against
    `grid_a`, the rest against `grid_b`; the same result as
    ``query(grid_a, q[:n_a])`` and ``query(grid_b, q[n_a:])`` concatenated.

    A CPU tensor takes the plain twin; a CUDA tensor launches the CUDA
    kernel once or raises.  The launch counts in ``query.launches``."""
    return query_cat_plain(grid_a, grid_b, q_xyz, q_mask, n_a, k,
                           candidates_per_cell, max_sqdist)


def query(grid: HashGrid, q_xyz: Tensor, q_mask: Tensor, k: int = 5,
          candidates_per_cell: int = 16,
          max_sqdist: float = math.inf) -> KnnResult:
    """k-NN within the 27-cell neighbourhood of each query point
    (msst_tpu's ``knn.query`` contract).

    A CPU tensor takes the plain twin; a CUDA tensor launches the CUDA
    kernel (msst_tpu's Pallas ``knn_pallas.query_pallas`` on the TPU) with
    one grid, or raises.  ``query.launches`` counts kernel launches, those
    of :func:`query_cat` too."""
    return query_plain(grid, q_xyz, q_mask, k, candidates_per_cell,
                       max_sqdist)


query.launches = 0


def nearest1_brute(tgt_xyz: Tensor, tgt_mask: Tensor, q_xyz: Tensor,
                   q_mask: Tensor, chunk: int = 8192) -> KnnResult:
    """Exact 1-NN by a chunked dense distance sweep (msst_tpu's
    ``knn.nearest1_brute``; the loop-closure ICP's correspondence search,
    ``pcl::KdTreeFLANN`` in ``mapOptmization.cpp:560-580``).

    Each (Q, <= chunk) block of the target is ``|q|^2 - 2 q.x + |x|^2``
    (the product a full-f32 matmul), folded into a running minimum; the
    last block is the target's remainder.  Only one block is alive at a
    time: at the loop's shapes (10240 queries) one is 335 MB.  The first
    minimum wins within a block, an earlier chunk on equal distances."""
    Q = q_xyz.shape[0]
    dev = q_xyz.device
    q_sq = torch.sum(q_xyz * q_xyz, dim=1)
    best_d2 = torch.full((Q,), torch.inf, device=dev)
    best_i = torch.zeros(Q, dtype=torch.int32, device=dev)
    rows = torch.arange(Q, device=dev)
    for b in range(0, tgt_xyz.shape[0], chunk):
        x, m = tgt_xyz[b:b + chunk], tgt_mask[b:b + chunk]
        # written in msst_tpu's order: (|q|^2 - 2 q.x) + |x|^2
        d2 = torch.mm(q_xyz, x.T).mul_(-2.0).add_(q_sq[:, None])
        d2.add_(torch.sum(x * x, dim=1)[None, :])
        d2.masked_fill_(~m[None, :], torch.inf)
        i = torch.argmin(d2, dim=1)
        d2c = d2[rows, i]
        del d2
        upd = d2c < best_d2
        best_d2 = torch.where(upd, d2c, best_d2)
        best_i = torch.where(upd, i.to(torch.int32) + b, best_i)
    d2 = torch.clamp(torch.where(q_mask, best_d2, torch.inf), min=0.0)
    return KnnResult(best_i[:, None], d2[:, None], torch.isfinite(d2)[:, None])
