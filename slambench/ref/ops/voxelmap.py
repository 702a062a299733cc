# Frozen copy of msst_torch/ops/voxelmap.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
# Changed: lookup_cat always takes the plain twin.
"""Voxel feature maps: per-voxel line/plane Gaussians with hashed probe rows
(port of ``msst_tpu.ops.voxelmap``).

The local map is summarized once per keyframe into per-voxel statistics
(mean, principal direction, plane offset, quality gates), and each
scan-to-map Gauss-Newton iteration only looks up the voxel holding each
transformed feature point and its 7 octant neighbours.  That lookup is the
hot op of the odometry step; on a CUDA tensor it runs as the hand-written
kernel ``msst_torch/csrc/voxel_lookup.cu`` (:func:`lookup_cat`), on a CPU
tensor as its plain PyTorch twin (:func:`lookup_cat_plain`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import linalg, segments
from .numeric import hash3 as _hash3
from .voxel import _stable_order

Tensor = torch.Tensor

_BIG = 2**30

# Thin surf cells reclassified as LINE features ship their direction scaled
# by LINE_DIR_SCALE; consumers detect them via |direction| < LINE_DIR_GATE.
LINE_DIR_SCALE = 0.5
LINE_DIR_GATE = 0.75

PROBE_C = 3  # candidate slots per hash bucket (table_size >= 2 * capacity)

_COMBOS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
           (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))


class VoxelFeatureMap(NamedTuple):
    """Fixed-capacity voxel-Gaussian table + hash buckets.

    `probe` is the lookup's only gathered table: one row per hash bucket,
    holding its PROBE_C candidates embedded as
    [coord-key(int32 bits), mean(3), dir(3), d] x PROBE_C (24 floats, 96 B).
    `stats` keeps msst_tpu's per-voxel layout (its Pallas kernel's input)."""

    coords: Tensor        # (V, 3) int32 voxel coords (garbage where ~mask)
    mean: Tensor          # (V, 3)
    direction: Tensor     # (V, 3) plane normal (planes) or line direction
    d: Tensor             # (V,) plane offset (planes; 0 for lines)
    count: Tensor         # (V,) member points
    valid: Tensor         # (V,) bool — passes the geometric quality gates
    mask: Tensor          # (V,) bool — slot occupied
    stats: Tensor         # (V, 12) [key(bits), mean3, dir3, d, valid, cnt, 0, 0]
    probe: Tensor         # (H, PROBE_C*8) bucket-aligned embedded rows
    bucket_start: Tensor  # (H,)
    bucket_count: Tensor  # (H,)
    leaf: Tensor          # () float32
    origin: Tensor        # (3,) key-packing origin (zeros when absolute)

    @property
    def capacity(self) -> int:
        return self.mean.shape[0]

    @property
    def table_size(self) -> int:
        return self.bucket_start.shape[0]


def _coord_key(c: Tensor) -> Tensor:
    """Pack voxel coords into one int32 (10/10/10 bits around a +-512-cell
    domain); out-of-domain coords give the sentinel 2**30."""
    shifted = c + 512
    ok = torch.all((shifted >= 0) & (shifted < 1024), dim=-1)
    key = (shifted[..., 0] << 20) | (shifted[..., 1] << 10) | shifted[..., 2]
    return torch.where(ok, key, _BIG)


def _pack_rel(rel: Tensor, group_bits: int = 0) -> Tensor:
    """Pack +512-shifted cell coords (each in [0, 1024)) into one int32 sort
    key.  group_bits = k > 0 is the HIERARCHICAL packing (coarse cell
    ``rel >> k`` in the high bits), whose sorted rows are grouped by coarse
    cell so :func:`build` can run ``presorted``."""
    if group_bits == 0:
        return (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
    k = group_bits
    b = 10 - k
    km = (1 << k) - 1
    hi = rel >> k
    lo = rel & km
    coarse = (((hi[..., 0] << b) | hi[..., 1]) << b) | hi[..., 2]
    sub = (((lo[..., 0] << k) | lo[..., 1]) << k) | lo[..., 2]
    return (coarse << (3 * k)) | sub


def _unpack_rel(key: Tensor, group_bits: int = 0) -> Tensor:
    """Inverse of :func:`_pack_rel` (valid keys only)."""
    if group_bits == 0:
        return torch.stack([(key >> 20) & 1023, (key >> 10) & 1023,
                            key & 1023], dim=-1)
    k = group_bits
    b = 10 - k
    bm = (1 << b) - 1
    km = (1 << k) - 1
    coarse = key >> (3 * k)
    sub = key & ((1 << (3 * k)) - 1)
    hi = torch.stack([(coarse >> (2 * b)) & bm, (coarse >> b) & bm,
                      coarse & bm], dim=-1)
    lo = torch.stack([(sub >> (2 * k)) & km, (sub >> k) & km, sub & km],
                     dim=-1)
    return (hi << k) | lo


def _sorted_by(key: Tensor, *vals: Tensor):
    """(key, *vals) permuted by a stable sort of key — ``lax.sort`` with
    num_keys=1."""
    order = torch.argsort(key, stable=True)
    return (key[order],) + tuple(v[order] for v in vals)


def _new_runs(key_s: Tensor, valid_s: Tensor) -> Tensor:
    """Rows that start a new run of equal sorted keys (and are valid)."""
    new = key_s != torch.roll(key_s, 1, dims=0)
    if new.ndim > 1:
        new = torch.any(new, dim=1)
    new[0] = True
    return new & valid_s


def build(xyz: Tensor, mask: Tensor, leaf: float, capacity: int,
          kind: str, *, origin: Optional[Tensor] = None,
          table_size: int = 8192, min_points: int = 3,
          line_ratio: float = 3.0, plane_thickness: float = 0.1,
          plane_min_spread: float = 0.0, plane_spread_min_count=0.0,
          weights: Optional[Tensor] = None,
          presorted: bool = False) -> VoxelFeatureMap:
    """Voxelize + fit per-voxel features (msst_tpu's ``build``).

    kind: "plane" (surf map) or "line" (corner map).  origin: anchor of the
    +-512-cell packed key domain (points outside are dropped); None puts
    the grid at the world origin with unbounded cells, grouped by a
    lexicographic sort of (x, y, z).  plane_thickness: max sqrt(lambda_min)
    of a valid plane.  plane_min_spread > 0: thin cells with
    sqrt(lambda_mid) below it become LINE features (direction scaled by
    LINE_DIR_SCALE, d = 0), unless they hold fewer than
    `plane_spread_min_count` true points (a float or a tensor); `weights`
    (N,) gives each row's true point count where rows are fine-cell
    centroids (default 1).  presorted: (origin grid only) rows are already
    grouped by this grid's cells (hierarchical moment keys), so no sort."""
    dev = xyz.device
    leaf_f = torch.tensor(leaf, dtype=torch.float32, device=dev)
    origin_f = (torch.zeros(3, device=dev) if origin is None
                else origin.to(torch.float32))
    c = torch.floor((xyz - origin_f) / leaf_f).to(torch.int32)
    wts = (torch.ones(xyz.shape[0], device=dev) if weights is None
           else weights.to(xyz.dtype))
    if origin is not None:
        rel = c + 512
        mask = mask & torch.all((rel >= 0) & (rel < 1024), dim=1)
        key = torch.where(mask, _pack_rel(rel), _BIG)
        key_s, xyz_s, wts_s = ((key, xyz, wts) if presorted
                               else _sorted_by(key, xyz, wts))
        valid_s = key_s < _BIG
        cs = torch.where(valid_s[:, None], _unpack_rel(key_s) - 512, _BIG)
    else:
        k = [torch.where(mask, c[:, i], _BIG) for i in range(3)]
        order = _stable_order(*k)
        cs = torch.stack(k, dim=1)[order]
        valid_s, xyz_s, wts_s = mask[order], xyz[order], wts[order]

    new_voxel = _new_runs(cs, valid_s)
    seg = torch.cumsum(new_voxel.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, capacity)

    # moments about each point's CELL CENTRE: residuals <= leaf/2 keep
    # float32 sums at metric precision; 6 unique second-moment entries
    w = valid_s.to(xyz.dtype)
    center_s = origin_f + (cs.to(xyz.dtype) + 0.5) * leaf_f
    r_s = (xyz_s - center_s) * w[:, None]
    iu, ju = [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]
    outer6 = r_s[:, iu] * r_s[:, ju]
    moments = segments.segment_sum(
        torch.cat([r_s, outer6, w[:, None], (w * wts_s)[:, None]], dim=1),
        seg, capacity)
    rsums, sq6, cnt = moments[:, :3], moments[:, 3:9], moments[:, 9]
    cnt_pts = moments[:, 10]   # true point support (= cnt without weights)
    coords_v, seg_occ = segments.segment_first(cs, seg, capacity)
    coords_v = torch.where(seg_occ[:, None], coords_v, -_BIG)
    center_v = origin_f + (coords_v.to(xyz.dtype) + 0.5) * leaf_f

    denom = torch.clamp(cnt, min=1.0)
    rmu = rsums / denom[:, None]
    mu = center_v + rmu
    sq = sq6[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(capacity, 3, 3)
    cov = sq / denom[:, None, None] - rmu[:, :, None] * rmu[:, None, :]
    vals, vecs = linalg.sym3x3_eigh(cov)

    n_vox = torch.sum(new_voxel.to(torch.int32))
    occupied = torch.arange(capacity, device=dev) < torch.clamp(n_vox, max=capacity)

    def _unit(v):
        # the analytic eigenvectors drift from unit norm on near-degenerate
        # spectra; LINE_DIR_SCALE and the plane residual need unit vectors
        return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                               min=1e-12)

    if kind == "plane":
        direction = _unit(vecs[:, 0, :])   # smallest eigvec = normal
        d = -torch.sum(direction * mu, dim=1)
        quality_ok = torch.sqrt(torch.clamp(vals[:, 0], min=0.0)) <= plane_thickness
        if plane_min_spread > 0.0:
            spread_ok = (torch.sqrt(torch.clamp(vals[:, 1], min=0.0))
                         >= plane_min_spread)
            to_line = quality_ok & ~spread_ok & (
                cnt_pts >= plane_spread_min_count)
            direction = torch.where(to_line[:, None],
                                    _unit(vecs[:, 2, :]) * LINE_DIR_SCALE,
                                    direction)
            d = torch.where(to_line, 0.0, d)
    else:
        direction = _unit(vecs[:, 2, :])   # largest eigvec = line direction
        d = torch.zeros(capacity, device=dev)
        quality_ok = vals[:, 2] > line_ratio * torch.clamp(vals[:, 1], min=1e-12)

    valid = occupied & (cnt >= min_points) & quality_ok

    # bucket table over voxel coords, rows stably sorted by hash
    h = torch.where(occupied, _hash3(coords_v, table_size), table_size)
    h_sorted, coords_p, mean_p, dir_p, d_p, cnt_p, valid_p, mask_p = _sorted_by(
        h, coords_v, mu, direction, d, cnt, valid, occupied)
    ids = torch.arange(table_size, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(h_sorted, ids)
    ends = torch.searchsorted(h_sorted, ids, right=True)

    key_c = _coord_key(coords_p)
    stats = torch.cat([
        key_c.view(torch.float32)[:, None], mean_p, dir_p, d_p[:, None],
        valid_p.to(torch.float32)[:, None], cnt_p[:, None],
        torch.zeros((capacity, 2), device=dev),
    ], dim=1)
    # bucket-aligned embedded probe rows: candidate c of bucket b at flat row
    # b*PROBE_C + c; validity folds into the key (invalid -> sentinel).
    # Overflowing and unoccupied rows all go to one extra row that is cut
    # off: the only repeated destination, so write order cannot matter.
    probe_key = torch.where(valid_p, key_c, _BIG)
    emb = torch.cat([probe_key.view(torch.float32)[:, None], mean_p, dir_p,
                     d_p[:, None]], dim=1)
    pos = torch.arange(capacity, device=dev)
    is_new = h_sorted != torch.roll(h_sorted, 1)
    is_new[0] = True
    run_start = torch.cummax(torch.where(is_new, pos, 0), dim=0).values
    rank = pos - run_start
    in_table = mask_p & (h_sorted < table_size) & (rank < PROBE_C)
    dest = torch.where(in_table, h_sorted.to(torch.int64) * PROBE_C + rank,
                       table_size * PROBE_C)
    init = torch.zeros((table_size * PROBE_C + 1, 8), device=dev)
    init[:, 0] = torch.tensor(_BIG, dtype=torch.int32).view(torch.float32)
    probe = init.index_copy_(0, dest, emb)[:table_size * PROBE_C].reshape(
        table_size, PROBE_C * 8)

    return VoxelFeatureMap(
        coords=coords_p, mean=mean_p, direction=dir_p, d=d_p, count=cnt_p,
        valid=valid_p, mask=mask_p, stats=stats, probe=probe,
        bucket_start=starts.to(torch.int32),
        bucket_count=(ends - starts).to(torch.int32),
        leaf=leaf_f, origin=origin_f)


# ---------------------------------------------------------------------------
# Incremental moment tables (delta insert)
# ---------------------------------------------------------------------------


class VoxelMoments(NamedTuple):
    """Persistent per-voxel first-moment table (the reference's
    transformed-cloud cache, ``mapOptmization.cpp:899-938``): rows sorted by
    packed cell key (sentinel 2**30 = empty), positions summed demeaned by
    the cell centre."""

    key: Tensor   # (V,) int32 packed origin-relative cell key, sorted
    rsum: Tensor  # (V, 3) sum of (xyz - cell_center) over member points
    cnt: Tensor   # (V,) member count (exact in f32 up to 2^24)

    @property
    def capacity(self) -> int:
        return self.key.shape[0]


def empty_moments(capacity: int, device=None) -> VoxelMoments:
    return VoxelMoments(
        key=torch.full((capacity,), _BIG, dtype=torch.int32, device=device),
        rsum=torch.zeros((capacity, 3), device=device),
        cnt=torch.zeros((capacity,), device=device))


def _decode_center(key: Tensor, leaf, origin: Tensor,
                   group_bits: int = 0) -> Tensor:
    """Cell centres from packed keys (inverse of the +512-shifted packing)."""
    c = _unpack_rel(key, group_bits)
    return origin + (c.to(torch.float32) - 512 + 0.5) * leaf


def points_to_moments(xyz: Tensor, mask: Tensor, leaf: float,
                      origin: Tensor, capacity: int, group_bits: int = 0,
                      return_stats: bool = False):
    """Summarize a point cloud into sorted per-cell centroid moments on
    :func:`build`'s origin grid.  return_stats also returns the count of
    occupied cells that did not fit the capacity (the highest keys drop)."""
    dev = xyz.device
    leaf_f = torch.tensor(leaf, dtype=torch.float32, device=dev)
    origin_f = origin.to(torch.float32)
    rel = torch.floor((xyz - origin_f) / leaf_f).to(torch.int32) + 512
    ok = mask & torch.all((rel >= 0) & (rel < 1024), dim=1)
    key = torch.where(ok, _pack_rel(rel, group_bits), _BIG)
    key_s, xyz_s = _sorted_by(key, xyz)
    valid_s = key_s < _BIG
    new_cell = _new_runs(key_s, valid_s)
    seg = torch.cumsum(new_cell.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, capacity)
    w = valid_s.to(torch.float32)
    r_s = (xyz_s - _decode_center(key_s, leaf_f, origin_f, group_bits)) \
        * w[:, None]
    sums = segments.segment_sum(torch.cat([r_s, w[:, None]], dim=1), seg,
                                capacity)
    key_v, occupied = segments.segment_first(key_s, seg, capacity)
    out = VoxelMoments(
        key=torch.where(occupied, key_v, _BIG),
        rsum=torch.where(occupied[:, None], sums[:, :3], 0.0),
        cnt=torch.where(occupied, sums[:, 3], 0.0))
    if return_stats:
        n_cells = torch.sum(new_cell.to(torch.int32))
        return out, torch.clamp(n_cells - capacity, min=0)
    return out


def scale_moments(m: VoxelMoments, s) -> VoxelMoments:
    """s = -1 turns a contribution into its eviction delta."""
    return m._replace(rsum=m.rsum * s, cnt=m.cnt * s)


def merge_moments(a: VoxelMoments, b: VoxelMoments, capacity: int,
                  min_cnt: float = 0.5,
                  trim_center: Optional[Tensor] = None,
                  trim_radius: Optional[float] = None,
                  leaf: Optional[float] = None,
                  origin: Optional[Tensor] = None, group_bits: int = 0,
                  method: str = "sort", return_stats: bool = False):
    """Merge two sorted moment tables: equal keys sum;
    cells below `min_cnt` die (an eviction's ``scale_moments(m, -1)``
    cancels counts exactly); with `trim_center`, cells farther than
    `trim_radius` from it die too (the reference's surrounding-keyframe
    radius, ``extractNearby`` :862-897, at cell granularity; `leaf` and
    `origin` decode the cell centres).  Survivors stay in key order; beyond
    `capacity` the highest keys drop, and `dropped` counts them.

    method: how the merged order is formed, "sort" (one stable sort of
    both tables) or "rank" (each b key's rank in a by a binary search, a
    filling the free slots in order); both give the same table.
    return_stats=True also returns `dropped`; without it the merged table
    comes alone.  The signature and defaults are msst_tpu's."""
    na, nb = a.key.shape[0], b.key.shape[0]
    n_tot = na + nb
    dev = a.key.device
    avals = torch.cat([a.rsum, a.cnt[:, None]], dim=1)
    bvals = torch.cat([b.rsum, b.cnt[:, None]], dim=1)
    if method == "sort":
        key_s, vals_s = _sorted_by(torch.cat([a.key, b.key]),
                                   torch.cat([avals, bvals]))
    elif method == "rank":
        # b_j goes after the equal a keys; a_i fills the free slots in order
        pos_b = (torch.arange(nb, device=dev)
                 + torch.searchsorted(a.key, b.key, right=True))
        free = torch.ones(n_tot, dtype=torch.bool, device=dev).index_fill_(
            0, pos_b, False)
        rank = torch.cumsum(free.to(torch.int64), 0) - 1
        slot = torch.where(free, rank, na)
        pos_a = torch.zeros(na + 1, dtype=torch.int64, device=dev).index_copy_(
            0, slot, torch.arange(n_tot, device=dev))[:na]
        key_s = torch.empty(n_tot, dtype=a.key.dtype, device=dev)
        key_s[pos_a], key_s[pos_b] = a.key, b.key
        vals_s = avals.new_empty((n_tot, 4))
        vals_s[pos_a], vals_s[pos_b] = avals, bvals
    else:
        raise ValueError(f"method {method!r}: 'sort' or 'rank'")
    valid_s = key_s < _BIG
    new_cell = _new_runs(key_s, valid_s)
    seg = torch.cumsum(new_cell.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, n_tot)
    sums = segments.segment_sum(vals_s, seg, n_tot)
    key_v, occupied = segments.segment_first(key_s, seg, n_tot)
    alive = occupied & (sums[:, 3] >= min_cnt)
    if trim_center is not None:
        center = _decode_center(
            key_v, torch.tensor(leaf, dtype=torch.float32, device=dev),
            origin.to(torch.float32), group_bits)
        d2 = torch.sum((center - trim_center) ** 2, dim=1)
        r2 = torch.tensor(trim_radius, dtype=torch.float32, device=dev) ** 2
        alive = alive & (d2 <= r2)
    rank = torch.cumsum(alive.to(torch.int64), 0) - 1
    # rows that do not survive or do not fit all go to one cut-off slot
    dest = torch.where(alive & (rank < capacity), rank, capacity)
    out_key = torch.full((capacity + 1,), _BIG, dtype=torch.int32, device=dev
                         ).index_copy_(0, dest, torch.where(alive, key_v, _BIG))
    out_vals = sums.new_zeros((capacity + 1, 4)).index_copy_(
        0, dest, torch.where(alive[:, None], sums, 0.0))
    out = VoxelMoments(key=out_key[:capacity], rsum=out_vals[:capacity, :3],
                       cnt=out_vals[:capacity, 3])
    if not return_stats:
        return out
    n_alive = torch.sum(alive.to(torch.int32))
    return out, torch.clamp(n_alive - capacity, min=0)


def moments_centroids(m: VoxelMoments, leaf: float, origin: Tensor,
                      group_bits: int = 0, return_counts: bool = False):
    """(xyz, mask[, cnt]): one centroid pseudo-point per occupied cell — the
    input of the coarse feature fit, identical to the reference's
    centroid-downsampled local map.  return_counts adds each centroid's
    true point count (the fit's `weights`)."""
    mask = m.key < _BIG
    leaf_f = torch.tensor(leaf, dtype=torch.float32, device=m.key.device)
    center = _decode_center(m.key, leaf_f, origin.to(torch.float32),
                            group_bits)
    xyz = center + m.rsum / torch.clamp(m.cnt, min=1.0)[:, None]
    xyz = torch.where(mask[:, None], xyz, 0.0)
    if return_counts:
        return xyz, mask, torch.where(mask, m.cnt, 0.0)
    return xyz, mask


# ---------------------------------------------------------------------------
# The lookup: CUDA kernel on CUDA tensors, plain twin on CPU tensors
# ---------------------------------------------------------------------------


class VoxelLookup(NamedTuple):
    idx: Tensor        # (Q,) int32 winning candidate (octant*PROBE_C + lane)
    found: Tensor      # (Q,) bool
    mean: Tensor       # (Q, 3) matched voxel mean
    direction: Tensor  # (Q, 3) matched plane normal / line direction
    d: Tensor          # (Q,) matched plane offset


def octant_cells(q_xyz: Tensor, leaf: Tensor, origin: Tensor) -> Tensor:
    """(Q, 8, 3) int32: the cell holding each query and its 7 octant
    neighbours toward the query's offset in the cell, in msst_tpu's combo
    order."""
    g = (q_xyz - origin) / leaf
    base = torch.floor(g).to(torch.int32)
    step = torch.where(g - base.to(torch.float32) >= 0.5, 1, -1).to(torch.int32)
    combos = torch.tensor(_COMBOS, dtype=torch.int32, device=q_xyz.device)
    return base[:, None, :] + combos[None] * step[:, None, :]


def lookup_cat_plain(vmap_a: VoxelFeatureMap, vmap_b: VoxelFeatureMap,
                     q_xyz: Tensor, q_mask: Tensor, n_a: int) -> VoxelLookup:
    """The lookup in plain PyTorch (the kernel's twin).

    Query rows [0, n_a) probe ``vmap_a``, the rest ``vmap_b``.  Each query
    hashes the cell holding it and the 7 octant neighbours toward its
    in-cell offset, reads the 3 candidates of each bucket row, keeps those
    whose packed coord key matches, and returns the one whose mean is
    nearest — the first minimum in (octant, lane) order.  With no match,
    idx = 0 and the stats are candidate 0's row, as in msst_tpu."""
    C = PROBE_C
    Qn = q_xyz.shape[0]
    dev = q_xyz.device
    is_a = torch.arange(Qn, device=dev) < n_a
    leaf = torch.where(is_a, vmap_a.leaf, vmap_b.leaf)
    origin = torch.where(is_a[:, None], vmap_a.origin, vmap_b.origin)
    cells = octant_cells(q_xyz, leaf[:, None], origin)          # (Q, 8, 3)

    hb = torch.where(is_a[:, None], _hash3(cells, vmap_a.table_size),
                     _hash3(cells, vmap_b.table_size) + vmap_a.table_size)
    probe_cat = torch.cat([vmap_a.probe, vmap_b.probe])
    rows = probe_cat[hb.long()].reshape(Qn, 8, C, 8)
    keys = rows[..., 0].contiguous().view(torch.int32)
    expect = _coord_key(cells)
    expect = torch.where(expect == _BIG, -1, expect)
    match = keys == expect[..., None]
    diff = rows[..., 1:4] - q_xyz[:, None, None, :]
    # written out in the kernel's order: (dx*dx + dy*dy) + dz*dz
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    d2 = torch.where(match & q_mask[:, None, None], d2, torch.inf)
    d2f = d2.reshape(Qn, 8 * C)
    best = torch.argmin(d2f, dim=1)
    ar = torch.arange(Qn, device=dev)
    win = rows.reshape(Qn, 8 * C, 8)[ar, best]
    found = torch.isfinite(d2f[ar, best])
    return VoxelLookup(idx=best.to(torch.int32), found=found,
                       mean=win[:, 1:4], direction=win[:, 4:7], d=win[:, 7])


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_LOOKUP_NAMES = ("q_xyz", "q_mask", "probe_a", "probe_b", "leaf_a",
                 "origin_a", "leaf_b", "origin_b")
_LOOKUP_DTYPES = (_F32, _BOOL) + (_F32,) * 6
_launch = None   # the kernel's C entry point, looked up at its first launch


def lookup_cat(vmap_a: VoxelFeatureMap, vmap_b: VoxelFeatureMap,
               q_xyz: Tensor, q_mask: Tensor, n_a: int) -> VoxelLookup:
    """Both maps' lookup in one pass (msst_tpu's ``lookup_cat`` contract).

    A CPU tensor takes the plain twin; a CUDA tensor launches the CUDA
    kernel (msst_tpu's Pallas ``voxelmap_pallas.lookup_pallas`` on the TPU)
    or raises.  ``lookup_cat.launches`` counts kernel launches."""
    return lookup_cat_plain(vmap_a, vmap_b, q_xyz, q_mask, n_a)


lookup_cat.launches = 0
