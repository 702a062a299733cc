"""Deterministic centroid voxel-grid downsampling (port of
``msst_tpu.ops.voxel.voxel_downsample`` and ``voxel_downsample_packed``),
replacing the reference's ``pcl::VoxelGrid`` calls
(``featureExtraction.cpp:232-236``, ``mapOptmization.cpp:899-967``)."""

from __future__ import annotations

from typing import Optional

import torch

from . import segments
from .numeric import div, mul_i32
from .pointcloud import Cloud

Tensor = torch.Tensor

_INVALID = 2**31 - 1
_PACKED_INVALID = 2**30   # sentinel key of voxel_downsample_packed


def voxel_coords(xyz: Tensor, leaf: float) -> Tensor:
    """Integer voxel cell (..., 3) of each point: floor(xyz / leaf), the
    division IEEE on every device."""
    return torch.floor(div(xyz, leaf)).to(torch.int32)


def _stable_order(*keys: Tensor) -> Tensor:
    """Permutation sorting rows lexicographically by ``keys`` (primary first),
    stable in the input order like ``lax.sort``: one stable sort per key,
    least significant first."""
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def voxel_downsample(
    cloud: Cloud,
    leaf: float,
    capacity: Optional[int] = None,
    extra_key: Optional[Tensor] = None,
    uniform_overflow: bool = True,
) -> Cloud:
    """Centroid voxel filter, msst_tpu's semantics exactly:

    * extra_key: optional (N,) int appended to the voxel key (the ring id,
      for the reference's per-ring surface downsample), 7 bits, clamped to
      [0, 127].
    * the key packs (extra, cx, cy) into one int32 with cx/cy clamped to
      +-1024 cells around the FIRST valid point's cell; cz rides a second key.
    * uniform_overflow: order voxels by a spatial hash of their world cell
      first, so overflow beyond `capacity` thins the cloud evenly; False
      orders by the packed key (overflow drops the highest keys).
    * positions are summed demeaned by their cell centre and clipped to half
      a leaf, so float32 sums keep metric precision.
    """
    n = cloud.capacity
    n_out = capacity or n
    dev = cloud.xyz.device
    c = torch.floor(div(cloud.xyz, leaf)).to(torch.int32)
    invalid = ~cloud.mask
    origin_cell = c[torch.argmax(cloud.mask.to(torch.uint8))]
    c = c - origin_cell
    cxy = torch.clamp(c[:, :2], -1024, 1023)
    if extra_key is not None:
        extra = torch.clamp(extra_key.to(torch.int32), 0, 127)
    else:
        extra = torch.zeros((), dtype=torch.int32, device=dev)
    hi = (extra << 22) | ((cxy[:, 0] + 1024) << 11) | (cxy[:, 1] + 1024)
    hi = torch.where(invalid, _INVALID, hi)
    lo = c[:, 2]
    if uniform_overflow:
        # hash of the absolute (clamp-then-restored) cell, so the thinning
        # does not depend on which point happened to be first valid
        ha = cxy[:, 0] + origin_cell[0]
        hb = cxy[:, 1] + origin_cell[1]
        hc = lo + origin_cell[2]
        h = (mul_i32(ha, 73856093) ^ mul_i32(hb, 19349663)
             ^ mul_i32(hc, 83492791))
        h = torch.where(invalid, _INVALID, h)
        order = _stable_order(h, hi, lo)
    else:
        order = _stable_order(hi, lo)
    cell = torch.cat([cxy, c[:, 2:3]], dim=1) + origin_cell
    center = (cell.to(cloud.xyz.dtype) + 0.5) * leaf
    r = torch.clamp(cloud.xyz - center, -0.5 * leaf, 0.5 * leaf)

    hi_s, lo_s = hi[order], lo[order]
    r_sorted = r[order]
    attrs_s = cloud.attrs[order]
    valid_s = hi_s != _INVALID
    new_voxel = (hi_s != torch.roll(hi_s, 1)) | (lo_s != torch.roll(lo_s, 1))
    new_voxel[0] = True
    new_voxel = new_voxel & valid_s
    seg = torch.cumsum(new_voxel.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, n_out)

    cell_s = torch.stack([((hi_s >> 11) & 2047) - 1024,
                          (hi_s & 2047) - 1024, lo_s], dim=1) + origin_cell
    w = valid_s.to(r_sorted.dtype)[:, None]
    vals = segments.segment_sum(
        torch.cat([r_sorted * w, attrs_s * w, w], dim=1), seg, n_out)
    rsums, asums, counts = vals[:, :3], vals[:, 3:-1], vals[:, -1]
    cell_v, _ = segments.segment_first(cell_s, seg, n_out)
    center_v = (cell_v.to(r_sorted.dtype) + 0.5) * leaf

    denom = torch.clamp(counts, min=1.0)[:, None]
    n_voxels = torch.sum(new_voxel.to(torch.int32))
    mask_out = torch.arange(n_out, device=dev) < torch.clamp(n_voxels, max=n_out)
    return Cloud(center_v + rsums / denom, mask_out, asums / denom)


def voxel_downsample_packed(
    cloud: Cloud,
    leaf: float,
    origin: Tensor,
    capacity: Optional[int] = None,
    half_extent_cells: int = 512,
) -> Cloud:
    """Centroid voxel filter with one packed int32 sort key, msst_tpu's
    semantics exactly:

    * the key packs the cell of each point around `origin`, 10 bits an axis;
      points farther than ``half_extent_cells`` cells from it are dropped;
      dropped and masked rows carry the sentinel 2**30 and sort last.
    * output rows are the voxels in ascending key order (the order of the
      map cloud that ``knn.build`` indexes);
      ``mask = arange < min(n_voxels, capacity)``, so overflow drops the
      highest keys.
    * positions are summed demeaned by their cell centre, so float32 sums
      keep metric precision however far the cloud sits from the origin.
    * a row past the last voxel holds the centre decoded from the first
      unused sorted key and zero attrs, as in msst_tpu (masked either way).
    """
    n = cloud.capacity
    n_out = capacity or n
    he = half_extent_cells
    dev = cloud.xyz.device
    origin = origin.to(cloud.xyz.dtype)
    c = torch.floor(div(cloud.xyz - origin, leaf)).to(torch.int32) + he
    ok = cloud.mask & torch.all((c >= 0) & (c < 2 * he), dim=1)
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    key = torch.where(ok, key, _PACKED_INVALID)
    order = torch.argsort(key, stable=True)
    key_s, xyz_s, attrs_s = key[order], cloud.xyz[order], cloud.attrs[order]
    valid_s = key_s < _PACKED_INVALID

    new_voxel = key_s != torch.roll(key_s, 1)
    new_voxel[0] = True
    new_voxel = new_voxel & valid_s
    seg = torch.cumsum(new_voxel.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, seg, n_out)

    def decode_center(k):
        cxyz = torch.stack([(k >> 20) & 1023, (k >> 10) & 1023, k & 1023],
                           dim=-1)
        return origin + (cxyz.to(xyz_s.dtype) - he + 0.5) * leaf

    w = valid_s.to(xyz_s.dtype)[:, None]
    r_s = (xyz_s - decode_center(key_s)) * w
    vals = segments.segment_sum(torch.cat([r_s, attrs_s * w, w], dim=1), seg,
                                n_out)
    rsums, asums, counts = vals[:, :3], vals[:, 3:-1], vals[:, -1]
    lo, _ = segments.segment_boundaries(seg, n_out)
    center_v = decode_center(key_s[torch.clamp(lo, max=n - 1)])
    denom = torch.clamp(counts, min=1.0)[:, None]
    n_voxels = torch.sum(new_voxel.to(torch.int32))
    mask_out = torch.arange(n_out, device=dev) < torch.clamp(n_voxels, max=n_out)
    return Cloud(center_v + rsums / denom, mask_out, asums / denom)
