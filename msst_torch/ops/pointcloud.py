"""Fixed-capacity masked point clouds (port of ``msst_tpu.ops.pointcloud``):
the container and stream compaction the LIO frontend and keyframe insert
use, and the box crop of the calibration tools."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class Cloud(NamedTuple):
    """Fixed-capacity point cloud.

    xyz:   (N, 3) float32; garbage where ~mask
    mask:  (N,)  bool — validity
    attrs: (N, A) float32 — extra per-point channels; may be zero-width.
    """

    xyz: Tensor
    mask: Tensor
    attrs: Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def count(self) -> Tensor:
        return torch.sum(self.mask.to(torch.int32))

    def with_mask(self, mask: Tensor) -> "Cloud":
        return self._replace(mask=self.mask & mask)

    @staticmethod
    def create(xyz: Tensor, mask: Optional[Tensor] = None,
               attrs: Optional[Tensor] = None) -> "Cloud":
        n = xyz.shape[0]
        if mask is None:
            mask = torch.ones((n,), dtype=torch.bool, device=xyz.device)
        if attrs is None:
            attrs = xyz.new_zeros((n, 0))
        return Cloud(xyz.to(torch.float32), mask, attrs.to(torch.float32))


def compact(cloud: Cloud, capacity: Optional[int] = None) -> Cloud:
    """Move valid points to a dense prefix (stable order); output size
    `capacity` (default: the input capacity).

    Each valid row goes to its rank among valid rows.  Rows that do not fit,
    and invalid rows, all go to one extra slot past the end that is cut off:
    that slot is the only destination written more than once, so the order
    in which a device resolves repeated writes cannot change the result."""
    n_out = capacity or cloud.capacity
    pos = torch.cumsum(cloud.mask.to(torch.int64), 0) - 1
    dest = torch.where(cloud.mask & (pos < n_out), pos, n_out)
    xyz = cloud.xyz.new_zeros((n_out + 1, 3)).index_copy_(0, dest, cloud.xyz)
    attrs = cloud.attrs.new_zeros((n_out + 1, cloud.attrs.shape[1])
                                  ).index_copy_(0, dest, cloud.attrs)
    new_mask = torch.arange(n_out, device=cloud.xyz.device) < cloud.count
    return Cloud(xyz[:n_out], new_mask, attrs[:n_out])


def crop_box(cloud: Cloud, lo, hi, keep_inside: bool = True) -> Cloud:
    """Axis-aligned box filter: keep the points inside [lo, hi] (the
    passthrough crop), or with keep_inside=False those outside it (the
    ego-box carve-out)."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=cloud.xyz.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=cloud.xyz.device)
    inside = torch.all((cloud.xyz >= lo) & (cloud.xyz <= hi), dim=-1)
    return cloud.with_mask(inside if keep_inside else ~inside)
