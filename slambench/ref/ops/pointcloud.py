# Frozen copy of msst_torch/ops/pointcloud.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
"""Fixed-capacity masked point clouds (port of ``msst_tpu.ops.pointcloud``).

The reference passes dynamically sized ``pcl::PointCloud`` between nodes;
here a cloud is a fixed-capacity tensor with a validity mask.  This module
holds the container and its compaction (mask -> dense prefix), pcl's
``removeNaNFromPointCloud``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .se3 import Pose

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

    @staticmethod
    def empty(capacity: int, n_attrs: int = 0, device=None) -> "Cloud":
        return Cloud(torch.zeros((capacity, 3), device=device),
                     torch.zeros((capacity,), dtype=torch.bool, device=device),
                     torch.zeros((capacity, n_attrs), device=device))

    def transform(self, pose: Pose) -> "Cloud":
        """Rigid transform keeping the attrs (the fusion nodes' per-point
        transform keeps the XYZIRT fields, ``lidar_fusion.cpp:157-275``)."""
        return self._replace(xyz=pose.apply(self.xyz))


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
