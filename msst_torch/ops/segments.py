"""Segment reductions over rows sorted by segment id (port of
``msst_tpu.ops.segments``).

msst_tpu sums segments as differences of prefix sums because scatters are
slow on its device; here a scatter-add (``index_add_``) does it directly,
and the row range of each segment comes from two binary searches.
Callers keep msst_tpu's cell-centre demeaning: they pass positions minus
their cell centre (|r| <= leaf/2), so float32 sums keep metric precision
however far the cloud sits from the origin.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def segment_sum(vals: Tensor, seg: Tensor, num_segments: int) -> Tensor:
    """segment_sum; rows whose id is >= num_segments are dropped.

    vals: (N,) or (N, C).  Returns (num_segments,) or (num_segments, C)."""
    ids = torch.clamp(seg, max=num_segments).long()
    out = vals.new_zeros((num_segments + 1,) + tuple(vals.shape[1:]))
    out.index_add_(0, ids, vals)
    return out[:num_segments]


def segment_first(vals: Tensor, seg: Tensor, num_segments: int
                  ) -> tuple[Tensor, Tensor]:
    """(first row of each segment, occupied (num_segments,) bool).

    Rows must be sorted by segment id; ids >= num_segments are dropped.
    Empty segments return row 0 — mask them with ``occupied``."""
    n = seg.shape[0]
    ids = torch.clamp(seg, max=num_segments).long()
    pos = torch.arange(n, device=seg.device)
    first = torch.full((num_segments + 1,), n, dtype=torch.long,
                       device=seg.device)
    first.scatter_reduce_(0, ids, pos, reduce="amin")
    first = first[:num_segments]
    occupied = first < n
    return vals[torch.where(occupied, first, 0)], occupied


def segment_boundaries(seg: Tensor, num_segments: int) -> tuple[Tensor, Tensor]:
    """(lo, hi) row ranges per segment id, as msst_tpu's.

    ``seg`` must be non-decreasing and non-negative (gaps allowed: an empty
    id gets lo == hi, the end of the last occupied id before it); rows to
    exclude carry an id >= num_segments, sorted to the end."""
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    seg = seg.contiguous()
    return (torch.searchsorted(seg, ids, right=False),
            torch.searchsorted(seg, ids, right=True))
