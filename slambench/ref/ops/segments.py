# Frozen copy of msst_torch/ops/segments.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
"""Segment reductions over rows sorted by segment id (port of
``msst_tpu.ops.segments``).

msst_tpu sums a segment as a difference of compensated prefix sums at its
boundaries.  Here each segment's rows are added one after another in row
order (``torch.segment_reduce`` over the segments' row offsets): on the
card one thread sums a segment's column, so the order of the additions is
fixed and two drives of the same input give the same bits, where a
scatter-add (``index_add_``) or a float prefix scan adds in an order that
changes from run to run.  On the CPU the sums equal those of a sequential
scatter-add bit for bit.

Callers keep msst_tpu's cell-centre demeaning: they pass positions minus
their cell centre (|r| <= leaf/2), so float32 sums keep metric precision
however far the cloud sits from the origin.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def segment_sum(vals: Tensor, seg: Tensor, num_segments: int) -> Tensor:
    """segment_sum for non-decreasing ``seg``, each segment's rows added in
    row order; rows whose id is >= num_segments are dropped (they sort to
    the end).

    vals: (N,) or (N, C).  Returns (num_segments,) or (num_segments, C)."""
    ids = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    offsets = torch.searchsorted(seg.contiguous(), ids)
    return fixed_order_sum(vals, offsets)


def fixed_order_sum(vals: Tensor, offsets: Tensor) -> Tensor:
    """(S, ...) sums of the row runs [offsets[s], offsets[s + 1]) of
    vals (N, ...), each run's rows added in row order from 0 (an empty run
    sums to 0); rows past offsets[-1] are not read.  One thread of the card
    sums one run's column, which fixes the order of its additions."""
    v = vals[:, None] if vals.ndim == 1 else vals
    # unsafe: no validity check of the offsets, which would read them back
    # to the host; callers make them non-decreasing within [0, N]
    out = torch.segment_reduce(v, "sum", offsets=offsets, axis=0,
                               initial=0.0, unsafe=True)
    return out[:, 0] if vals.ndim == 1 else out


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
