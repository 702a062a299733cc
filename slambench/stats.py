"""The arithmetic of the end-to-end metrics, on stamps from the host clock."""

from __future__ import annotations

import math

import numpy as np


def nearest_rank(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest
    value with at least q % of all values at or below it.  A missing value
    is inf and sorts last, so a scan that never got its pose raises the
    tail instead of leaving the sample."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.inf
    k = max(int(math.ceil(q / 100.0 * v.size)) - 1, 0)
    return float(v[k])


def latencies(due, done) -> np.ndarray:
    """Seconds from each scan's due time to its pose on the host; inf for a
    scan whose pose never came (done is None or not finite)."""
    out = np.full(len(due), np.inf)
    for i, (d, t) in enumerate(zip(due, done)):
        if t is not None and math.isfinite(t):
            out[i] = t - d
    return out


def rate(n_done: int, t0: float, t_end: float) -> float:
    """Work completed per second over the whole window."""
    return n_done / max(t_end - t0, 1e-9)
