"""A synthetic K-pose ring graph for timing and checking the pose-graph
solvers at production scale (the generator of bench.py's graph-scale phase,
``bench.py:125-190``, built with the port's ``se3`` and ``graph``).

The graph has the shape of the reference's ``mapOptmization`` graph
(``mapOptmization.cpp:1381-1495``): a prior on pose 0, a noisy odometry
chain around a circle with 0.2 m keyframe spacing (its last factor closes
the ring), `n_extra_loops` loop factors across the ring, and a GPS factor
every `gps_every` poses.  The initial poses are the truth plus noise.  The
same seed gives the same numbers as bench.py's generator (numpy draws them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import graph as G
from ..ops import se3


def make_ring_graph(K: int, n_extra_loops: int = 8, gps_every: int = 16,
                    seed: int = 0, device="cpu") -> G.PoseGraph:
    rng = np.random.default_rng(seed)

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    radius = K * 0.2 / (2 * np.pi)
    gt6 = np.zeros((K, 6), np.float32)
    gt6[:, 2] = ang + np.pi / 2
    gt6[:, 3] = radius * np.cos(ang)
    gt6[:, 4] = radius * np.sin(ang)
    gt = se3.Pose.from_vec6(T(gt6))
    nxt = se3.Pose(torch.roll(gt.q, -1, dims=0), torch.roll(gt.t, -1, dims=0))
    chain = gt.between(nxt)   # row i: i -> i+1; row K-1 closes the ring
    noise = np.concatenate([rng.normal(scale=2e-4, size=(K, 3)),
                            rng.normal(scale=2e-3, size=(K, 3))],
                           axis=1).astype(np.float32)
    chain = chain.compose(se3.Pose.from_vec6(T(noise)))

    nb = K + n_extra_loops
    li = rng.integers(0, K // 2, size=n_extra_loops)
    lj = (li + K // 2) % K
    lmeas = se3.Pose(gt.q[li], gt.t[li]).between(se3.Pose(gt.q[lj], gt.t[lj]))
    ng = max(K // gps_every, 1)
    gidx = np.arange(ng, dtype=np.int32) * gps_every

    init = se3.Pose.from_vec6(T(
        gt6 + np.concatenate([rng.normal(scale=0.01, size=(K, 3)),
                              rng.normal(scale=0.05, size=(K, 3))],
                             axis=1).astype(np.float32)))
    ar = np.arange(K, dtype=np.int32)
    return G.PoseGraph(
        poses=init,
        pose_mask=torch.ones(K, dtype=torch.bool, device=device),
        priors=G.PriorFactor(
            idx=T([0], torch.int32), meas=se3.Pose(gt.q[:1], gt.t[:1]),
            sqrt_info=torch.full((1, 6), 1e3, device=device),
            mask=torch.ones(1, dtype=torch.bool, device=device)),
        betweens=G.BetweenFactor(
            i=T(np.concatenate([ar, li]), torch.int32),
            j=T(np.concatenate([np.roll(ar, -1), lj]), torch.int32),
            meas=se3.Pose(torch.cat([chain.q, lmeas.q]),
                          torch.cat([chain.t, lmeas.t])),
            sqrt_info=torch.full((nb, 6), 1e2, device=device),
            mask=torch.ones(nb, dtype=torch.bool, device=device)),
        gps=G.GpsFactor(
            idx=T(gidx, torch.int32), xyz=T(gt6[gidx, 3:]),
            sqrt_info=torch.full((ng, 3), 2.0, device=device),
            mask=torch.ones(ng, dtype=torch.bool, device=device)),
    )
