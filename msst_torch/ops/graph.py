"""Fixed-capacity pose graph and its Gauss-Newton solves (port of
``msst_tpu.ops.graph``; the GTSAM iSAM2 backend of
``mapOptmization.cpp:1381-1581``: prior, between and GPS factors).

Residuals are whitened per factor and their 6-dof Jacobians are taken by
forward-mode autodiff of the retraction (``torch.func.jacfwd``), as
msst_tpu takes them with ``jax.jacfwd``.  Two solvers: the dense Cholesky
:func:`optimize` and the matrix-free preconditioned CG :func:`optimize_cg`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from . import se3
from .se3 import Pose

Tensor = torch.Tensor


class PriorFactor(NamedTuple):
    idx: Tensor        # (P,) int32 pose index
    meas: Pose         # (P, ...) measured pose
    sqrt_info: Tensor  # (P, 6) diagonal sqrt information (1/sigma)
    mask: Tensor       # (P,)


class BetweenFactor(NamedTuple):
    i: Tensor          # (B,)
    j: Tensor          # (B,)
    meas: Pose         # relative pose i -> j
    sqrt_info: Tensor  # (B, 6)
    mask: Tensor       # (B,)


class GpsFactor(NamedTuple):
    idx: Tensor        # (G,)
    xyz: Tensor        # (G, 3)
    sqrt_info: Tensor  # (G, 3)
    mask: Tensor       # (G,)


class PoseGraph(NamedTuple):
    poses: Pose          # (K, ...)
    pose_mask: Tensor    # (K,)
    priors: PriorFactor
    betweens: BetweenFactor
    gps: GpsFactor

    @property
    def capacity(self) -> int:
        return self.poses.t.shape[0]


def empty_graph(max_poses: int, max_priors: int, max_betweens: int,
                max_gps: int, device=None) -> PoseGraph:
    def zpose(n):
        return Pose(se3.quat_identity((n,), device),
                    torch.zeros((n, 3), device=device))

    def zi(n):
        return torch.zeros(n, dtype=torch.int32, device=device)

    def zb(n):
        return torch.zeros(n, dtype=torch.bool, device=device)

    return PoseGraph(
        poses=zpose(max_poses),
        pose_mask=zb(max_poses),
        priors=PriorFactor(zi(max_priors), zpose(max_priors),
                           torch.ones((max_priors, 6), device=device),
                           zb(max_priors)),
        betweens=BetweenFactor(zi(max_betweens), zi(max_betweens),
                               zpose(max_betweens),
                               torch.ones((max_betweens, 6), device=device),
                               zb(max_betweens)),
        gps=GpsFactor(zi(max_gps), torch.zeros((max_gps, 3), device=device),
                      torch.ones((max_gps, 3), device=device), zb(max_gps)),
    )


# ---------------------------------------------------------------------------
# residuals (gtsam-convention local coordinates) and their Jacobians
# ---------------------------------------------------------------------------


def _prior_residual(delta: Tensor, pose: Pose, meas: Pose) -> Tensor:
    """r = Log(meas^-1 * retract(pose, delta)) -> (6,) [rot, trans]."""
    d = meas.between(se3.pose_retract(pose, delta))
    return torch.cat([se3.so3_log(d.q), d.t])


def _between_residual(di: Tensor, dj: Tensor, pi: Pose, pj: Pose,
                      meas: Pose) -> Tensor:
    a = se3.pose_retract(pi, di)
    b = se3.pose_retract(pj, dj)
    d = meas.between(a.between(b))
    return torch.cat([se3.so3_log(d.q), d.t])


def _gps_residual(delta: Tensor, pose: Pose, z: Tensor) -> Tensor:
    return se3.pose_retract(pose, delta).t - z


def _take(poses: Pose, idx: Tensor) -> Pose:
    idx = idx.long()
    return Pose(poses.q[idx], poses.t[idx])


def _prior_terms(poses: Pose, f: PriorFactor):
    pi = _take(poses, f.idx)
    z = torch.zeros(6, device=f.sqrt_info.device)
    r = vmap(_prior_residual, in_dims=(None, 0, 0))(z, pi, f.meas)
    J = vmap(jacfwd(_prior_residual), in_dims=(None, 0, 0))(z, pi, f.meas)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, J * w[:, :, None]


def _between_terms(poses: Pose, f: BetweenFactor):
    pi, pj = _take(poses, f.i), _take(poses, f.j)
    z = torch.zeros(6, device=f.sqrt_info.device)
    dims = (None, None, 0, 0, 0)
    r = vmap(_between_residual, in_dims=dims)(z, z, pi, pj, f.meas)
    Ji = vmap(jacfwd(_between_residual, argnums=0), in_dims=dims)(
        z, z, pi, pj, f.meas)
    Jj = vmap(jacfwd(_between_residual, argnums=1), in_dims=dims)(
        z, z, pi, pj, f.meas)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, Ji * w[:, :, None], Jj * w[:, :, None]


def _gps_terms(poses: Pose, f: GpsFactor):
    pi = _take(poses, f.idx)
    z = torch.zeros(6, device=f.sqrt_info.device)
    r = vmap(_gps_residual, in_dims=(None, 0, 0))(z, pi, f.xyz)
    J = vmap(jacfwd(_gps_residual), in_dims=(None, 0, 0))(z, pi, f.xyz)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, J * w[:, :, None]


def _assemble_dense(graph: PoseGraph, free_mask: Tensor):
    """Dense H (6K, 6K), g (6K) from all factors; fixed poses contribute as
    constants (their Jacobian blocks are zeroed)."""
    K = graph.capacity
    dev = graph.pose_mask.device
    H = torch.zeros((6 * K, 6 * K), device=dev)
    g = torch.zeros(6 * K, device=dev)
    free = free_mask.to(torch.float32)
    ar6 = torch.arange(6, device=dev)

    def add_block(J1, J2, idx1, idx2, r):
        blk = torch.einsum("nri,nrj->nij", J1, J2)
        rows = idx1.long()[:, None] * 6 + ar6[None, :]
        cols = idx2.long()[:, None] * 6 + ar6[None, :]
        H.index_put_((rows[:, :, None].expand_as(blk),
                      cols[:, None, :].expand_as(blk)), blk, accumulate=True)
        if r is not None:
            g.index_put_((rows,), torch.einsum("nri,nr->ni", J1, r),
                         accumulate=True)

    f = graph.priors
    rp, Jp = _prior_terms(graph.poses, f)
    Jp = Jp * free[f.idx.long()][:, None, None]
    add_block(Jp, Jp, f.idx, f.idx, rp)

    b = graph.betweens
    rb, Ji, Jj = _between_terms(graph.poses, b)
    Ji = Ji * free[b.i.long()][:, None, None]
    Jj = Jj * free[b.j.long()][:, None, None]
    add_block(Ji, Ji, b.i, b.i, rb)
    add_block(Jj, Jj, b.j, b.j, rb)
    add_block(Ji, Jj, b.i, b.j, None)
    add_block(Jj, Ji, b.j, b.i, None)

    gf = graph.gps
    rg, Jg = _gps_terms(graph.poses, gf)
    Jg = Jg * free[gf.idx.long()][:, None, None]
    add_block(Jg, Jg, gf.idx, gf.idx, rg)
    return H, g


def optimize(graph: PoseGraph, free_mask: Optional[Tensor] = None,
             iters: int = 5, damping: float = 1e-6) -> PoseGraph:
    """Batched Gauss-Newton over the whole graph (dense normal equations,
    Cholesky).  free_mask: the poses that may move (default: all valid)."""
    if free_mask is None:
        free_mask = graph.pose_mask
    K = graph.capacity
    diag_mask = torch.repeat_interleave(free_mask & graph.pose_mask, 6)
    for _ in range(iters):
        H, g = _assemble_dense(graph, free_mask)
        # inactive/fixed pose blocks: identity rows keep Cholesky PD
        H = H + torch.diag(torch.where(diag_mask, damping, 1.0))
        g = g * diag_mask
        L, _ = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(-g[:, None], L)[:, 0]
        dx = (dx * diag_mask).reshape(K, 6)
        graph = graph._replace(poses=se3.pose_retract(graph.poses, dx))
    return graph


def optimize_cg(graph: PoseGraph, free_mask: Optional[Tensor] = None,
                iters: int = 5, cg_iters: int = 50,
                damping: float = 1e-4) -> PoseGraph:
    """Gauss-Newton with a matrix-free preconditioned-CG inner solve.

    The normal-equation matvec is taken factor by factor (two batched
    einsums and ``index_add_`` scatters per factor table) without forming
    H, so memory is O(K*36), not the dense solve's O(K^2*36): the solver
    for graphs beyond ``cg_threshold`` keyframes.  Block-Jacobi (6x6
    diagonal blocks) preconditioning and a fixed `cg_iters` count, so
    nothing is read back to the host.  On the card the scatters add in no
    fixed order."""
    if free_mask is None:
        free_mask = graph.pose_mask
    K = graph.capacity
    dev = graph.pose_mask.device
    pf, bf, gf = graph.priors, graph.betweens, graph.gps
    pi, bi, bj, gi = (pf.idx.long(), bf.i.long(), bf.j.long(),
                      gf.idx.long())
    free = (free_mask & graph.pose_mask).to(torch.float32)
    eye6 = torch.eye(6, device=dev)

    def scatter(idx, vals, shape):
        return torch.zeros(shape, device=dev).index_add_(0, idx, vals)

    for _ in range(iters):
        rp, Jp = _prior_terms(graph.poses, pf)
        rb, Ji, Jj = _between_terms(graph.poses, bf)
        rg, Jg = _gps_terms(graph.poses, gf)
        Jp = Jp * free[pi][:, None, None]
        Ji = Ji * free[bi][:, None, None]
        Jj = Jj * free[bj][:, None, None]
        Jg = Jg * free[gi][:, None, None]

        def matvec(x):                      # x: (K, 6)
            v = torch.einsum("nri,ni->nr", Jp, x[pi])
            y = scatter(pi, torch.einsum("nri,nr->ni", Jp, v), (K, 6))
            # betweens, cross blocks included
            v = (torch.einsum("nri,ni->nr", Ji, x[bi])
                 + torch.einsum("nri,ni->nr", Jj, x[bj]))
            y.index_add_(0, bi, torch.einsum("nri,nr->ni", Ji, v))
            y.index_add_(0, bj, torch.einsum("nri,nr->ni", Jj, v))
            v = torch.einsum("nri,ni->nr", Jg, x[gi])
            y.index_add_(0, gi, torch.einsum("nri,nr->ni", Jg, v))
            return y + damping * x

        g = scatter(pi, torch.einsum("nri,nr->ni", Jp, rp), (K, 6))
        g.index_add_(0, bi, torch.einsum("nri,nr->ni", Ji, rb))
        g.index_add_(0, bj, torch.einsum("nri,nr->ni", Jj, rb))
        g.index_add_(0, gi, torch.einsum("nri,nr->ni", Jg, rg))

        # block-Jacobi preconditioner
        D = scatter(pi, torch.einsum("nri,nrj->nij", Jp, Jp), (K, 6, 6))
        D.index_add_(0, bi, torch.einsum("nri,nrj->nij", Ji, Ji))
        D.index_add_(0, bj, torch.einsum("nri,nrj->nij", Jj, Jj))
        D.index_add_(0, gi, torch.einsum("nri,nrj->nij", Jg, Jg))
        Dinv = torch.linalg.inv(D + (damping + 1e-6) * eye6)

        def precond(x):
            return torch.einsum("nij,nj->ni", Dinv, x)

        x = torch.zeros((K, 6), device=dev)
        r = -g
        z = precond(r)
        pdir = z
        rz = torch.sum(r * z)
        for _ in range(cg_iters):
            Ap = matvec(pdir)
            alpha = rz / torch.clamp(torch.sum(pdir * Ap), min=1e-12)
            x = x + alpha * pdir
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            pdir = z + rz_new / torch.clamp(rz, min=1e-12) * pdir
            rz = rz_new
        graph = graph._replace(
            poses=se3.pose_retract(graph.poses, x * free[:, None]))
    return graph
