"""Fixed-capacity pose graph and its Gauss-Newton solves (port of
``msst_tpu.ops.graph``; the GTSAM iSAM2 backend of
``mapOptmization.cpp:1381-1581``: prior, between and GPS factors).

Residuals are whitened per factor.  Their 6-dof Jacobians are closed-form
blocks written over each factor table as a batch (msst_tpu takes them by
``jax.jacfwd`` of the retraction); the tests hold them to a
``torch.func.jacfwd`` twin and to msst_tpu's ``jax.jacfwd``.  Two solvers:
the dense Cholesky :func:`optimize` and the matrix-free preconditioned CG
:func:`optimize_cg`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import profiling
from . import segments, se3
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
#
# Each table's residuals are taken at its linearisation point a =
# retract(pose, 0), batched over its rows, and its Jacobians are closed-form
# blocks in the right perturbation of se3.pose_retract: rows [rotation,
# translation], columns [dw, dv].  With D = meas^-1 (a^-1 b),
# phi = Log(D.q), R_ab = R_a^T R_b and u = R_a^T (t_b - t_a):
#
#   between, i:  [[-Jr^-1(phi) R_ab^T, 0], [R_m^T [u]x, -R_m^T]]
#   between, j:  [[ Jr^-1(phi),        0], [0,           R_m^T R_ab]]
#   prior:       [[ Jr^-1(phi),        0], [0,           R_m^T R_a]]
#   GPS:         [0, R_a]


def _at(poses: Pose, idx: Tensor) -> Pose:
    """Rows idx of the poses at retract(pose, 0): the quaternion
    normalised.  The retraction by zero multiplies by the quaternion
    (1, 0, 0, 0) and adds a rotated zero, which leave every value as it is,
    so this is its result value for value, in 10 launches for its 77."""
    idx = idx.long()
    return Pose(se3.quat_normalize(poses.q[idx]), poses.t[idx])


def _blocks(rw: Tensor, rv: Tensor, tw: Tensor, tv: Tensor) -> Tensor:
    """(N, 6, 6) [[rw, rv], [tw, tv]] from four (N, 3, 3) blocks."""
    return torch.cat([torch.cat([rw, rv], -1), torch.cat([tw, tv], -1)], -2)


def _prior_terms(poses: Pose, f: PriorFactor):
    """Whitened r = Log(meas^-1 * a) (P, 6) and its Jacobian (P, 6, 6)."""
    d = f.meas.between(_at(poses, f.idx))
    r = se3.pose_log(d)
    jr = se3.so3_right_jacobian_inv(r[:, :3])
    o = torch.zeros_like(jr)
    J = _blocks(jr, o, o, se3.quat_to_matrix(d.q))
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, J * w[:, :, None]


def _between_terms(poses: Pose, f: BetweenFactor):
    """Whitened r = Log(meas^-1 * a^-1 * b) (B, 6) and its Jacobians in
    pose i and pose j (B, 6, 6) each."""
    ab = _at(poses, f.i).between(_at(poses, f.j))
    d = f.meas.between(ab)
    r = se3.pose_log(d)
    jr = se3.so3_right_jacobian_inv(r[:, :3])
    o = torch.zeros_like(jr)
    n = ab.q.shape[0]
    rot = se3.quat_to_matrix(torch.cat([ab.q, f.meas.q]))
    r_ab, r_mt = rot[:n], rot[n:].transpose(-1, -2)
    Ji = _blocks(-(jr @ r_ab.transpose(-1, -2)), o,
                 r_mt @ se3.skew(ab.t), -r_mt)
    Jj = _blocks(jr, o, o, r_mt @ r_ab)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, Ji * w[:, :, None], Jj * w[:, :, None]


def _gps_terms(poses: Pose, f: GpsFactor):
    """Whitened r = t_a - xyz (G, 3) and its Jacobian (G, 3, 6)."""
    a = _at(poses, f.idx)
    r = a.t - f.xyz
    r_a = se3.quat_to_matrix(a.q)
    J = torch.cat([torch.zeros_like(r_a), r_a], -1)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, J * w[:, :, None]


def _fixed_scatter(idx: Tensor, n: int):
    """A function summing rows vals (N, ...) into n slots by idx (N,): each
    slot's rows are added in their input order, as a sequential scatter-add
    adds them, and in that order on the card too (where ``index_add_``
    adds in no fixed order).  The stable sort of idx is made once, for all
    the calls of a solve."""
    order = torch.argsort(idx.long(), stable=True)
    slots = torch.arange(n + 1, device=idx.device)
    offsets = torch.searchsorted(idx.long()[order].contiguous(), slots)

    def scatter(vals: Tensor) -> Tensor:
        return segments.fixed_order_sum(vals[order], offsets)

    return scatter


def _dense_scatters(graph: PoseGraph):
    """The fixed-order scatters of the dense normal equations: the 6x6
    blocks into the K x K block grid of H (prior, between ii, jj, ij, ji,
    GPS), and the 6-vectors into the K slots of g (prior, between i, j,
    GPS)."""
    K = graph.capacity
    f, b, gf = graph.priors, graph.betweens, graph.gps
    i1 = torch.cat([f.idx, b.i, b.j, b.i, b.j, gf.idx]).long()
    i2 = torch.cat([f.idx, b.i, b.j, b.j, b.i, gf.idx]).long()
    return (_fixed_scatter(i1 * K + i2, K * K),
            _fixed_scatter(torch.cat([f.idx, b.i, b.j, gf.idx]), K))


def _assemble_dense(graph: PoseGraph, free_mask: Tensor, scatters):
    """Dense H (6K, 6K), g (6K) from all factors; fixed poses contribute as
    constants (their Jacobian blocks are zeroed).  `scatters`:
    :func:`_dense_scatters` of the graph's factor indices."""
    K = graph.capacity
    free = free_mask.to(torch.float32)
    blocks, rows = scatters

    def blk(J1, J2):
        return torch.einsum("nri,nrj->nij", J1, J2)

    def vec(J, r):
        return torch.einsum("nri,nr->ni", J, r)

    f, b, gf = graph.priors, graph.betweens, graph.gps
    rp, Jp = _prior_terms(graph.poses, f)
    Jp = Jp * free[f.idx.long()][:, None, None]
    rb, Ji, Jj = _between_terms(graph.poses, b)
    Ji = Ji * free[b.i.long()][:, None, None]
    Jj = Jj * free[b.j.long()][:, None, None]
    rg, Jg = _gps_terms(graph.poses, gf)
    Jg = Jg * free[gf.idx.long()][:, None, None]
    H = blocks(torch.cat([blk(Jp, Jp), blk(Ji, Ji), blk(Jj, Jj), blk(Ji, Jj),
                          blk(Jj, Ji), blk(Jg, Jg)]))
    H = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    g = rows(torch.cat([vec(Jp, rp), vec(Ji, rb), vec(Jj, rb), vec(Jg, rg)]))
    return H, g.reshape(6 * K)


def optimize(graph: PoseGraph, free_mask: Optional[Tensor] = None,
             iters: int = 5, damping: float = 1e-6) -> PoseGraph:
    """Batched Gauss-Newton over the whole graph (dense normal equations,
    Cholesky).  free_mask: the poses that may move (default: all valid)."""
    if free_mask is None:
        free_mask = graph.pose_mask
    K = graph.capacity
    with profiling.span("graph_solve", solver="dense", poses=K, iters=iters):
        profiling.count("graph_solves")
        diag_mask = torch.repeat_interleave(free_mask & graph.pose_mask, 6)
        scatters = _dense_scatters(graph)
        for _ in range(iters):
            profiling.count("graph_gn_iters")
            H, g = _assemble_dense(graph, free_mask, scatters)
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
    einsums per factor table and one fixed-order scatter of all their
    6-vectors onto the poses) without forming H, so memory is O(K*36), not
    the dense solve's O(K^2*36): the solver for graphs beyond
    ``cg_threshold`` keyframes.  Block-Jacobi (6x6 diagonal blocks)
    preconditioning and a fixed `cg_iters` count, so nothing is read back
    to the host."""
    if free_mask is None:
        free_mask = graph.pose_mask
    K = graph.capacity
    with profiling.span("graph_solve", solver="cg", poses=K, iters=iters):
        profiling.count("graph_solves")
        dev = graph.pose_mask.device
        pf, bf, gf = graph.priors, graph.betweens, graph.gps
        pi, bi, bj, gi = (pf.idx.long(), bf.i.long(), bf.j.long(),
                          gf.idx.long())
        free = (free_mask & graph.pose_mask).to(torch.float32)
        eye6 = torch.eye(6, device=dev)
        # the terms of a pose add in the order prior, between i, between j, GPS
        to_pose = _fixed_scatter(torch.cat([pi, bi, bj, gi]), K)

        def scatter(*terms):
            return to_pose(torch.cat(terms))

        for _ in range(iters):
            profiling.count("graph_gn_iters")
            rp, Jp = _prior_terms(graph.poses, pf)
            rb, Ji, Jj = _between_terms(graph.poses, bf)
            rg, Jg = _gps_terms(graph.poses, gf)
            Jp = Jp * free[pi][:, None, None]
            Ji = Ji * free[bi][:, None, None]
            Jj = Jj * free[bj][:, None, None]
            Jg = Jg * free[gi][:, None, None]

            def matvec(x):                      # x: (K, 6)
                vp = torch.einsum("nri,ni->nr", Jp, x[pi])
                # betweens, cross blocks included
                vb = (torch.einsum("nri,ni->nr", Ji, x[bi])
                      + torch.einsum("nri,ni->nr", Jj, x[bj]))
                vg = torch.einsum("nri,ni->nr", Jg, x[gi])
                return scatter(torch.einsum("nri,nr->ni", Jp, vp),
                               torch.einsum("nri,nr->ni", Ji, vb),
                               torch.einsum("nri,nr->ni", Jj, vb),
                               torch.einsum("nri,nr->ni", Jg, vg)
                               ) + damping * x

            g = scatter(torch.einsum("nri,nr->ni", Jp, rp),
                        torch.einsum("nri,nr->ni", Ji, rb),
                        torch.einsum("nri,nr->ni", Jj, rb),
                        torch.einsum("nri,nr->ni", Jg, rg))

            # block-Jacobi preconditioner
            D = scatter(torch.einsum("nri,nrj->nij", Jp, Jp),
                        torch.einsum("nri,nrj->nij", Ji, Ji),
                        torch.einsum("nri,nrj->nij", Jj, Jj),
                        torch.einsum("nri,nrj->nij", Jg, Jg))
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


def total_error(graph: PoseGraph) -> Tensor:
    """Sum of the squared whitened residuals of every factor (gtsam's
    ``graph.error()`` analogue)."""
    rp, _ = _prior_terms(graph.poses, graph.priors)
    rb, _, _ = _between_terms(graph.poses, graph.betweens)
    rg, _ = _gps_terms(graph.poses, graph.gps)
    return torch.sum(rp * rp) + torch.sum(rb * rb) + torch.sum(rg * rg)
