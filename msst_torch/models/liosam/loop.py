"""Loop closure, the pipeline's second, lower-rate program (port of
``msst_tpu.models.liosam.loop``; the reference's loop-closure thread,
``mapOptmization.cpp:503-608,1477-1495``): find an old (> 30 s) keyframe
near the newest one, register the newest keyframe against a +-N-keyframe
submap around it, and on fitness < 0.3 add a between factor and re-solve
the whole graph.

As in msst_tpu:

* COARSE: point-to-point brute ICP on clouds downsampled at
  ``loop_coarse_factor`` x the loop leaf (the reference's 30 m basin at a
  fraction of the sweep cost).
* FINE (``loop_fine="plane"``): per-class line/plane Gauss-Newton against
  voxel feature maps of the history submap at 4x, 2x and 1x the leaf
  (``registration.scan_to_map_voxel``, so the voxel lookup kernel runs
  here too); ``"p2p"`` is a tight point-to-point second pass.
* The acceptance gate is the reference's point-to-point fitness
  (``getFitnessScore``) on the full-density merged clouds; the loop
  factor's information is scaled per axis by the ICP cost's curvature
  (``loop_degeneracy_ratio``).

msst_tpu runs the attempt as one device program with ``lax.cond`` and
``while_loop`` branches; here the branches are Python ``if``s on flags read
back from the device (which candidates are eligible, whether one closed).
The keyframe store's float32 rows (poses, corner and surf clouds) are
gathered with ``ops.gather.gather_rows``, the row-gather kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import gather, knn, registration, se3, voxel, voxelmap
from ...ops.pointcloud import Cloud
from . import mapping
from .params import LioParams
from .state import KeyframeStore, LioState

Tensor = torch.Tensor


class LoopResult(NamedTuple):
    found: Tensor      # () bool: a loop factor was added
    cur: Tensor        # () int32 current keyframe index
    cand: Tensor       # () int32 last candidate tried (the match where found)
    fitness: Tensor    # () ICP fitness
    icp_iters: Tensor  # () int32 coarse ICP iterations of the last try
    # () int32 candidates registered against (the port's own field:
    # msst_tpu's LoopResult has no such leaf, so it stays None when one is
    # carried across by ``convert.from_numpy``)
    tried: Tensor | None = None


def _submap_caps(p: LioParams) -> tuple[int, int]:
    """(corner, surf) capacities of the per-class history submap (corners
    are ~1/5 of the feature mass)."""
    return max(p.loop_submap_cap // 4, p.kf_corner_cap), p.loop_submap_cap


def _coarse_caps(p: LioParams) -> tuple[int, int]:
    """(cur, hist) capacities of the coarse-stage clouds: the full-density
    budgets over loop_coarse_factor**2, since a coarser leaf cuts occupied
    cells ~4-8x per doubling."""
    cc, sc = _submap_caps(p)
    div = max(p.loop_coarse_factor, 1) ** 2
    return (max((p.kf_corner_cap + p.kf_surf_cap) // div, 256),
            max((cc + sc) // div, 1024))


def _rows(table: Tensor, idx: Tensor) -> Tensor:
    """Rows `idx` (N,) of a keyframe-store table (K, ...) float32, through
    the row-gather kernel on a (K, prod(...)) view."""
    flat = gather.gather_rows(table.reshape(table.shape[0], -1),
                              idx.to(torch.int32))
    return flat.reshape((idx.shape[0],) + table.shape[1:])


def _masks(mask: Tensor, idx: Tensor) -> Tensor:
    return mask.index_select(0, idx.long())


def _kf_class_clouds(state: LioState, idx: Tensor, p: LioParams
                     ) -> tuple[Cloud, Cloud]:
    """Keyframe `idx`'s corner and surf clouds in the map frame, each
    voxel-downsampled at single-keyframe capacity (``loopFindNearKeyframes``
    with searchNum=0, :699-721)."""
    kf = state.kf
    i1 = idx.reshape(1)
    pose = se3.Pose.from_vec6(_rows(kf.pose6, i1)[0])
    corner = voxel.voxel_downsample(
        Cloud.create(pose.apply(_rows(kf.corner_xyz, i1)[0]),
                     mask=_masks(kf.corner_mask, i1)[0]),
        p.loop_leaf_size, capacity=p.kf_corner_cap)
    surf = voxel.voxel_downsample(
        Cloud.create(pose.apply(_rows(kf.surf_xyz, i1)[0]),
                     mask=_masks(kf.surf_mask, i1)[0]),
        p.loop_leaf_size, capacity=p.kf_surf_cap)
    return corner, surf


def _submap_class_clouds(state: LioState, center: Tensor, p: LioParams
                         ) -> tuple[Cloud, Cloud]:
    """History submap of keyframes [center-N, center+N] in the map frame,
    per class, voxel-downsampled (``loopFindNearKeyframes`` :699-721)."""
    kf = state.kf
    K = kf.pose6.shape[0]
    n = p.history_keyframe_search_num
    idx = center + torch.arange(-n, n + 1, dtype=torch.int32,
                                device=center.device)
    ok = (idx >= 0) & (idx < kf.count)
    idx = torch.clamp(idx, 0, K - 1)
    poses = se3.Pose.from_vec6(_rows(kf.pose6, idx))
    cc, sc = _submap_caps(p)

    def build(xyz, mask, cap):
        world = poses.apply(_rows(xyz, idx))
        m = (_masks(mask, idx) & ok[:, None]).reshape(-1)
        return voxel.voxel_downsample(
            Cloud.create(world.reshape(-1, 3), mask=m),
            p.loop_leaf_size, capacity=cap)

    return (build(kf.corner_xyz, kf.corner_mask, cc),
            build(kf.surf_xyz, kf.surf_mask, sc))


def _merge(a: Cloud, b: Cloud) -> tuple[Tensor, Tensor]:
    return torch.cat([a.xyz, b.xyz]), torch.cat([a.mask, b.mask])


def _coarsen(xyz: Tensor, mask: Tensor, p: LioParams, cap: int) -> Cloud:
    return voxel.voxel_downsample(
        Cloud.create(xyz, mask=mask),
        max(p.loop_coarse_factor, 1) * p.loop_leaf_size, capacity=cap)


def _p2p_fitness(src_xyz, src_mask, tgt_xyz, tgt_mask, pose: se3.Pose,
                 max_dist: float) -> Tensor:
    """Mean squared NN distance of matched points at `pose`: PCL
    ``getFitnessScore`` on the full-density clouds, the reference's
    acceptance quantity (``performLoopClosure`` :575-580)."""
    res = knn.nearest1_brute(tgt_xyz, tgt_mask, pose.apply(src_xyz), src_mask)
    ok = res.valid[:, 0] & src_mask & (res.sqdist[:, 0] <= max_dist * max_dist)
    nm = torch.clamp(torch.sum(ok.to(torch.int32)), min=1)
    return torch.sum(torch.where(ok, res.sqdist[:, 0], 0.0)) / nm


def _loop_candidates(kf: KeyframeStore, p: LioParams):
    """``detectLoopClosureDistance`` (:610-643), extended to the
    ``loop_candidates`` nearest eligible keyframes: (cur, cands (n,) int32
    nearest first, cands_ok (n,) bool).  Equal distances go to the lower
    slot, as in XLA's top_k."""
    K = kf.pose6.shape[0]
    cur = torch.clamp(kf.count - 1, min=0)
    cur_pos = _rows(kf.pose6, cur.reshape(1))[0, 3:]
    cur_time = kf.time.index_select(0, cur.reshape(1).long())[0]
    d2 = torch.sum((kf.positions - cur_pos) ** 2, dim=1)
    old = (cur_time - kf.time) > p.history_keyframe_search_time_diff
    d2 = torch.where(kf.mask & old, d2, torch.inf)
    n_cand = min(max(p.loop_candidates, 1), K)
    d2s, order = torch.sort(d2, stable=True)
    cands_ok = (kf.count > 1) & (
        d2s[:n_cand] < p.history_keyframe_search_radius ** 2)
    return cur, order[:n_cand].to(torch.int32), cands_ok


def _put(x: Tensor, idx: Tensor, val) -> Tensor:
    """A copy of x with row idx (a 0-d device tensor) = val."""
    val = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    return x.clone().index_put_((idx.reshape(1).long(),),
                                val.reshape((1,) + x.shape[1:]))


def loop_closure_step(state: LioState, p: LioParams
                      ) -> tuple[LioState, LoopResult]:
    """Detect and close one loop; returns (new_state, LoopResult).  The
    state given is not written: a closed loop returns a new one.

    The eligible candidates are tried nearest first until one passes the
    fitness gate; the attempt's clouds are built only when one is
    eligible."""
    kf = state.kf
    dev = kf.pose6.device
    cur, cands, cands_ok = _loop_candidates(kf, p)
    eligible = cands_ok.tolist()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    inf = torch.full((), torch.inf, device=dev)
    if not any(eligible):
        return state, LoopResult(torch.zeros((), dtype=torch.bool, device=dev),
                                 cur, zero, inf, zero, zero)

    cur_c, cur_s = _kf_class_clouds(state, cur, p)
    cur_xyz, cur_mask = _merge(cur_c, cur_s)
    cap_cur, cap_hist = _coarse_caps(p)
    cur_coarse = _coarsen(cur_xyz, cur_mask, p, cap_cur)
    corr = p.history_keyframe_search_radius * 2.0

    good = False
    tried = 0
    for i, ok in enumerate(eligible):
        cand = cands[i]
        if not ok:
            pose, fit, iters = se3.Pose.identity(device=dev), inf, zero
            continue
        tried += 1
        hist_c, hist_s = _submap_class_clouds(state, cand, p)
        hist_xyz, hist_mask = _merge(hist_c, hist_s)
        hist_coarse = _coarsen(hist_xyz, hist_mask, p, cap_hist)
        # COARSE: the reference's wide basin (setMaxCorrespondenceDistance
        # (radius*2) :560, the epsilons of :562-563) on the coarse clouds
        res = registration.icp_point2point_brute(
            cur_coarse.xyz, cur_coarse.mask, hist_coarse.xyz,
            hist_coarse.mask, se3.Pose.identity(device=dev), max_iters=100,
            max_corr_dist=corr, transformation_eps=1e-6, rel_mse_eps=1e-6)
        pose, iters = res.pose, res.iters
        fit = _p2p_fitness(cur_xyz, cur_mask, hist_xyz, hist_mask, pose, corr)
        if p.loop_fine == "plane":
            origin = _rows(kf.pose6, cand.reshape(1))[0, 3:]

            def gn(pose6, leaf_mul, n_iters):
                cvox = voxelmap.build(
                    hist_c.xyz, hist_c.mask, leaf_mul * p.vox_corner_leaf,
                    p.vox_corner_cap, "line",
                    table_size=2 * p.vox_corner_cap, origin=origin)
                svox = voxelmap.build(
                    hist_s.xyz, hist_s.mask, leaf_mul * p.vox_surf_leaf,
                    p.vox_surf_cap, "plane",
                    table_size=2 * p.vox_surf_cap, origin=origin,
                    plane_min_spread=p.vox_plane_min_spread)
                return registration.scan_to_map_voxel(
                    cur_c.xyz, cur_c.mask, cur_s.xyz, cur_s.mask, cvox, svox,
                    pose6, max_iters=n_iters,
                    eig_threshold=p.degeneracy_threshold).pose

            # three leaf rungs: the 4x pass's ~3 m reach re-captures salient
            # structure the coarse p2p stage left biased along a corridor
            fine = se3.Pose.from_vec6(
                gn(gn(gn(pose.to_vec6(), 4.0, 8), 2.0, 8), 1.0, 12))
            fine_fit = _p2p_fitness(cur_xyz, cur_mask, hist_xyz, hist_mask,
                                    fine, corr)
            # a guard, not a preference: point-to-plane may slide along
            # planes, which p2p fitness mildly penalizes
            use = torch.isfinite(fine_fit) & (fine_fit < 2.0 * fit)
            pose = se3.Pose(torch.where(use, fine.q, pose.q),
                            torch.where(use, fine.t, pose.t))
            fit = torch.where(use, fine_fit, fit)
        elif p.loop_fine == "p2p" and p.loop_icp_refine_dist > 0.0:
            res2 = registration.icp_point2point_brute(
                cur_xyz, cur_mask, hist_xyz, hist_mask, pose, max_iters=50,
                max_corr_dist=p.loop_icp_refine_dist,
                transformation_eps=1e-6, rel_mse_eps=1e-6)
            use = res2.converged & (res2.fitness <= fit)
            pose = se3.Pose(torch.where(use, res2.pose.q, pose.q),
                            torch.where(use, res2.pose.t, pose.t))
            fit = torch.where(use, res2.fitness, fit)
        good = bool(res.converged & (fit < p.history_keyframe_fitness_score))
        if good:
            state = _add_loop(state, p, cur, cand, pose, fit, cur_coarse,
                              hist_coarse)
            break
    return state, LoopResult(torch.tensor(good, device=dev), cur, cand, fit,
                             iters, torch.tensor(tried, dtype=torch.int32,
                                                 device=dev))


def _add_loop(state: LioState, p: LioParams, cur: Tensor, cand: Tensor,
              icp_pose: se3.Pose, fitness: Tensor, cur_coarse: Cloud,
              hist_coarse: Cloud) -> LioState:
    """The loop factor cur -> cand, the full-graph re-solve (the reference's
    extra iSAM passes after a loop, :1540-1548) and the local map rebuilt
    from the rewritten history (``correctPoses`` :1583-1614)."""
    kf, graph = state.kf, state.graph
    K = kf.pose6.shape[0]
    pair = _rows(kf.pose6, torch.stack([cur, cand]))
    t_cur, t_cand = se3.Pose.from_vec6(pair[0]), se3.Pose.from_vec6(pair[1])
    # ``performLoopClosure`` :575-604: poseFrom = icp * current, poseTo =
    # candidate
    corrected = icp_pose.compose(t_cur)
    meas = t_cand.between(corrected).inverse()
    si = torch.ones(6, device=cur.device) / torch.clamp(fitness, min=1e-2)
    if p.loop_degeneracy_ratio > 0.0:
        # anisotropic information (DEVIATION from the fitness-only gate of
        # :575-580): an axis along which the match slides freely (a
        # corridor revisit) keeps ~no weight, the others keep theirs
        kappa, _ = registration.icp_curvature_brute(
            cur_coarse.xyz, cur_coarse.mask, hist_coarse.xyz,
            hist_coarse.mask, icp_pose,
            max_corr_dist=p.history_keyframe_search_radius * 2.0)

        def axis_w(k3):
            s = k3 / torch.clamp(torch.max(k3), min=1e-12)
            return torch.clamp(s / p.loop_degeneracy_ratio, 0.02, 1.0)

        # world-frame diagonal curvature -> the factor's local axes
        Rw = se3.quat_to_matrix(corrected.q)

        def to_local(w3):
            return torch.clamp(torch.diagonal(Rw.T @ torch.diag(w3) @ Rw),
                               0.02, 1.0)

        si = si * torch.cat([
            to_local(axis_w(torch.clamp(kappa[:3], min=0.0))),
            to_local(axis_w(torch.clamp(kappa[3:], min=0.0)))])
    b = graph.betweens
    slot = torch.clamp(K - 1 + state.n_loop, max=b.i.shape[0] - 1)
    graph = graph._replace(betweens=b._replace(
        i=_put(b.i, slot, cur), j=_put(b.j, slot, cand),
        meas=se3.Pose(_put(b.meas.q, slot, meas.q),
                      _put(b.meas.t, slot, meas.t)),
        sqrt_info=_put(b.sqrt_info, slot, si),
        mask=_put(b.mask, slot, True)))
    # the full-graph re-solve; dense or CG by capacity
    graph = mapping._graph_optimize(graph, p, iters=7)
    opt6 = se3.Pose(graph.poses.q, graph.poses.t).to_vec6()
    kf = kf._replace(pose6=torch.where(kf.mask[:, None], opt6, kf.pose6))
    cur_pose6 = _rows(kf.pose6, cur.reshape(1))[0]
    cur_time = kf.time.index_select(0, cur.reshape(1).long())[0]
    # the history moved, so the cached local map is stale
    if p.scan2map_method == "voxel":
        local_map, baked_pose6, baked = mapping._rebake_local_map(
            kf, cur_pose6[3:], cur_time, p)
        kf = kf._replace(baked_pose6=baked_pose6, baked=baked)
    else:
        local_map = mapping._rebuild_local_map(kf, cur_pose6[3:], cur_time, p)
    return state._replace(
        kf=kf, graph=graph, n_loop=state.n_loop + 1, local_map=local_map,
        pose6=cur_pose6,
        loop_closed=torch.ones((), dtype=torch.bool, device=cur.device))
