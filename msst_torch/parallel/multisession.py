"""Multi-session mapping on one card (port of
``msst_tpu.parallel.multisession``).

A fleet of robots, or parallel replays of several bags, builds one map:
each session runs its own LIO estimator, sessions share keyframes
(:func:`cooperative_map_merge`, :func:`cooperative_map_merge_selective`)
and remove their frame disagreement by rendezvous ICP and an anchor graph
(:func:`cross_session_align`).

msst_tpu runs this as a ``shard_map`` over a device mesh.  On one GPU the
sessions are a batch dimension: a batched ``LioState`` has a leading axis
of ``S * b`` rows in msst_tpu's slot-major order (flat row ``slot * b +
row``; each of the ``b`` rows is its own S-session fleet), and each
collective is a tensor op on that axis reshaped to ``(S, b, ...)``:

* ``all_gather``: the reshaped tensor itself;
* ``ppermute`` ring hop ``s``: ``recv[i] = chunk[(i - s) mod S]``, a
  ``torch.roll`` by ``s`` on the slot axis;
* ``psum``: a sum; ``axis_index`` / ``axis_size``: the slot and ``S``.

msst_tpu's ``vmap`` of the odometry step selects per element under
``lax.cond`` and keeps each finished element's carry under
``while_loop``, so each session gets its own step: the port's step reads
its branch flags on the host, so :func:`batched_odometry_step` steps the
sessions one after another and stacks their results.  ``lax.top_k``'s tie
order (the lower index first) is kept by stable argsorts.  The keyframe
store's float32 rows that the align picks and the selective merge ships
go through ``ops.gather.gather_rows``, the row-gather kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.liosam import mapping
from ..models.liosam.frontend import ScanInput
from ..models.liosam.mapping import (StepInput, _rebake_local_map,
                                     _rebuild_local_map, _use_incremental)
from ..models.liosam.params import LioParams, tiny_params
from ..models.liosam.state import KeyframeStore, LioState, init_state
from ..ops import gather, graph as graph_ops, registration, se3, voxel
from ..ops.pointcloud import Cloud
from .mesh import Mesh, _tree_map, card, shard_batch

Tensor = torch.Tensor


def _row(tree, i: int):
    return _tree_map(lambda x: x[i], tree)


def _stack(trees):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _rows(table: Tensor, idx: Tensor) -> Tensor:
    """Rows `idx` (N,) of a float32 table (R, ...), through the row-gather
    kernel on an (R, prod(...)) view."""
    flat = gather.gather_rows(table.reshape(table.shape[0], -1),
                              idx.to(torch.int32))
    return flat.reshape((idx.shape[0],) + table.shape[1:])


def _slots(B: int, mesh: Mesh) -> int:
    if B % mesh.size:
        raise ValueError(f"batch {B} is not a multiple of the mesh's "
                         f"{mesh.size} slots")
    return B // mesh.size


def make_batched_state(p: LioParams, batch: int, device=None) -> LioState:
    """`batch` copies of ``init_state(p)`` on a leading axis, on the card
    unless the caller passes ``device="cpu"``."""
    s = init_state(p, card("cuda" if device is None else device))
    return _tree_map(
        lambda x: x.unsqueeze(0).expand((batch,) + x.shape).contiguous(), s)


def batched_odometry_step(states: LioState, inputs: StepInput, p: LioParams,
                          mesh: Mesh, axis: str = "session"):
    """Every session's odometry step -> (new_states, outputs, fleet_stats):
    fleet_stats are the fleet's reductions (msst_tpu's ``psum``s), kept on
    the device.  The sessions step one after another (each reads its own
    branch flags) and their states and outputs are stacked."""
    _slots(states.pose6.shape[0], mesh)
    steps = [mapping.odometry_step(_row(states, i), _row(inputs, i), p)
             for i in range(states.pose6.shape[0])]
    new_states = _stack([s for s, _ in steps])
    outs = _stack([o for _, o in steps])
    stats = {
        "total_keyframes": torch.sum(outs.kf_count),
        "degenerate_sessions": torch.sum(outs.degenerate.to(torch.int32)),
        "mean_speed": torch.mean(torch.linalg.norm(outs.velocity, dim=-1)),
    }
    return new_states, outs, stats


def cooperative_map_merge(states: LioState, scan_time: Tensor, p: LioParams,
                          mesh: Mesh, axis: str = "session") -> LioState:
    """Collaborative mapping: every session rebuilds its cached local map
    from the FLEET's keyframes (all ``S * b`` stores), not just its own.

    The fleet's store is the batched store flattened (msst_tpu's
    ``all_gather``); its clouds are views of the state's, not copies.
    Invalid slots are parked at 1e9 m and time -1e9 with their cloud masks
    cleared, so neither the radius nor the 10 s recency gate of the
    nearby-keyframe selection takes them."""
    kf = states.kf
    B, K = kf.pose6.shape[:2]
    _slots(B, mesh)
    valid = (torch.arange(K, device=kf.count.device)[None, :]
             < kf.count[:, None])                              # (B, K)
    fvalid = valid.reshape(-1)
    fleet = KeyframeStore(
        pose6=torch.where(fvalid[:, None], kf.pose6.reshape(B * K, 6), 1e9),
        time=torch.where(fvalid, kf.time.reshape(-1), -1e9),
        corner_xyz=kf.corner_xyz.reshape((B * K,) + kf.corner_xyz.shape[2:]),
        corner_mask=(kf.corner_mask & valid[..., None]).reshape(B * K, -1),
        surf_xyz=kf.surf_xyz.reshape((B * K,) + kf.surf_xyz.shape[2:]),
        surf_mask=(kf.surf_mask & valid[..., None]).reshape(B * K, -1),
        count=torch.tensor(B * K, dtype=torch.int32, device=kf.count.device),
        baked_pose6=kf.baked_pose6.reshape(B * K, 6),
        baked=(kf.baked & valid).reshape(-1),
    )
    local = [_rebuild_local_map(fleet, states.pose6[f, 3:], scan_time[f], p)
             for f in range(B)]
    return states._replace(local_map=_stack(local))


def _newest_keyframes(kf: KeyframeStore):
    """Each session's newest keyframe: (pose6 (B, 6), corner xyz and mask,
    surf xyz and mask); an empty store's clouds are masked out.  The rows
    come through the row-gather kernel."""
    B, K = kf.pose6.shape[:2]
    dev = kf.count.device
    newest = torch.clamp(kf.count - 1, min=0).to(torch.int64)
    flat = torch.arange(B, device=dev) * K + newest
    some = (kf.count > 0)[:, None]
    return (_rows(kf.pose6.reshape(B * K, 6), flat),
            _rows(kf.corner_xyz.reshape((B * K,) + kf.corner_xyz.shape[2:]),
                  flat),
            kf.corner_mask.reshape(B * K, -1)[flat] & some,
            _rows(kf.surf_xyz.reshape((B * K,) + kf.surf_xyz.shape[2:]), flat),
            kf.surf_mask.reshape(B * K, -1)[flat] & some)


def _own_submap(kf: KeyframeStore, f: int, my6: Tensor, p: LioParams):
    """Session f's own keyframes near its newest pose in its map frame,
    downsampled into the loop cap (loop.py's submap role)."""
    K = kf.pose6.shape[1]
    r2 = p.history_keyframe_search_radius ** 2
    sel_d2 = torch.sum((kf.pose6[f, :, 3:] - my6[3:]) ** 2, dim=-1)
    near = (sel_d2 < r2) & (torch.arange(K, device=my6.device) < kf.count[f])
    poses = se3.Pose.from_vec6(kf.pose6[f])
    sub_xyz = torch.cat([poses.apply(kf.corner_xyz[f]).reshape(-1, 3),
                         poses.apply(kf.surf_xyz[f]).reshape(-1, 3)])
    sub_mask = torch.cat([(kf.corner_mask[f] & near[:, None]).reshape(-1),
                          (kf.surf_mask[f] & near[:, None]).reshape(-1)])
    return voxel.voxel_downsample(Cloud.create(sub_xyz, mask=sub_mask),
                                  p.loop_leaf_size,
                                  capacity=p.loop_submap_cap)


def _solve_anchors(good, cand, fit, q, t, S: int, k: int):
    """One row's S-node anchor graph -> each slot's anchor pose (S,).
    Session 0 is the datum (prior 1e3), the others carry weak identity
    priors (1e-1); each verified rendezvous is a between factor with
    sigma = max(fitness, 1e-2)."""
    dev = fit.device
    F = S * k
    g = graph_ops.empty_graph(max_poses=S, max_priors=S, max_betweens=F,
                              max_gps=1, device=dev)
    slots = torch.arange(S, dtype=torch.int32, device=dev)
    si = torch.where(slots[:, None] == 0, 1e3, 1e-1).expand(S, 6)
    pr = g.priors._replace(idx=slots, sqrt_info=si.to(torch.float32),
                           mask=torch.ones(S, dtype=torch.bool, device=dev))
    fi = torch.repeat_interleave(slots, k)
    fj = cand.reshape(F).to(torch.int32)
    sigma = torch.clamp(fit.reshape(F), min=1e-2)
    bw = g.betweens._replace(
        i=fi, j=fj, meas=graph_ops.Pose(q.reshape(F, 4), t.reshape(F, 3)),
        sqrt_info=(1.0 / sigma[:, None]).expand(F, 6),
        mask=good.reshape(F) & (fj != fi))
    g = g._replace(pose_mask=torch.ones(S, dtype=torch.bool, device=dev),
                   priors=pr, betweens=bw)
    return graph_ops.optimize(g, iters=8).poses


def cross_session_align(states: LioState, p: LioParams, mesh: Mesh,
                        axis: str = "session", n_cand: int = 2):
    """Inter-session loop closure + anchor-graph alignment.

    Each session takes the fleet's NEWEST keyframes (cloud + pose, one a
    session), picks its ``k = max(1, min(n_cand, S - 1))`` nearest other
    sessions of its row, verifies each by point-to-point ICP of that
    session's newest keyframe against its own submap, and turns each
    verified match into a between factor on per-session ANCHOR nodes; the
    S-node anchor graph of each row is solved, and each session whose
    anchor passes the significance gate (> 0.08) applies it rigidly to its
    keyframes, pose and filter and rebakes (or rebuilds) its local map.

    Returns (new_states, diagnostics): per session ``found``,
    ``candidate_session`` and ``fitness`` (of its candidate with the least
    fitness) and ``anchor_pose6``.  Host reads: one flag per ICP iteration
    (``registration.icp_point2point_brute``), the candidates, whether any
    match was verified (msst_tpu's ``lax.cond``) and which sessions pass
    the significance gate."""
    kf = states.kf
    B, K = kf.pose6.shape[:2]
    S = mesh.size
    b = _slots(B, mesh)
    dev = kf.count.device
    r2 = p.history_keyframe_search_radius ** 2
    k = max(1, min(n_cand, S - 1))

    n_pose6, n_cx, n_cm, n_sx, n_sm = _newest_keyframes(kf)
    g_pos = n_pose6.reshape(S, b, 6)[..., 3:]
    # d2[s, r, j]: slot s's newest keyframe to slot j's, both of row r
    d2 = torch.sum((g_pos.permute(1, 0, 2)[None] - g_pos[:, :, None, :]) ** 2,
                   dim=-1)
    g_count = kf.count.reshape(S, b)
    slot = torch.arange(S, device=dev)
    empty = (slot[:, None, None] == slot[None, None, :]) | (
        g_count.T[None] == 0)
    d2 = torch.where(empty, torch.inf, d2)
    # lax.top_k(-d2): ascending d2, ties (the empty sessions' inf) to the
    # lower session
    cands = torch.argsort(d2, dim=-1, stable=True)[..., :k]       # (S, b, k)
    cands_ok = (torch.gather(d2, -1, cands) < r2) & (g_count > 0)[..., None]
    cands, cands_ok = cands.reshape(B, k), cands_ok.reshape(B, k)

    good, fit, safe_q, safe_t = [], [], [], []
    ident = se3.Pose.identity(device=dev)
    cand_host = cands.tolist()
    for f in range(B):
        bi = f % b
        sub = _own_submap(kf, f, n_pose6[f], p)
        for ci in range(k):
            # the candidate's newest keyframe cloud in ITS frame; plain p2p
            # ICP (msst_tpu measured a line/plane refine here unstable under
            # repeated aligns)
            c = cand_host[f][ci] * b + bi
            cpose = se3.Pose.from_vec6(n_pose6[c])
            src_xyz = torch.cat([cpose.apply(n_cx[c]), cpose.apply(n_sx[c])])
            src_mask = torch.cat([n_cm[c], n_sm[c]])
            res = registration.icp_point2point_brute(
                src_xyz, src_mask, sub.xyz, sub.mask, ident, max_iters=50,
                max_corr_dist=p.history_keyframe_search_radius)
            ok = (cands_ok[f, ci] & res.converged
                  & (res.fitness < p.history_keyframe_fitness_score)
                  & (res.matched_frac > 0.3)
                  & torch.all(torch.isfinite(res.pose.q))
                  & torch.all(torch.isfinite(res.pose.t)))
            good.append(ok)
            fit.append(res.fitness)
            # masked-out factors must still be finite (NaN * 0 = NaN in the
            # graph relinearization)
            safe_q.append(torch.where(ok, res.pose.q, ident.q))
            safe_t.append(torch.where(ok, res.pose.t, 0.0))
    good = torch.stack(good).reshape(B, k)
    fitness = torch.stack(fit).reshape(B, k)
    t_q = torch.stack(safe_q).reshape(B, k, 4)
    t_t = torch.stack(safe_t).reshape(B, k, 3)

    # each row bi is its own S-session fleet: b anchor graphs, each solved
    # over its row's factors
    def by_row(x):
        return x.reshape((S, b) + x.shape[1:])

    rows = [_solve_anchors(by_row(good)[:, bi], by_row(cands)[:, bi],
                           by_row(fitness)[:, bi], by_row(t_q)[:, bi],
                           by_row(t_t)[:, bi], S, k) for bi in range(b)]
    anchor = se3.Pose(torch.stack([r.q for r in rows], dim=1).reshape(B, 4),
                      torch.stack([r.t for r in rows], dim=1).reshape(B, 3))

    # significance: a correction under the ICP noise floor is a random
    # jolt; small anchors are dropped per session
    sig = (torch.linalg.norm(anchor.t, dim=-1)
           + 2.0 * torch.sqrt(torch.clamp(1.0 - torch.abs(anchor.q[:, 0]),
                                          min=0.0))) > 0.08      # (B,)
    anchor_sig = se3.Pose(
        torch.where(sig[:, None], anchor.q, se3.quat_identity((B,), dev)),
        torch.where(sig[:, None], anchor.t, 0.0))

    st = states
    if bool(torch.any(good)):
        st = _apply_correction(states, anchor_sig, sig, p)
    best = torch.argmin(fitness, dim=1)
    brow = torch.arange(B, device=dev)
    diag = {"found": torch.any(good, dim=1),
            "candidate_session": cands[brow, best].to(torch.int32),
            "fitness": fitness[brow, best],
            "anchor_pose6": anchor.to_vec6()}
    return st, diag


def _apply_correction(st: LioState, anchor_sig: se3.Pose, sig: Tensor,
                      p: LioParams) -> LioState:
    """Each session's anchor (identity where it is not significant) applied
    to its keyframes, current pose and filter; a session whose frame moved
    rebakes its local map from the corrected keyframes (``_rebake_local_map``
    on the incremental map, else ``_rebuild_local_map``): scan-to-map
    against tables baked in the old frame would drag the pose back."""
    kf = st.kf
    B, K = kf.pose6.shape[:2]
    dev = kf.count.device
    anchor_k = se3.Pose(torch.repeat_interleave(anchor_sig.q, K, dim=0),
                        torch.repeat_interleave(anchor_sig.t, K, dim=0))
    corrected = anchor_k.compose(se3.Pose.from_vec6(kf.pose6.reshape(-1, 6)))
    new6 = corrected.to_vec6().reshape(B, K, 6)
    kvalid = torch.arange(K, device=dev)[None, :] < kf.count[:, None]
    new6 = torch.where(kvalid[..., None], new6, kf.pose6)
    cur = anchor_sig.compose(se3.Pose.from_vec6(st.pose6))
    nav = st.filter.nav
    navc = anchor_sig.compose(se3.Pose(nav.q, nav.p))
    kf_new = kf._replace(pose6=new6)

    maps, baked6, baked = [], [], []
    for f, moved in enumerate(sig.tolist()):
        kf_f = _row(kf_new, f)
        if not moved:
            maps.append(_row(st.local_map, f))
            baked6.append(kf.baked_pose6[f])
            baked.append(kf.baked[f])
        elif _use_incremental(p):
            lm, b6, bk = _rebake_local_map(kf_f, cur.t[f],
                                           st.last_scan_time[f], p)
            maps.append(lm)
            baked6.append(b6)
            baked.append(bk)
        else:
            maps.append(_rebuild_local_map(kf_f, cur.t[f],
                                           st.last_scan_time[f], p))
            baked6.append(kf.baked_pose6[f])
            baked.append(kf.baked[f])
    if _use_incremental(p):
        kf_new = kf_new._replace(baked_pose6=torch.stack(baked6),
                                 baked=torch.stack(baked))
    return st._replace(
        kf=kf_new, pose6=cur.to_vec6(), local_map=_stack(maps),
        filter=st.filter._replace(nav=nav._replace(
            q=navc.q, p=navc.t, v=se3.quat_rotate(anchor_sig.q, nav.v))))


def cooperative_map_merge_selective(states: LioState, scan_time: Tensor,
                                    p: LioParams, mesh: Mesh,
                                    axis: str = "session",
                                    budget: int = 8) -> LioState:
    """Position-first cooperative mapping: sessions exchange keyframe
    POSITIONS, then ship selected keyframe CLOUDS around an S-1-hop ring.
    At hop s slot i receives from slot (i - s) mod S the ``budget`` of that
    slot's keyframes (same row) nearest to i's current pose, and keeps a
    running best-``budget`` buffer by distance to its pose.  Each session's
    local map is then rebuilt from its own store plus that buffer
    (``count = K + budget``).  The packed clouds and poses come through the
    row-gather kernel."""
    kf = states.kf
    B, K = kf.pose6.shape[:2]
    S = mesh.size
    b = _slots(B, mesh)
    R = budget
    dev = kf.count.device
    valid = torch.arange(K, device=dev)[None, :] < kf.count[:, None]
    cur_pos = states.pose6[:, 3:]                               # (B, 3)
    kf_pos = torch.where(valid[..., None], kf.pose6[..., 3:], 1e9)
    Ck, Cs = kf.corner_xyz.shape[2], kf.surf_xyz.shape[2]
    tables = dict(
        pose6=kf.pose6.reshape(B * K, 6), time=kf.time.reshape(B * K, 1),
        cx=kf.corner_xyz.reshape(B * K, Ck, 3),
        sx=kf.surf_xyz.reshape(B * K, Cs, 3))
    cmask, smask = kf.corner_mask.reshape(B * K, Ck), kf.surf_mask.reshape(
        B * K, Cs)
    r2 = p.surrounding_keyframe_search_radius ** 2

    buf = dict(
        d2=torch.full((B, R), torch.inf, device=dev),
        pose6=torch.zeros((B, R, 6), device=dev),
        time=torch.full((B, R, 1), -1e9, device=dev),
        cx=torch.zeros((B, R, Ck, 3), device=dev),
        cm=torch.zeros((B, R, Ck), dtype=torch.bool, device=dev),
        sx=torch.zeros((B, R, Cs, 3), device=dev),
        sm=torch.zeros((B, R, Cs), dtype=torch.bool, device=dev))
    bidx = torch.arange(B, device=dev)[:, None]
    rows_b = torch.arange(b, device=dev)
    for s in range(1, S):
        # the sender of each receiver (the ring hop, a roll on the slot
        # axis); it packs its keyframes nearest the receiver's pose
        src_pos = torch.roll(kf_pos.reshape(S, b, K, 3), s, dims=0)
        d2 = torch.sum((src_pos.reshape(B, K, 3) - cur_pos[:, None, :]) ** 2,
                       dim=-1)
        sel = torch.argsort(d2, dim=-1, stable=True)[:, :R]      # (B, R)
        d2_sel = torch.gather(d2, 1, sel)
        sel_ok = torch.isfinite(d2_sel) & (d2_sel < r2)
        src = torch.roll(torch.arange(S, device=dev), s)[:, None] * b + rows_b
        flat = (src.reshape(B, 1) * K + sel).reshape(-1)
        recv = {name: _rows(t, flat).reshape((B, R) + t.shape[1:])
                for name, t in tables.items()}
        recv["cm"] = cmask[flat].reshape(B, R, Ck) & sel_ok[..., None]
        recv["sm"] = smask[flat].reshape(B, R, Cs) & sel_ok[..., None]
        # merge into the best-R buffer, scored by distance to MY pose
        rd2 = torch.sum((recv["pose6"][..., 3:] - cur_pos[:, None, :]) ** 2,
                        dim=-1)
        all_d2 = torch.cat([buf["d2"], torch.where(sel_ok, rd2, torch.inf)],
                           dim=1)
        keep = torch.argsort(all_d2, dim=1, stable=True)[:, :R]
        buf = {name: (torch.gather(all_d2, 1, keep) if name == "d2" else
                      torch.cat([buf[name], recv[name]], dim=1)[bidx, keep])
               for name in buf}

    keep_ok = torch.isfinite(buf["d2"])                           # (B, R)
    local = []
    for f in range(B):
        v, ko = valid[f], keep_ok[f]
        fleet = KeyframeStore(
            pose6=torch.cat([torch.where(v[:, None], kf.pose6[f], 1e9),
                             torch.where(ko[:, None], buf["pose6"][f], 1e9)]),
            time=torch.cat([torch.where(v, kf.time[f], -1e9),
                            torch.where(ko, buf["time"][f, :, 0], -1e9)]),
            corner_xyz=torch.cat([kf.corner_xyz[f], buf["cx"][f]]),
            corner_mask=torch.cat([kf.corner_mask[f] & v[:, None],
                                   buf["cm"][f] & ko[:, None]]),
            surf_xyz=torch.cat([kf.surf_xyz[f], buf["sx"][f]]),
            surf_mask=torch.cat([kf.surf_mask[f] & v[:, None],
                                 buf["sm"][f] & ko[:, None]]),
            count=torch.tensor(K + R, dtype=torch.int32, device=dev),
            baked_pose6=torch.zeros((K + R, 6), device=dev),
            baked=torch.zeros(K + R, dtype=torch.bool, device=dev))
        local.append(_rebuild_local_map(fleet, states.pose6[f, 3:],
                                        scan_time[f], p))
    return states._replace(local_map=_stack(local))


# ---------------------------------------------------------------------------
# the multi-session drive: moving sessions, measured convergence
# ---------------------------------------------------------------------------


def _pack_step_input(p: LioParams, s: dict,
                     prev_scan_start: float | None = None,
                     init_vel=None) -> StepInput:
    """One sim scan dict -> a StepInput of numpy arrays shaped for params
    p, with the pipeline's IMU window selection: the SCAN window covers
    [scan_start - 0.01, scan_end + 0.01] (deskew), the PRE window
    [prev_scan_start, scan_start + 0.005] (inter-scan propagation).  A
    first-T truncation of the dataset's 0.55 s sample span feeds the filter
    stale pre-scan samples and diverges within seconds (msst_tpu's
    finding)."""

    def pad(a, n):
        a = np.asarray(a)
        if a.shape[0] >= n:
            return a[:n]
        return np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    T = p.imu_window
    n = min(len(s["xyz"]), p.max_points)
    t0 = float(s["scan_start"])
    imu_t = np.asarray(s["imu_t"], np.float64)
    scan_end = t0 + (float(np.max(s["time_rel"])) if n else 0.1)
    in_scan = (imu_t >= t0 - 0.01) & (imu_t <= scan_end + 0.01)
    t_prev = t0 if prev_scan_start is None else float(prev_scan_start)
    in_pre = (imu_t >= t_prev) & (imu_t <= t0 + 0.005)

    def window(sel):
        k = min(int(sel.sum()), T)
        return (pad(imu_t[sel][:k].astype(np.float32), T),
                pad(np.asarray(s["imu_gyro"], np.float32)[sel][:k], T),
                pad(np.asarray(s["imu_acc"], np.float32)[sel][:k], T),
                np.arange(T) < k)

    st, sg, sa, sm = window(in_scan)
    pt, pg, pa, pm = window(in_pre)
    scan = ScanInput(
        xyz=pad(np.asarray(s["xyz"], np.float32), p.max_points),
        mask=np.arange(p.max_points) < n,
        ring=pad(np.asarray(s["ring"], np.int32), p.max_points),
        time=pad(np.asarray(s["time_rel"], np.float32), p.max_points),
        scan_start=np.float32(t0),
        imu_t=st, imu_gyro=sg, imu_acc=sa, imu_mask=sm,
        imu_rpy_init=np.asarray(s["imu_rpy"], np.float32),
        imu_available=np.asarray(bool(sm.sum() > 1)),
    )
    return StepInput(
        scan=scan,
        pre_t=pt, pre_gyro=pg, pre_acc=pa, pre_mask=pm,
        gps_xyz=np.zeros(3, np.float32), gps_sigma=np.ones(3, np.float32),
        gps_valid=np.asarray(False),
        init_vel_body=(np.zeros(3, np.float32) if init_vel is None
                       else np.asarray(init_vel, np.float32)),
        init_vel_valid=np.asarray(init_vel is not None),
    )


def inject_frame_offsets(states: LioState, offsets6: Tensor) -> LioState:
    """Apply a rigid frame error T_j (offsets6 (B, 6)) to each session j's
    estimator state (keyframes, graph poses, current pose, filter nav) and
    invalidate its cached local map (rebaked at the next keyframe insert),
    so each session stays SELF-consistent inside its offset frame: a
    controlled stand-in for accumulated inter-session drift, what
    :func:`cross_session_align` exists to remove."""
    kf, g = states.kf, states.graph
    B, K = kf.pose6.shape[:2]
    T = se3.Pose.from_vec6(offsets6)
    Tk = se3.Pose(T.q[:, None].expand(B, K, 4), T.t[:, None].expand(B, K, 3))
    kf6 = Tk.compose(se3.Pose.from_vec6(kf.pose6)).to_vec6()
    kvalid = torch.arange(K, device=kf.count.device)[None] < kf.count[:, None]
    kf = kf._replace(pose6=torch.where(kvalid[..., None], kf6, kf.pose6),
                     baked=torch.zeros_like(kf.baked))
    gq = Tk.compose(se3.Pose(g.poses.q, g.poses.t))
    m = g.pose_mask[..., None]
    g = g._replace(poses=se3.Pose(torch.where(m, gq.q, g.poses.q),
                                  torch.where(m, gq.t, g.poses.t)))
    nav = states.filter.nav
    navp = T.compose(se3.Pose(nav.q, nav.p))
    fs = states.filter._replace(nav=nav._replace(
        q=navp.q, p=navp.t, v=se3.quat_rotate(T.q, nav.v)))
    lm = states.local_map._replace(
        valid=torch.zeros_like(states.local_map.valid))
    return states._replace(
        kf=kf, graph=g,
        pose6=T.compose(se3.Pose.from_vec6(states.pose6)).to_vec6(),
        filter=fs, local_map=lm)


def drive_params(horizon: int = 360) -> LioParams:
    """msst_tpu's validated drive profile on the port's ``tiny_params``:
    16 x `horizon`, 32 keyframes, 8 Gauss-Newton iterations, loop closure
    off.  msst_tpu measured that the graft-entry tiny profile (horizon 90)
    does not track a moving session, and that at 180 columns two consistent
    sessions 3-5 m apart already score 0.3-0.76 rendezvous fitness on
    sampling sparsity alone, so 360 columns keep it under the 0.3 gate."""
    return tiny_params(
        loop_closure_enabled=False, horizon_scan=horizon,
        max_points=16 * horizon + 8, imu_window=64, max_keyframes=32,
        loop_submap_cap=8192, scan2map_max_iters=8)


def multisession_drive(p: LioParams, mesh: Mesh, n_scans: int = 56,
                       n_warm: int = 24, align_every: int = 6,
                       horizon: int = 360, use_align: bool = True,
                       seed: int = 0, axis: str = "session") -> dict:
    """Drive S = ``mesh.size`` moving sessions through a shared sim world
    and measure whether :func:`cross_session_align` REDUCES inter-session
    disagreement.

    Sessions share a start pose but drive distinct circles (1.6..3.0 m/s).
    At scan `n_warm` every non-datum session's frame is perturbed by a
    known rigid offset (:func:`inject_frame_offsets`); the drive goes on
    with the alignment every `align_every` scans.  Ground truth is the sim
    trajectory rebased to the common start, so a session's error is its
    frame disagreement.

    Returns {injected_offset_m, err_at_injection, err_final,
    err_datum_final, loops_total, mean_speed}: errors are the mean over
    the perturbed sessions of |est - gt| [m]."""
    from ..utils import sim

    S = mesh.size
    world = sim.World()
    datasets = []
    for j in range(S):
        traj = sim.SimTrajectory(kind="circle", radius=8.0,
                                 speed=1.6 + 1.4 * j / max(S - 1, 1))
        datasets.append(sim.make_dataset(
            world, traj, n_scans=n_scans, scan_dt=0.1, n_scan=p.n_scan,
            horizon=horizon, seed=seed + j))
    p0 = datasets[0][0]["gt_pose"][:3, 3]  # shared start position

    states = shard_batch(make_batched_state(p, S, mesh.device), mesh, axis)

    rng = np.random.default_rng(seed + 99)
    offs = np.zeros((S, 6), np.float32)
    offs[1:, :3] = rng.uniform(-0.03, 0.03, (S - 1, 3))   # ~1.7 deg
    offs[1:, 3:] = rng.uniform(-0.6, 0.6, (S - 1, 3))     # ~0.6 m
    off_norm = float(np.linalg.norm(offs[1:, 3:], axis=1).mean())

    def init_vel(j):
        # scan-start body velocity for the FIRST scan's translation deskew
        # (the pipeline's dynamic-init bootstrap); without it the smeared
        # first cloud warps the boot map
        T0 = datasets[j][0]["gt_pose"]
        v_w = (datasets[j][1]["gt_pose"][:3, 3] - T0[:3, 3]) / 0.1
        return (T0[:3, :3].T @ v_w).astype(np.float32)

    def batched_inputs(i):
        prev = None if i == 0 else datasets[0][i - 1]["scan_start"]
        rows = [_pack_step_input(p, datasets[j][i], prev,
                                 init_vel=init_vel(j) if i == 0 else None)
                for j in range(S)]
        stacked = _tree_map(lambda *xs: torch.from_numpy(np.stack(xs)),
                            *rows)
        return shard_batch(stacked, mesh, axis)

    def session_err(outs, i):
        est = outs.pose6[:, 3:].cpu().numpy()
        gt = np.stack([datasets[j][i]["gt_pose"][:3, 3] - p0
                       for j in range(S)])
        return np.linalg.norm(est - gt, axis=1)

    err_inject = None
    speeds = []
    loops_total = 0
    for i in range(n_scans):
        states, outs, stats = batched_odometry_step(
            states, batched_inputs(i), p, mesh, axis)
        speeds.append(float(stats["mean_speed"]))
        if i == n_warm:
            states = inject_frame_offsets(
                states, torch.from_numpy(offs).to(mesh.device))
        if i == n_warm + 2:  # measured after the post-injection rebake
            err_inject = session_err(outs, i)
        if (use_align and i > n_warm + 2
                and (i - n_warm) % align_every == 0):
            states, diag = cross_session_align(states, p, mesh, axis)
            loops_total += int(torch.sum(diag["found"]))
    err_final = session_err(outs, n_scans - 1)
    return {
        "injected_offset_m": round(off_norm, 3),
        "err_at_injection": round(float(err_inject[1:].mean()), 3),
        "err_final": round(float(err_final[1:].mean()), 3),
        "err_datum_final": round(float(err_final[0]), 3),
        "loops_total": loops_total,
        "mean_speed": round(float(np.mean(speeds[1:])), 3),
    }
