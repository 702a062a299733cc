"""The port's odometry step as a whole against msst_tpu's LioSam, on the
20-scan tiny-profile circle drive (seed 5), for both scan-to-map methods
(the voxel-feature map and the reference-faithful 5-NN path), the default
device, and the paths the port does not take yet.

msst_tpu's ``odometry_core`` reads an undefined name ``inp`` where it means
its prepared scan ``ps`` (mapping.py:1295-1301), so every trace of its step
raises NameError.  The reference is run here without editing it: a
test-local jitted step binds ``mapping.inp = ps`` only while it traces and
replaces ``pipeline.odometry_step_packed`` for the duration of the fixture;
msst_tpu's own jitted functions are never traced with the binding.

Two comparisons:

* step by step: each of msst_tpu's recorded step inputs (its state before
  the step + the packed scan) goes through the port's step too.  Same
  keyframe decision, Gauss-Newton iterations and degeneracy flag, pose to
  1e-4 m/rad (measured worst 1.3e-6: float32 rounding of differently
  ordered sums).
* the whole drive, each package threading its own state: same keyframe
  count and is_keyframe sequence, both within 0.15 m of ground truth, and
  positions within 0.08 m of each other.  That gap cannot be 1 cm on this
  profile: the tiny profile fits 3-point voxel planes (vox_plane_min_spread
  = 0), whose normals are set by rounding when the points are near
  collinear, so the drive amplifies float32 noise.  Measured: port vs
  msst_tpu 0.062 m worst; msst_tpu against itself with 1e-6 m of noise
  added to the input points 0.040 m worst, with a different keyframe
  sequence.  At the bench's 16x1800 profile the same comparison over 24
  scans stays within 5.8 mm.

The knn path (``scan2map_method="knn"``) gets the same two comparisons
against msst_tpu's XLA form of the 5-NN query, and its first registered
steps once more against msst_tpu with ``use_pallas="on"`` (the Pallas query
kernel in interpret mode inside the whole step; the two forms of msst_tpu
give bit-equal step outputs here).  On the CPU the port's ``knn.query`` is
the plain twin of the CUDA kernel.

* knn, step by step: same keyframe decision, registered-or-not, degeneracy
  flag and keyframe count; pose to 5e-3 m/rad, velocity to 1e-2 m/s, map
  occupancy to 1e-3 (8 voxels of the surf cap: a keyframe whose pose differs
  by a millimetre puts a few boundary points into other voxels).  The pose
  cannot be held to 1e-4 on a lidar map, by any implementation: the 5
  nearest map points of a surface point often lie along one ring, the two
  smallest eigenvalues of their covariance are then equal to rounding, and
  the plane's normal is set by the last bits of the arithmetic.  Such rows
  pass the plane test (collinear points fit every plane through their line)
  and pull the minimum.  msst_tpu differs from itself by as much: its step
  run eagerly (op by op) against the same step jitted gives pose gaps of
  2.6e-4 to 1.4e-3 over recorded steps 1-5 and 3 against 4 iterations on
  step 4 (``test_knn_reference_differs_from_itself_by_rounding`` holds
  that).  Measured for the port: worst pose gap of a step 1.7e-3, worst
  velocity gap 2.5e-3, 20 of 26 registered steps with equal iteration
  counts (one step ran to the cap of 10 in msst_tpu and 6 in the port).
  What can be exact is exact: on a recorded map the 5-NN indices and the
  kept rows are equal, and the line and plane coefficients agree to 1e-4
  wherever the neighbour covariance is well conditioned
  (``test_knn_coeffs_match_reference_on_recorded_map``); on the regular
  grids of tests/test_torch_scan2map_knn.py the whole Gauss-Newton agrees to
  1e-4 with equal iteration counts.
* knn, whole drive: same keyframe sequence, positions within 0.02 m
  (measured worst 0.0045 m: exact nearest neighbours do not amplify the
  noise over a drive the way the 3-point voxel planes do).
"""

import jax
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.models.liosam import LioSam as TLioSam
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam import state as tstate
from msst_torch.models.liosam.params import LioParams
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.ops import knn as tknn
from msst_torch.ops import registration as treg
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam import pipeline as jpipe
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import registration as jreg
from msst_tpu.utils import sim

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small and many: with the suite's parallel
    workers, each torch intra-op pool of one thread per core oversubscribes
    the CPU and slows every worker.  One thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_SCANS = 20
DRIVE_GAP_M = 0.08
KNN_DRIVE_GAP_M = 0.02
KNN_STEP = dict(pose_atol=5e-3, vel_atol=1e-2, occ_atol=1e-3,
                same_iterations=False)
KNN_SAME_ITERATIONS = 0.6   # least share of steps with equal GN iterations
GT_ERR_M = 0.15
N_PALLAS_STEPS = 4


def _drive():
    return sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=N_SCANS, scan_dt=0.1, n_scan=16,
                            horizon=360, seed=5)


def _feed(lio, s):
    return lio.process_scan(s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
                            imu_t=s["imu_t"], imu_gyro=s["imu_gyro"],
                            imu_acc=s["imu_acc"], imu_rpy=s["imu_rpy"])


def _reference_step(state, points, aux, p):
    ps = jmap.prepare_scan(jmap.unpack_step_input(points, aux, p), p)
    jmap.inp = ps   # the name msst_tpu's odometry_core reads; see docstring
    try:
        return jmap.odometry_core(state, ps, p)
    finally:
        del jmap.inp


def _record_reference(p):
    """msst_tpu's LioSam(p) over the drive, recording every step call."""
    data = _drive()
    jstep = jax.jit(_reference_step, static_argnames=("p",))
    calls = []
    gps_case = {}

    def recording_step(state, points, aux, p):
        new_state, out = jstep(state, points, aux, p)
        out_np = jax.tree.map(np.asarray, out)
        calls.append((jax.tree.map(np.asarray, state), np.asarray(points),
                      np.asarray(aux), out_np))
        # the first keyframe step after the re-feed with 3+ keyframes; its
        # arguments are kept as they were, so the GPS test's call of the
        # jitted step hits the compiled program (numpy copies would lose
        # the weak types of its trace)
        if (not gps_case and len(calls) > 8 and out_np.is_keyframe
                and out_np.kf_count >= 3):
            gps_case.update(call=len(calls) - 1, state=state, points=points,
                            aux=aux, p=p)
        return new_state, out

    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "odometry_step_packed", recording_step)
    try:
        lio = jpipe.LioSam(p)
        is_kf = [bool(_feed(lio, s).is_keyframe) for s in data]
        traj = lio.trajectory.as_matrices()[:, :3, 3]
        count = int(lio.state.kf.count)
    finally:
        mp.undo()
    return dict(data=data, calls=calls, is_kf=is_kf, traj=traj, count=count,
                step=jstep, gps_case=gps_case)


@pytest.fixture(scope="module")
def reference():
    return _record_reference(jtiny(loop_closure_enabled=False))


@pytest.fixture(scope="module")
def reference_knn():
    return _record_reference(jtiny(loop_closure_enabled=False,
                                   scan2map_method="knn"))


def _assert_step_matches(got, want, pose_atol=1e-4, vel_atol=1e-3,
                         occ_atol=1e-6, same_iterations=True):
    assert bool(got.is_keyframe) == bool(want.is_keyframe)
    if same_iterations:
        assert int(got.s2m_iterations) == int(want.s2m_iterations)
    assert (int(got.s2m_iterations) > 0) == (int(want.s2m_iterations) > 0)
    assert bool(got.degenerate) == bool(want.degenerate)
    assert int(got.kf_count) == int(want.kf_count)
    np.testing.assert_allclose(got.pose6.numpy(), np.asarray(want.pose6),
                               atol=pose_atol)
    np.testing.assert_allclose(got.velocity.numpy(), np.asarray(want.velocity),
                               atol=vel_atol)
    np.testing.assert_allclose(got.map_occupancy.numpy(),
                               np.asarray(want.map_occupancy), atol=occ_atol)


def _assert_steps_match(calls, p, **tolerances):
    """Each recorded (state, packed scan) through the port's step.  Returns
    the share of registered steps with equal Gauss-Newton iteration counts."""
    assert len(calls) == N_SCANS + 8   # the dynamic-init re-feed included
    n_kf = n_reg = n_same = 0
    for state_np, points, aux, want in calls:
        state = convert.from_numpy(state_np, "cpu")
        _, got = tmap.odometry_step_packed(state, torch.from_numpy(points),
                                           torch.from_numpy(aux), p)
        _assert_step_matches(got, want, **tolerances)
        n_kf += bool(want.is_keyframe)
        n_reg += int(want.s2m_iterations) > 0
        n_same += (int(want.s2m_iterations) > 0
                   and int(got.s2m_iterations) == int(want.s2m_iterations))
    assert n_kf >= 3 and n_reg >= N_SCANS
    return n_same / n_reg


def _assert_drive_matches(ref, p, gap_m):
    """The whole drive, each package threading its own state."""
    data = ref["data"]
    lio = TLioSam(p, device="cpu")
    is_kf = [bool(_feed(lio, s).is_keyframe) for s in data]
    traj = lio.trajectory.as_matrices()[:, :3, 3]
    gt = np.stack([s["gt_pose"][:3, 3] - data[0]["gt_pose"][:3, 3]
                   for s in data])
    assert int(lio.state.kf.count) == ref["count"]
    assert is_kf == ref["is_kf"]
    assert traj.shape == ref["traj"].shape == (N_SCANS, 3)
    assert np.linalg.norm(traj - gt, axis=1).max() < GT_ERR_M
    assert np.linalg.norm(ref["traj"] - gt, axis=1).max() < GT_ERR_M
    assert np.linalg.norm(traj - ref["traj"], axis=1).max() < gap_m


def test_step_by_step_matches_reference(reference):
    _assert_steps_match(reference["calls"], ttiny(loop_closure_enabled=False))


def test_drive_matches_reference(reference):
    _assert_drive_matches(reference, ttiny(loop_closure_enabled=False),
                          DRIVE_GAP_M)


def test_knn_step_by_step_matches_reference(reference_knn):
    same = _assert_steps_match(
        reference_knn["calls"],
        ttiny(loop_closure_enabled=False, scan2map_method="knn"), **KNN_STEP)
    assert same >= KNN_SAME_ITERATIONS


def test_knn_drive_matches_reference(reference_knn):
    _assert_drive_matches(reference_knn,
                          ttiny(loop_closure_enabled=False,
                                scan2map_method="knn"), KNN_DRIVE_GAP_M)


def test_knn_steps_match_reference_with_pallas_kernel(reference_knn):
    """The first registered steps once more through msst_tpu with
    use_pallas="on" (its Pallas query kernel, interpreted, inside the whole
    step), from the recorded states: the port agrees with that form too."""
    p_j = jtiny(loop_closure_enabled=False, scan2map_method="knn",
                use_pallas="on")
    p_t = ttiny(loop_closure_enabled=False, scan2map_method="knn")
    registered = [c for c in reference_knn["calls"]
                  if int(c[3].s2m_iterations) > 0][:N_PALLAS_STEPS]
    assert len(registered) == N_PALLAS_STEPS
    for state_np, points, aux, want_xla in registered:
        _, want = reference_knn["step"](state_np, points, aux, p_j)
        assert int(want.s2m_iterations) == int(want_xla.s2m_iterations)
        _, got = tmap.odometry_step_packed(
            convert.from_numpy(state_np, "cpu"), torch.from_numpy(points),
            torch.from_numpy(aux), p_t)
        _assert_step_matches(got, want, **KNN_STEP)


def test_knn_state_round_trips_through_numpy(reference_knn):
    """A knn-mode LioState goes msst_tpu -> numpy -> port -> numpy with every
    leaf kept (the hash grids included), and the port's own initial state
    has the same leaves, shapes and dtypes as msst_tpu's."""
    state_np = reference_knn["calls"][-1][0]
    assert int(state_np.kf.count) >= 3
    t_state = convert.from_numpy(state_np, "cpu")
    assert type(t_state.local_map.corner_grid).__name__ == "HashGrid"
    assert t_state.local_map.surf_grid.orig_idx.dtype == torch.int32
    back = convert.to_numpy(t_state)
    want, got = jax.tree.leaves(state_np), jax.tree.leaves(back)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    p_t = ttiny(loop_closure_enabled=False, scan2map_method="knn")
    init = jax.tree.leaves(convert.to_numpy(tstate.init_state(p_t, "cpu")))
    first = jax.tree.leaves(reference_knn["calls"][0][0])
    assert len(init) == len(first)
    for w, g in zip(first, init):
        assert g.dtype == w.dtype and g.shape == w.shape


def _centroids_f64(flat_xyz, flat_mask, leaf, origin):
    """The packed downsample's centroids in float64, voxels in ascending key
    order (cells from the float32 arithmetic both packages use)."""
    x = flat_xyz[flat_mask]
    c = np.floor((x - origin) / np.float32(leaf)).astype(np.int64) + 512
    assert c.min() >= 0 and c.max() < 1024
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    _, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((inv.max() + 1, 3))
    np.add.at(sums, inv, x.astype(np.float64))
    return sums / np.bincount(inv)[:, None]


def test_knn_rebuild_local_map_matches_reference(reference_knn):
    """``_rebuild_local_map`` (knn branch) on the recorded keyframe store of
    the last step, carried across with convert.

    The gathered world clouds are exactly equal, the map masks are equal,
    and the hash grids are exactly equal once both are built from the same
    cloud.  The map clouds (voxel centroids, coordinates to 40 m) agree with
    a float64 centroid of the same voxels to 8e-6 m (one float32 ULP at
    64 m; measured 1.9e-6) and with msst_tpu's to 1e-4 m: msst_tpu takes a
    voxel's residual sum as a difference of float32 prefix sums over the
    whole cloud, which is 4.6e-5 m off the float64 centroid here, where the
    port sums each voxel on its own."""
    p_j = jtiny(loop_closure_enabled=False, scan2map_method="knn")
    p_t = ttiny(loop_closure_enabled=False, scan2map_method="knn")
    state_np = reference_knn["calls"][-1][0]
    n = int(state_np.kf.count)
    assert n >= 3
    pos, when = state_np.kf.pose6[n - 1, 3:], state_np.kf.time[n - 1]
    kf_j = jax.tree.map(jax.numpy.asarray, state_np.kf)
    kf_t = convert.from_numpy(state_np.kf, "cpu")
    pos_t, when_t = torch.from_numpy(pos), torch.from_numpy(np.asarray(when))
    flat_j = jmap._gather_nearby_world(kf_j, jax.numpy.asarray(pos),
                                       jax.numpy.asarray(when), p_j)
    flat_t = tmap._gather_nearby_world(kf_t, pos_t, when_t, p_t)
    want = jax.tree.map(np.asarray, jmap._rebuild_local_map(
        kf_j, jax.numpy.asarray(pos), jax.numpy.asarray(when), p_j))
    got = tmap._rebuild_local_map(kf_t, pos_t, when_t, p_t)
    leaves = {"corner": p_t.mapping_corner_leaf_size,
              "surf": p_t.mapping_surf_leaf_size}
    for i, name in enumerate(("corner", "surf")):
        f_mask = np.asarray(flat_j[i].mask)
        np.testing.assert_array_equal(flat_t[i].mask.numpy(), f_mask)
        np.testing.assert_array_equal(flat_t[i].xyz.numpy()[f_mask],
                                      np.asarray(flat_j[i].xyz)[f_mask])
        w_mask = getattr(want, f"{name}_mask")
        g_xyz = getattr(got, f"{name}_xyz").numpy()
        np.testing.assert_array_equal(getattr(got, f"{name}_mask").numpy(),
                                      w_mask)
        assert w_mask.sum() > 100
        truth = _centroids_f64(np.asarray(flat_j[i].xyz), f_mask,
                               leaves[name], pos)
        assert len(truth) == w_mask.sum()
        np.testing.assert_allclose(g_xyz[w_mask], truth, atol=8e-6, rtol=0)
        np.testing.assert_allclose(g_xyz, getattr(want, f"{name}_xyz"),
                                   atol=1e-4, rtol=0)
        # the grid over msst_tpu's own cloud: every table exactly equal
        w_grid = getattr(want, f"{name}_grid")
        g_grid = tknn.build(torch.from_numpy(getattr(want, f"{name}_xyz")),
                            torch.from_numpy(w_mask), 1.0, p_t.knn_table_size)
        for f in w_grid._fields:
            np.testing.assert_array_equal(getattr(g_grid, f).numpy(),
                                          getattr(w_grid, f), err_msg=f)
        # and the grid the port built indexes the port's cloud
        own = getattr(got, f"{name}_grid")
        np.testing.assert_array_equal(own.xyz.numpy(),
                                      g_xyz[own.orig_idx.numpy()])
    assert bool(got.valid)
    np.testing.assert_array_equal(got.anchor.numpy(), pos)
    occ_t, _ = tmap._map_telemetry(got, p_t)
    occ_j, _ = jmap._map_telemetry(
        jax.tree.map(jax.numpy.asarray, want), p_j)
    np.testing.assert_allclose(occ_t.numpy(), np.asarray(occ_j), atol=1e-7)


@pytest.mark.parametrize("name", ["corner", "surf"])
def test_knn_coeffs_match_reference_on_recorded_map(reference_knn, name):
    """The line and plane coefficients on the local map of the last recorded
    state (a real lidar map), for 1500 map points moved by 3 cm of noise:
    5-NN indices and flags equal, the same rows kept, and the weighted
    plane normals equal to 1e-4 (up to the eigenvector's sign) wherever the
    neighbour covariance separates the wanted eigenvalue from the next by
    more than 1e-2 of the largest, the line gradients to 5e-4 (the unit
    vector perp / |perp| with |perp| ~ 3 cm, from coordinates to 40 m whose
    float32 ULP is 4e-6; measured 1.2e-4).  The other kept rows (a ring's collinear
    neighbours under a surface point) have a normal set by rounding, which
    is what bounds the step's pose tolerance."""
    lm = reference_knn["calls"][-1][0].local_map
    map_xyz, map_mask = getattr(lm, f"{name}_xyz"), getattr(lm, f"{name}_mask")
    grid = getattr(lm, f"{name}_grid")
    rng = np.random.default_rng(0)
    q = (map_xyz[rng.choice(np.flatnonzero(map_mask), size=1500)]
         + rng.normal(scale=0.03, size=(1500, 3))).astype(np.float32)
    qm = np.ones(1500, bool)
    jg = type(grid)(*[jax.numpy.asarray(x) for x in grid])
    tg = convert.from_numpy(grid, "cpu")
    jq, tq = jax.numpy.asarray(q), torch.from_numpy(q)
    jqm, tqm = jax.numpy.asarray(qm), torch.from_numpy(qm)
    rj = jknn.query(jg, jq, jqm, k=5, candidates_per_cell=24)
    rt = tknn.query(tg, tq, tqm, k=5, candidates_per_cell=24)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    if name == "surf":
        want = jreg._surf_coeffs(jq, jq, jqm, jg, jax.numpy.asarray(map_xyz), 24)
        got = treg._surf_coeffs(tq, tq, tqm, tg, torch.from_numpy(map_xyz), 24)
    else:
        want = jreg._corner_coeffs(jq, jqm, jg, jax.numpy.asarray(map_xyz), 24)
        got = treg._corner_coeffs(tq, tqm, tg, torch.from_numpy(map_xyz), 24)
    keep = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), keep)
    assert keep.sum() > 500
    nbrs = map_xyz[np.asarray(rj.idx)][keep].astype(np.float64)
    dev = nbrs - nbrs.mean(axis=1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", dev, dev))
    gap = ((ev[:, 1] - ev[:, 0]) if name == "surf"
           else (ev[:, 2] - ev[:, 1])) / ev[:, 2]
    well = gap > 1e-2
    assert well.mean() > 0.8
    if name == "surf":
        assert (~well).mean() > 0.05   # the rows that bound the tolerance
    n_w, n_g = np.asarray(want[0])[keep], got[0].numpy()[keep]
    sign = np.where(np.sum(n_w * n_g, axis=1) < 0, -1.0, 1.0)
    np.testing.assert_allclose((n_g * sign[:, None])[well], n_w[well],
                               atol=1e-4 if name == "surf" else 5e-4)
    if name == "corner":
        # the point-to-line gradient has no sign freedom
        assert np.all(sign > 0)
        np.testing.assert_allclose(got[1].numpy()[keep],
                                   np.asarray(want[1])[keep], atol=1e-4)


def test_knn_reference_differs_from_itself_by_rounding(reference_knn):
    """Why the knn step's pose is held to 5e-3 and not to 1e-4: msst_tpu's
    own step, run eagerly (op by op) instead of jitted, from the same
    recorded state and scan, lands more than 1e-4 away from its jitted
    result (measured 1.4e-3 on both steps), and the port is no further from
    the jitted result than the tolerance that covers both."""
    p_j = jtiny(loop_closure_enabled=False, scan2map_method="knn")
    p_t = ttiny(loop_closure_enabled=False, scan2map_method="knn")
    for n in (4, 5):
        state_np, points, aux, want = reference_knn["calls"][n]
        assert int(want.s2m_iterations) > 0
        with jax.disable_jit():
            _, eager = _reference_step(
                jax.tree.map(jax.numpy.asarray, state_np),
                jax.numpy.asarray(points), jax.numpy.asarray(aux), p_j)
        own_gap = np.abs(np.asarray(eager.pose6) - want.pose6).max()
        _, got = tmap.odometry_step_packed(
            convert.from_numpy(state_np, "cpu"), torch.from_numpy(points),
            torch.from_numpy(aux), p_t)
        port_gap = np.abs(got.pose6.numpy() - want.pose6).max()
        assert 1e-4 < own_gap < KNN_STEP["pose_atol"]
        assert port_gap < KNN_STEP["pose_atol"]


def test_gps_keyframe_step_matches_reference(reference):
    """A keyframe step that fuses a GPS fix: the recorded state is made
    uncertain (position covariance above pose_cov_threshold) and the packed
    scan carries a fix, so the step adds the GPS factor, solves the pose
    graph (dense Gauss-Newton over all keyframes) and updates the filter
    with the position.  Poses to 1e-3 m/rad (the graph solve amplifies
    float32 rounding), the factor exactly."""
    case = reference["gps_case"]
    p_j, p_t = case["p"], ttiny(loop_closure_enabled=False)
    T = p_j.imu_window
    state_np, points, aux, want = reference["calls"][case["call"]]
    state_np = state_np._replace(filter=state_np.filter._replace(
        cov=state_np.filter.cov * 20.0))
    aux = aux.copy()
    aux[2 * T, 6] = 1.0                                   # gps_valid
    aux[2 * T + 1, :3] = want.pose6[3:] + [0.3, -0.2, 0.1]
    aux[2 * T + 1, 3:6] = 0.5
    j_state = case["state"]
    j_state = j_state._replace(filter=j_state.filter._replace(
        cov=j_state.filter.cov * 20.0))
    j_state, j_out = reference["step"](j_state, case["points"],
                                       jax.numpy.asarray(aux), p_j)
    t_state, t_out = tmap.odometry_step_packed(
        convert.from_numpy(state_np, "cpu"), torch.from_numpy(points),
        torch.from_numpy(aux), p_t)
    j_state = jax.tree.map(np.asarray, j_state)
    t_state = convert.to_numpy(t_state)
    assert int(t_state.n_gps) == int(j_state.n_gps) == 1
    np.testing.assert_array_equal(t_state.graph.gps.mask, j_state.graph.gps.mask)
    np.testing.assert_array_equal(t_state.graph.gps.idx, j_state.graph.gps.idx)
    np.testing.assert_allclose(t_state.graph.gps.xyz, j_state.graph.gps.xyz,
                               atol=1e-6)
    n = int(j_state.kf.count)
    np.testing.assert_allclose(t_state.kf.pose6[:n], j_state.kf.pose6[:n],
                               atol=1e-3)
    np.testing.assert_allclose(t_out.pose6.numpy(), np.asarray(j_out.pose6),
                               atol=1e-3)
    np.testing.assert_allclose(t_state.filter.nav.p, j_state.filter.nav.p,
                               atol=1e-3)
    # the fix moved the earlier keyframes: the solve ran in both
    moved = np.abs(t_state.kf.pose6[:n - 1] - state_np.kf.pose6[:n - 1]).max()
    assert moved > 1e-3


_UNPORTED = {
    "rebuild": dict(params=dict(map_update="rebuild")),
    "exact_features": dict(params=dict(feature_method="exact"), scans=1),
    "window": dict(window=4),
    "eviction": dict(params=dict(max_keyframes=2), scans=12),
}


@pytest.mark.parametrize("case", sorted(_UNPORTED))
def test_unported_paths_raise(case):
    """Each path the port does not take yet raises NotImplementedError
    naming its ROADMAP item, where it is selected."""
    spec = _UNPORTED[case]
    kw = dict(loop_closure_enabled=False, dynamic_init=False)
    kw.update(spec.get("params", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP item L"):
        lio = TLioSam(ttiny(**kw), device="cpu",
                      window=spec.get("window", 1))
        data = sim.make_dataset(sim.World(), sim.SimTrajectory(kind="circle"),
                                n_scans=spec.get("scans", 0), scan_dt=0.5,
                                n_scan=16, horizon=360, seed=1)
        for s in data:
            lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                             s["scan_start"], imu_t=s["imu_t"],
                             imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                             imu_rpy=s["imu_rpy"])


def test_default_params_construct_and_step():
    """``LioSam(LioParams())`` runs with the package's own defaults (loop
    closure on, 1024 keyframes, so the CG graph solver): two 16x1800 scans
    on the CPU give finite poses."""
    lio = TLioSam(LioParams(), device="cpu")
    assert lio.loop_enabled and lio.p.max_keyframes > lio.p.cg_threshold
    data = sim.make_dataset(sim.World(), sim.SimTrajectory(kind="circle"),
                            n_scans=2, scan_dt=0.1, n_scan=16, horizon=1800,
                            seed=1)
    for s in data:
        out = _feed(lio, s)
    assert int(out.kf_count) >= 1
    traj = lio.trajectory.as_matrices()
    assert traj.shape == (2, 4, 4) and np.isfinite(traj).all()


def test_default_device_is_the_card():
    """``LioSam(params)`` runs on the GPU.  Where no CUDA device is present
    it raises and says so; it does not carry on on the CPU.  ``device="cpu"``
    is the explicit way to run there."""
    p = ttiny(loop_closure_enabled=False)
    if torch.cuda.is_available():
        assert TLioSam(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLioSam(p)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLioSam(p, device="cuda:0")
    lio = TLioSam(p, device="cpu")
    assert lio.device.type == "cpu"
    assert lio.state.pose6.device.type == "cpu"
