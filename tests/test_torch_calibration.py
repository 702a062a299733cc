"""The calibration tools of the port against msst_tpu, on the CPU, on
tests/test_calibration.py's structured scene: Multi_LiCa (``multi_lica``:
``MultiLidarCalibrator``, ``calibrate_pair`` with its stages and its retry
through ``auto_calibrate``, ``calibrate_to_ground``), SensorsCalibration's
``auto_calibrate`` with its yaw search and the voxel-occupancy refinement,
the NDT calibrator over three frames, the Allan calibrator, the manual
calibrator, ``evaluation``, ``urdf`` and ``utils.io_pcd.read_pcd``.

RANSAC draws are msst_tpu's (``use_jax_draws``, see test_torch_calib_ops.py).
End to end, a calibrated pose is held to msst_tpu's within 0.1 degree and
1 cm (POSE_DEG, POSE_M): FPFH's mutual matches on this planar scene follow
float32 rounding (repeated features), so the two packages may reach GICP
from different coarse poses, and GICP lands within that of the same
optimum.  GICP and NDT given the same inputs are held to 1e-5 with equal
iteration counts.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rs

from msst_torch import convert
from msst_torch.models.calibration import auto_calib as tac
from msst_torch.models.calibration import evaluation as tev
from msst_torch.models.calibration import imu_allan as tallan
from msst_torch.models.calibration import manual_calib as tman
from msst_torch.models.calibration import multi_lica as tml
from msst_torch.models.calibration import ndt_calib as tnd
from msst_torch.models.calibration import urdf as turdf
from msst_torch.ops import se3 as tse3
from msst_torch.utils import io_pcd as tio
from msst_tpu.models.calibration import auto_calib as jac
from msst_tpu.models.calibration import evaluation as jev
from msst_tpu.models.calibration import imu_allan as jallan
from msst_tpu.models.calibration import manual_calib as jman
from msst_tpu.models.calibration import multi_lica as jml
from msst_tpu.models.calibration import ndt_calib as jnd
from msst_tpu.models.calibration import urdf as jurdf
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import se3 as jse3
from msst_tpu.utils import io_pcd as jio
from tests.test_torch_calib_ops import (J, N, POSE_ATOL, T,  # noqa: F401
                                        _iters_of_jax, _one_torch_thread,
                                        assert_pose_close, structured_scene,
                                        use_jax_draws, view_from)

POSE_DEG = 0.1
POSE_M = 0.01


def _T(rpy, t):
    M = np.eye(4)
    M[:3, :3] = Rs.from_euler("xyz", rpy).as_matrix()
    M[:3, 3] = t
    return M


def _pose_gap(jp, tp):
    """(degrees, metres) between two poses of the two packages."""
    A, B = N(jp.to_matrix()).astype(np.float64), N(tp.to_matrix())
    c = (np.trace(A[:3, :3].T @ B[:3, :3]) - 1.0) / 2.0
    return (float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))),
            float(np.linalg.norm(A[:3, 3] - B[:3, 3])))


def _assert_pose_near(jp, tp, T_gt=None):
    deg, m = _pose_gap(jp, tp)
    assert deg < POSE_DEG and m < POSE_M, (deg, m)
    if T_gt is not None:       # and right: tests/test_calibration.py's gates
        gdeg, gm = _pose_gap(jse3.Pose.from_matrix(J(T_gt.astype(np.float32))),
                             tp)
        assert gdeg < 2.0 and gm < 0.2, (gdeg, gm)


@pytest.fixture(scope="module")
def scene():
    """A target view and a source view (yaw 0.5 rad, 2.2 m apart) of the
    structured scene, and the true source -> target extrinsic."""
    world = structured_scene(np.random.default_rng(12))
    tgt = view_from(world, [0, 0, 0], [0, 0, 1.5])
    gt_rpy, gt_t = [0.02, -0.03, 0.5], [2.0, 1.0, 1.4]
    src = view_from(world, gt_rpy, gt_t)
    T_gt = np.linalg.inv(_T([0, 0, 0], [0, 0, 1.5])) @ _T(gt_rpy, gt_t)
    return world, tgt, src, T_gt


LICA_CFG = jml.MultiLicaConfig(capacity=8192, knn_table=8192, max_corr=512)


@pytest.fixture(scope="module")
def lica_runs(scene):
    """``MultiLidarCalibrator.standard_calibration`` of the source onto the
    target in each package (calibrate_pair, its retry through
    auto_calibrate where the coarse stage starves), with msst_tpu's draws
    (PRNGKey(0), calibrate_pair's own key) in the port."""
    _, tgt, src, _ = scene
    want = jml.MultiLidarCalibrator(LICA_CFG).standard_calibration(tgt, [src])
    mp = pytest.MonkeyPatch()
    use_jax_draws(mp, jax.random.split(jax.random.PRNGKey(0)))
    try:
        cal = tml.MultiLidarCalibrator(convert.config_from(LICA_CFG),
                                       device="cpu")
        got = cal.standard_calibration(tgt, [src])
    finally:
        mp.undo()
    return want, got, cal


def test_standard_calibration(scene, lica_runs):
    _, _, _, T_gt = scene
    want, got, _ = lica_runs
    assert len(got) == 1
    _assert_pose_near(want[0].pose, got[0].pose, T_gt)
    assert abs(float(got[0].fitness) - float(want[0].fitness)) < 1e-3
    assert float(got[0].fitness) > 0.7


def test_save_results(scene, lica_runs, tmp_path):
    _, tgt, src, _ = scene
    _, got, cal = lica_runs
    cal.save_results(str(tmp_path), got, [src], tgt, names=["side"])
    text = (tmp_path / "results.txt").read_text()
    assert text.startswith("[side]\nfitness: ")
    rows = [list(map(float, line.split())) for line in
            text.splitlines()[3:7]]
    np.testing.assert_allclose(rows, N(got[0].pose.to_matrix()), atol=1e-6)
    stitched = jio.read_pcd(str(tmp_path / "stitched.pcd"))["xyz"]
    assert len(stitched) == len(tgt) + len(src)
    np.testing.assert_array_equal(stitched[:len(tgt)], tgt)


def test_prep_and_fine_stage(scene):
    """The prep stage's cloud and covariances, and the fine stage (GICP)
    from msst_tpu's own prep outputs and coarse pose: the same pose, fitness
    and iteration count."""
    _, tgt, src, _ = scene
    cfg = convert.config_from(LICA_CFG)
    s_j = jml._prep_stage(J(src), J(np.ones(len(src), bool)), LICA_CFG)
    t_j = jml._prep_stage(J(tgt), J(np.ones(len(tgt), bool)), LICA_CFG)
    s_t = tml._prep_stage(T(src), T(np.ones(len(src), bool)), cfg)
    np.testing.assert_array_equal(N(s_t[0].mask), N(s_j[0].mask))
    m = N(s_j[0].mask)
    np.testing.assert_allclose(N(s_t[0].xyz)[m], N(s_j[0].xyz)[m], atol=1e-5)
    co = jml._coarse_stage(s_j[0], t_j[0], s_j[2], t_j[2], LICA_CFG)

    def run_jax(max_iters):
        return jml._fine_stage(s_j[0], s_j[3], t_j[1], t_j[0], t_j[3],
                               co.pose, dataclasses.replace(
                                   LICA_CFG, gicp_max_iters=max_iters))

    want = run_jax(LICA_CFG.gicp_max_iters)
    ts, tt = ([convert.from_numpy(jax.tree.map(np.asarray, v), "cpu")
               for v in x] for x in (s_j, t_j))
    got = tml._fine_stage(ts[0], ts[3], tt[1], tt[0], tt[3],
                          convert.from_numpy(jax.tree.map(np.asarray,
                                                          co.pose), "cpu"),
                          cfg)
    assert_pose_close(want.pose, got.pose)
    assert float(got.matched_frac) == float(want.matched_frac)
    assert _iters_of_jax(run_jax, int(got.iters))


def test_calibrate_to_ground(scene, monkeypatch):
    world = scene[0]
    src = view_from(world, [0.05, -0.08, 0.0], [0, 0, 1.8])
    key = jax.random.PRNGKey(0)
    want = jml.calibrate_to_ground(J(src), J(np.ones(len(src), bool)),
                                   LICA_CFG, key)
    use_jax_draws(monkeypatch, [key])
    got = tml.calibrate_to_ground(T(src), T(np.ones(len(src), bool)),
                                  convert.config_from(LICA_CFG))
    assert_pose_close(want, got)
    moved = N(got.apply(T(src)))
    ground = moved[np.abs(moved[:, 2]) < 1.0]
    assert abs(np.median(ground[:, 2])) < 0.05


AUTO_CFG = jac.AutoCalibConfig(knn_table=8192)


@pytest.fixture(scope="module")
def auto_case(scene):
    world = scene[0]
    master = view_from(world, [0, 0, 0], [0, 0, 1.5])
    gt_rpy, gt_t = [0.01, 0.02, 0.8], [1.5, -1.0, 1.6]
    slave = view_from(world, gt_rpy, gt_t)
    T_gt = np.linalg.inv(_T([0, 0, 0], [0, 0, 1.5])) @ _T(gt_rpy, gt_t)
    lever = (T_gt[:3, 3] + [0.1, -0.1, 0.05]).astype(np.float32)
    ones = np.ones(len(master), bool)
    return master, slave, ones, T_gt, lever


def test_auto_calibrate(auto_case, monkeypatch):
    master, slave, ones, T_gt, lever = auto_case
    key = jax.random.PRNGKey(1)
    want = jac.auto_calibrate(J(master), J(ones), J(slave), J(ones), AUTO_CFG,
                              key, init_pose=jse3.Pose.from_rpy_xyz(
                                  jnp.zeros(3), J(lever)))
    use_jax_draws(monkeypatch, jax.random.split(key))
    got = tac.auto_calibrate(T(master), T(ones), T(slave), T(ones),
                             convert.config_from(AUTO_CFG), None,
                             init_pose=tse3.Pose.from_rpy_xyz(torch.zeros(3),
                                                              T(lever)))
    _assert_pose_near(want.pose, got.pose, T_gt)
    assert bool(got.ground_ok) == bool(want.ground_ok)
    np.testing.assert_allclose(float(got.yaw_cost), float(want.yaw_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got.icp_rmse), float(want.icp_rmse),
                               atol=1e-4)


def _jax_yaw_costs(grid, s_lev, s_ng, nm, yaws, cfg):
    """msst_tpu's per-yaw cost (auto_calib.py:112-124), one yaw at a time."""
    def one(yaw):
        moved = jse3.quat_rotate(jse3.so3_exp_quat(nm * yaw), s_lev)
        res = jknn.query(grid, moved, s_ng, k=1,
                         candidates_per_cell=cfg.nn_candidates, max_sqdist=4.0)
        d = jnp.where(res.valid[:, 0], jnp.sqrt(res.sqdist[:, 0]), 2.0)
        return jnp.sum(jnp.where(s_ng, d, 0.0))
    return np.asarray(jax.lax.map(one, yaws))


def test_yaw_search_cost_vectors(auto_case, monkeypatch):
    """The 72 coarse and 64 fine yaw costs (not only the chosen bins): the
    same per-yaw sums to 1e-5 relative (float32 sums of ~8000 distances in
    another order), and the same argmin."""
    master, slave, ones, _, lever = auto_case
    key = jax.random.PRNGKey(1)
    mask = ones & (np.linalg.norm(master[:, :2], axis=1) > AUTO_CFG.ego_radius)
    smask = ones & (np.linalg.norm(slave[:, :2], axis=1) > AUTO_CFG.ego_radius)
    init = jse3.Pose.from_rpy_xyz(jnp.zeros(3), J(lever))
    s_in = init.apply(J(slave))
    base, nm, _, _, m_g, s_g = jac._ground_align(J(master), J(mask), s_in,
                                                 J(smask), AUTO_CFG, key)
    s_lev = base.apply(s_in)
    m_ng, s_ng = J(mask) & ~m_g, J(smask) & ~s_g
    grid = jknn.build(J(master), m_ng, 2.0, AUTO_CFG.knn_table)
    coarse = jnp.linspace(-jnp.pi, jnp.pi, 72, endpoint=False)
    want_c = _jax_yaw_costs(grid, s_lev, s_ng, nm, coarse, AUTO_CFG)
    fine = coarse[np.argmin(want_c)] + jnp.linspace(-jnp.radians(5.0),
                                                    jnp.radians(5.0), 64)
    want_f = _jax_yaw_costs(grid, s_lev, s_ng, nm, fine, AUTO_CFG)

    use_jax_draws(monkeypatch, jax.random.split(key))
    tinit = tse3.Pose.from_rpy_xyz(torch.zeros(3), T(lever))
    ts_in = tinit.apply(T(slave))
    tbase, tnm, _, _, tm_g, ts_g = tac._ground_align(
        T(master), T(mask), ts_in, T(smask), convert.config_from(AUTO_CFG),
        None)
    np.testing.assert_array_equal(N(ts_g), np.asarray(s_g))
    tgrid = convert.from_numpy(jax.tree.map(np.asarray, grid), "cpu")
    ts_lev, tng = tbase.apply(ts_in), T(smask) & ~ts_g
    pi = torch.tensor(np.pi, dtype=torch.float32)
    tcoarse = tac.linspace_f32(-pi, pi, 72, endpoint=False)
    # 1 ULP: XLA contracts linspace's a * (1 - s) + b * s into an FMA
    np.testing.assert_allclose(N(tcoarse), np.asarray(coarse), atol=1e-6)
    got_c = N(tac.yaw_costs(tgrid, ts_lev, tng, tnm, tcoarse, 16))
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    assert np.argmin(got_c) == np.argmin(want_c)
    half = torch.tensor(np.radians(5.0), dtype=torch.float32)
    tfine = tcoarse[int(np.argmin(got_c))] + tac.linspace_f32(-half, half, 64)
    np.testing.assert_allclose(N(tfine), np.asarray(fine), atol=1e-6)
    got_f = N(tac.yaw_costs(tgrid, ts_lev, tng, tnm, tfine, 16))
    np.testing.assert_allclose(got_f, want_f, rtol=1e-5)
    assert np.argmin(got_f) == np.argmin(want_f)


def test_voxel_occupancy(auto_case):
    master, slave, ones, T_gt, _ = auto_case
    jp = jse3.Pose.from_matrix(J(T_gt.astype(np.float32)))
    tp = tse3.Pose(T(N(jp.q)), T(N(jp.t)))
    for dx in (0.0, 0.3):
        jq = jse3.Pose(jp.q, jp.t + dx)
        tq = tse3.Pose(tp.q, tp.t + dx)
        assert float(tac.voxel_occupancy_score(
            T(master), T(ones), T(slave), T(ones), tq)) == float(
            jac.voxel_occupancy_score(J(master), J(ones), J(slave), J(ones),
                                      jq))
    off = jse3.Pose(jp.q, jp.t + jnp.array([0.12, -0.08, 0.05]))
    want = jac.refine_by_voxel_occupancy(J(master), J(ones), J(slave),
                                         J(ones), off)
    got = tac.refine_by_voxel_occupancy(T(master), T(ones), T(slave), T(ones),
                                        tse3.Pose(T(N(off.q)), T(N(off.t))))
    np.testing.assert_allclose(N(got.t), N(want.t), atol=1e-6)


NDT_CFG = jnd.NdtCalibConfig(map_capacity=4096, child_capacity=8192)


@pytest.fixture(scope="module")
def ndt_pair(scene):
    world = scene[0]
    parent = view_from(world, [0, 0, 0], [0, 0, 1.5])
    child = view_from(world, [0.0, 0.0, 0.1], [0.5, 0.3, 1.5])
    T_gt = np.linalg.inv(_T([0, 0, 0], [0, 0, 1.5])) @ _T([0, 0, 0.1],
                                                          [0.5, 0.3, 1.5])
    return parent, child, T_gt


NDT_POSE_ATOL = 5e-5


def test_ndt_calibrator_three_frames(ndt_pair):
    """Three frames, each from the last one's pose: poses to NDT_POSE_ATOL
    (5e-5; the NDT maps' moments are summed in another order, which moves
    a few voxels' inverse covariances by 1e-3, see test_torch_calib_ops)."""
    parent, child, T_gt = ndt_pair
    jc = jnd.NdtCalibrator(NDT_CFG)
    tc = tnd.NdtCalibrator(convert.config_from(NDT_CFG), device="cpu")
    for _ in range(3):
        a = jc.process_pair(parent, child)
        b = tc.process_pair(parent, child)
        assert_pose_close(a.pose, b.pose, NDT_POSE_ATOL)
        assert bool(a.converged) == bool(b.converged)
    np.testing.assert_allclose(tc.history, jc.history, atol=1e-5)
    _assert_pose_near(jc.pose, tc.pose, T_gt)
    want = jc.static_transform_command().split()
    got = tc.static_transform_command().split()
    assert got[:3] == want[:3] and got[9:] == want[9:]
    np.testing.assert_allclose([float(v) for v in got[3:9]],
                               [float(v) for v in want[3:9]], atol=2e-4)


def test_ndt_frame_iterations_and_carried_state(ndt_pair):
    """The first frame's NDT iteration count, and a calibrator carried over
    from msst_tpu after one frame going on exactly as msst_tpu's does."""
    parent, child, _ = ndt_pair
    jc = jnd.NdtCalibrator(NDT_CFG)
    jc.process_pair(parent, child)
    tc = convert.ndt_calibrator_from(jc, "cpu")
    assert tc.cfg == convert.config_from(NDT_CFG) and tc.history == jc.history
    a = jc.process_pair(parent, child)
    b = tc.process_pair(parent, child)
    assert_pose_close(a.pose, b.pose, NDT_POSE_ATOL)

    def pad(x):
        out = np.zeros((8192, 3), np.float32)
        out[:len(x)] = x
        return out, np.arange(8192) < len(x)

    (px, pm), (cx, cm) = pad(parent), pad(child)

    def run_jax(n):
        return jnd.ndt_calibrate_frame(J(px), J(pm), J(cx), J(cm),
                                       jse3.Pose.identity(),
                                       jnd.NdtCalibConfig(
                                           map_capacity=4096,
                                           child_capacity=8192, max_iters=n))

    got = tnd.ndt_calibrate_frame(T(px), T(pm), T(cx), T(cm),
                                  tse3.Pose.identity(),
                                  convert.config_from(NDT_CFG))
    assert_pose_close(run_jax(35).pose, got.pose, NDT_POSE_ATOL)
    assert 1 < int(got.iters) < 35 and _iters_of_jax(run_jax, int(got.iters))


def _imu_rows(n, dt, seed):
    """t, gyro (3, zero-mean white noise + random-walk bias), acc (3,
    small offsets): axes where a float32 Allan estimate keeps its
    precision (see test_torch_calib_ops.py's Allan test)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * dt
    gyro = 2e-3 * rng.normal(size=(n, 3)) + np.cumsum(
        rng.normal(scale=1e-6, size=(n, 3)), axis=0)
    acc = 0.02 * rng.normal(size=(n, 3)) + np.cumsum(
        rng.normal(scale=1e-5, size=(n, 3)), axis=0)
    return t, gyro, acc


def test_allan_calibrator_200k(tmp_path):
    t, gyro, acc = _imu_rows(200_000, 0.005, 60)
    jc, tc = jallan.AllanCalibrator(name="x"), tallan.AllanCalibrator(
        name="x", device="cpu")
    for i in range(len(t)):
        jc.add_sample(t[i], gyro[i], acc[i])
        tc.add_sample(t[i], gyro[i], acc[i])
    want = jc.write_yaml(str(tmp_path / "j.yaml"))
    got = tc.write_yaml(str(tmp_path / "t.yaml"))
    for key in ("gyr_n", "gyr_w", "acc_n", "acc_w"):
        # 2e-3 relative: the float32 Allan variances agree to ~1e-4 (see
        # test_torch_calib_ops.py), and the badly scaled 5-term fit of the
        # white-noise coefficient magnifies that ~10 times
        np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                   err_msg=key)
    assert got["duration_min"] == want["duration_min"]
    np.testing.assert_array_equal(got["gyr_axes"][0]["taus"],
                                  want["gyr_axes"][0]["taus"])
    jl = (tmp_path / "j.yaml").read_text().splitlines()
    tl = (tmp_path / "t.yaml").read_text().splitlines()
    assert len(jl) == len(tl) == 14
    assert [line.split(":")[0] for line in tl] == [
        line.split(":")[0] for line in jl]


def test_manual_calibrator(scene, tmp_path):
    _, tgt, src, T_gt = scene
    init = jse3.Pose.from_matrix(J(T_gt.astype(np.float32)))
    jm = jman.ManualCalibrator(src, tgt, init_pose=init)
    tm = tman.ManualCalibrator(src, tgt, init_pose=tse3.Pose(T(N(init.q)),
                                                             T(N(init.t))),
                               device="cpu")
    np.testing.assert_allclose(tm.score(), jm.score(), rtol=1e-5)
    for key in "qwertyujahsdfg":
        assert tm.nudge(key) == jm.nudge(key)
    assert tm.nudge("z") is jm.nudge("z") is False
    assert tm.rot_step == jm.rot_step and tm.trans_step == jm.trans_step
    np.testing.assert_allclose(N(tm.pose.to_matrix()),
                               N(jm.pose.to_matrix()), atol=1e-6)
    np.testing.assert_allclose(tm.score(), jm.score(), rtol=1e-5)
    a = json.loads(jm.extrinsic_json())["extrinsic"]
    tm.save(str(tmp_path / "e.json"))
    b = json.loads((tmp_path / "e.json").read_text())["extrinsic"]
    for k in ("rotation", "translation", "matrix"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-6)


def test_evaluation_and_urdf(tmp_path):
    rpy = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.1], [0.1, -0.2, 0.3]]
    xyz = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.5, 0.2, -0.1]]
    est_xyz = [[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.5, 0.25, -0.1]]
    jg = [jse3.Pose.from_rpy_xyz(J(r), J(x)) for r, x in zip(rpy, xyz)]
    je = [jse3.Pose.from_rpy_xyz(J(r), J(x)) for r, x in zip(rpy, est_xyz)]
    tg = [tse3.Pose.from_rpy_xyz(T(r).float(), T(x).float())
          for r, x in zip(rpy, xyz)]
    te = [tse3.Pose.from_rpy_xyz(T(r).float(), T(x).float())
          for r, x in zip(rpy, est_xyz)]
    a, b = jev.calibration_rmse(je, jg), tev.calibration_rmse(te, tg)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5)
    a = jev.relative_calibration_rmse(je, jg)
    b = tev.relative_calibration_rmse(te, tg)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5)
    urdf = tmp_path / "r.urdf"
    urdf.write_text('<robot name="r"><joint name="lidar_2" type="fixed">'
                    '<origin xyz="0 0 0" rpy="0 0 0"/></joint>'
                    '<joint name="lidar_3" type="fixed"/></robot>')
    jurdf.write_calibrated_urdf(str(urdf), {"lidar_2": je[1],
                                            "lidar_3": je[2]},
                                str(tmp_path / "j.urdf"))
    turdf.write_calibrated_urdf(str(urdf), {"lidar_2": te[1],
                                            "lidar_3": te[2]},
                                str(tmp_path / "t.urdf"))
    assert (tmp_path / "t.urdf").read_text() == (tmp_path / "j.urdf").read_text()
    with pytest.raises(KeyError):
        turdf.modify_urdf_joint_origin(str(urdf), "nope", te[1])


@pytest.mark.parametrize("binary", [True, False])
def test_read_pcd(tmp_path, binary):
    rng = np.random.default_rng(70)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    inten = rng.random(300).astype(np.float32)
    path = str(tmp_path / "c.pcd")
    jio.write_pcd(path, xyz, inten, binary=binary)
    want, got = jio.read_pcd(path), tio.read_pcd(path)
    np.testing.assert_array_equal(got["xyz"], want["xyz"])
    assert sorted(got["fields"]) == sorted(want["fields"]) == [
        "intensity", "x", "y", "z"]
    np.testing.assert_array_equal(got["fields"]["intensity"],
                                  want["fields"]["intensity"])


def test_calibrator_classes_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((10, 3), np.float32)
    for make in (lambda: tml.MultiLidarCalibrator(),
                 lambda: tnd.NdtCalibrator(),
                 lambda: tallan.AllanCalibrator(),
                 lambda: tman.ManualCalibrator(pts, pts)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_fitness_based_calibration_order(monkeypatch):
    """The greedy best-fitness merge order of both packages, with
    calibrate_pair replaced in each by the same stub (its fitness and
    pose from the source's point count), so that only the orchestration
    is compared."""
    def stub(pose_cls, result_cls, asarray):
        def calibrate_pair(s_x, s_m, c_x, c_m, cfg):
            n = int(N(s_m).sum())
            fit = {100: 0.5, 200: 0.9, 300: 0.7}[n]
            pose = pose_cls(asarray(np.array([1.0, 0, 0, 0], np.float32)),
                            asarray(np.array([n / 100.0, 0, 0], np.float32)))
            return result_cls(pose, asarray(np.float32(fit)),
                              asarray(np.float32(0.1)), asarray(np.int32(0)))
        return calibrate_pair

    monkeypatch.setattr(jml, "calibrate_pair",
                        stub(jse3.Pose, jml.PairResult, J))
    monkeypatch.setattr(tml, "calibrate_pair",
                        stub(tse3.Pose, tml.PairResult, T))
    rng = np.random.default_rng(90)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32)
              for n in (50, 100, 200, 300)]
    cfg = jml.MultiLicaConfig(capacity=1024)
    jp, jf = jml.MultiLidarCalibrator(cfg).fitness_based_calibration(clouds)
    tp, tf = tml.MultiLidarCalibrator(
        convert.config_from(cfg), device="cpu").fitness_based_calibration(
        clouds)
    assert list(tf) == list(jf) == [0, 2, 3, 1] and tf == jf
    for i in jp:
        np.testing.assert_array_equal(N(tp[i].t), N(jp[i].t))
