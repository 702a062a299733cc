"""The port's frontend and IMU layer against msst_tpu on simulator scans:
voxel downsampling, range image, LOAM NMS features, run_frontend,
preintegration and the ESKF.

Tolerances: discrete outputs (masks, counts, survivor sets, pixel
assignment) must be equal.  Coordinates agree to 1e-4 m: msst_tpu sums a
voxel's members as differences of prefix sums over the whole sorted cloud
(rounding relative to the prefix), the port sums them directly, so
centroids differ by ~1e-5 m.  IMU quantities agree to float32 rounding of
differently ordered scans (1e-5 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from msst_torch import convert
from msst_torch.models.liosam import frontend as tfront
from msst_torch.models.liosam import imu_fusion as tfusion
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.models.liosam.pipeline import LioSam as TLioSam
from msst_torch.ops import features as tfeat
from msst_torch.ops import imu as timu
from msst_torch.ops import range_image as tri
from msst_torch.ops import se3 as tse3
from msst_torch.ops import voxel as tvoxel
from msst_torch.ops.pointcloud import Cloud as TCloud
from msst_tpu.models.liosam import frontend as jfront
from msst_tpu.models.liosam import imu_fusion as jfusion
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.ops import features as jfeat
from msst_tpu.ops import imu as jimu
from msst_tpu.ops import range_image as jri
from msst_tpu.ops import se3 as jse3
from msst_tpu.ops import voxel as jvoxel
from msst_tpu.ops.pointcloud import Cloud as JCloud
from msst_tpu.utils import sim

RNG = np.random.default_rng(21)


@pytest.fixture(scope="module")
def scans():
    """Packed step inputs of three moving sim scans (tiny profile)."""
    data = sim.make_dataset(sim.World(), sim.SimTrajectory(kind="circle"),
                            n_scans=3, scan_dt=0.1, n_scan=16, horizon=360,
                            seed=3)
    packer = TLioSam(ttiny(loop_closure_enabled=False), device="cpu")
    out = []
    for s in data:
        out.append(packer._make_input_np(
            s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
            imu_t=s["imu_t"], imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
            imu_rpy=s["imu_rpy"]))
        packer._last_scan_time = float(s["scan_start"])
    return out


def _inputs(packed):
    pts, aux = packed
    jinp = jmap.unpack_step_input(jnp.asarray(pts), jnp.asarray(aux),
                                  jtiny())
    tinp = tmap.unpack_step_input(torch.from_numpy(pts),
                                  torch.from_numpy(aux), ttiny())
    return jinp, tinp


def _same_point_sets(a, b, atol=1e-4):
    """Row sets equal up to order: a one-to-one nearest-neighbour matching
    within atol."""
    assert a.shape == b.shape
    if len(a) == 0:
        return
    d, idx = cKDTree(a[:, :3]).query(b[:, :3])
    assert np.max(d) < atol, np.max(d)
    assert len(np.unique(idx)) == len(idx)
    np.testing.assert_allclose(b, a[idx], atol=atol)


def _cloud_rows(xyz, mask, attrs):
    xyz, mask, attrs = (np.asarray(x) for x in (xyz, mask, attrs))
    return np.concatenate([xyz, attrs], axis=1)[mask]


# ---------------------------------------------------------------------------
# voxel downsample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "ring_key", "overflow_hash",
                                  "overflow_no_hash"])
def test_voxel_downsample_matches_jax(scans, case):
    """Survivor set and centroids (+ carried attrs) order-free; the overflow
    cases keep only `capacity` voxels, so the survivor SET checks the hash
    (or packed-key) ordering bit for bit."""
    jinp, tinp = _inputs(scans[1])
    xyz = np.asarray(jinp.scan.xyz)
    mask = np.asarray(jinp.scan.mask)
    attrs = np.asarray(jinp.scan.time)[:, None]
    ring = np.asarray(jinp.scan.ring)
    kw = {}
    if case == "ring_key":
        kw = dict(extra_key=ring)
    elif case == "overflow_hash":
        kw = dict(extra_key=ring, capacity=700)
    elif case == "overflow_no_hash":
        kw = dict(capacity=700, uniform_overflow=False)
    leaf = 0.4
    jc = jvoxel.voxel_downsample(
        JCloud(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(attrs)), leaf,
        **{k: jnp.asarray(v) if k == "extra_key" else v for k, v in kw.items()})
    tc = tvoxel.voxel_downsample(
        TCloud(torch.from_numpy(xyz), torch.from_numpy(mask),
               torch.from_numpy(attrs)), leaf,
        **{k: torch.from_numpy(v) if k == "extra_key" else v
           for k, v in kw.items()})
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    _same_point_sets(_cloud_rows(*jc), _cloud_rows(*tc))
    if case.startswith("overflow"):
        # same survivors in the same order (the sort order decides them)
        m = np.asarray(jc.mask)
        np.testing.assert_allclose(tc.xyz.numpy()[m], np.asarray(jc.xyz)[m],
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# range image, rings, features
# ---------------------------------------------------------------------------


def _deskewed(jinp, tinp):
    jw = jri.ImuWindow(jinp.scan.imu_t, jinp.scan.imu_gyro, jinp.scan.imu_acc,
                       jinp.scan.imu_mask)
    tw = tri.ImuWindow(tinp.scan.imu_t, tinp.scan.imu_gyro, tinp.scan.imu_acc,
                       tinp.scan.imu_mask)
    jt, jr = jri.imu_rotation_timeline(jw)
    tt, tr = tri.imu_rotation_timeline(tw)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    n = jnp.sum(jinp.scan.imu_mask.astype(jnp.int32))
    jd = jri.deskew(jinp.scan.xyz, jinp.scan.scan_start + jinp.scan.time, jt,
                    jr, n, t_start=jinp.scan.scan_start, enabled=True)
    td = tri.deskew(tinp.scan.xyz, tinp.scan.scan_start + tinp.scan.time, tt,
                    tr, torch.tensor(int(n)), t_start=tinp.scan.scan_start,
                    enabled=torch.tensor(True))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    return jd, td


def test_deskew_project_extract_match_jax(scans):
    """Deskew to 1e-4 m; range image and packed rings: same valid pixels,
    same columns and counts, ranges/points to 1e-4 m."""
    p = jtiny()
    jinp, tinp = _inputs(scans[2])
    jd, td = _deskewed(jinp, tinp)
    jimg = jri.project(JCloud.create(jd, jinp.scan.mask), jinp.scan.ring,
                       p.n_scan, p.horizon_scan, p.lidar_min_range,
                       p.lidar_max_range)
    timg = tri.project(TCloud.create(td, tinp.scan.mask), tinp.scan.ring,
                       p.n_scan, p.horizon_scan, p.lidar_min_range,
                       p.lidar_max_range)
    np.testing.assert_array_equal(timg.valid.numpy(), np.asarray(jimg.valid))
    v = np.asarray(jimg.valid)
    np.testing.assert_allclose(timg.rng.numpy()[v], np.asarray(jimg.rng)[v],
                               atol=1e-4)
    jext, text = jri.extract_rings(jimg), tri.extract_rings(timg)
    np.testing.assert_array_equal(text.count.numpy(), np.asarray(jext.count))
    np.testing.assert_array_equal(text.col.numpy(), np.asarray(jext.col))
    np.testing.assert_allclose(text.xyz.numpy(), np.asarray(jext.xyz), atol=1e-4)


@pytest.mark.parametrize("livox", [False, True])
def test_project_counter_columns_match_jax(livox):
    """Random clouds: azimuth columns, and the livox per-ring counters."""
    n = 3000
    xyz = RNG.normal(size=(n, 3)).astype(np.float32) * 10
    ring = RNG.integers(-1, 17, size=n).astype(np.int32)
    mode = "counter" if livox else "azimuth"
    jimg = jri.project(JCloud.create(jnp.asarray(xyz)), jnp.asarray(ring), 16,
                       360, 1.0, 100.0, column_mode=mode)
    timg = tri.project(TCloud.create(torch.from_numpy(xyz)),
                       torch.from_numpy(ring), 16, 360, 1.0, 100.0,
                       column_mode=mode)
    np.testing.assert_array_equal(timg.valid.numpy(), np.asarray(jimg.valid))
    np.testing.assert_array_equal(timg.xyz.numpy(), np.asarray(jimg.xyz))


def test_features_nms_masks_match_jax(scans):
    """Corner and surface masks equal on the packed rings of a sim scan."""
    p = jtiny()
    jinp, tinp = _inputs(scans[0])
    jd, td = _deskewed(jinp, tinp)
    jext = jri.extract_rings(jri.project(
        JCloud.create(jd, jinp.scan.mask), jinp.scan.ring, p.n_scan,
        p.horizon_scan, p.lidar_min_range, p.lidar_max_range))
    # the port's feature pass on msst_tpu's exact rings isolates the features
    text = tri.ExtractedScan(*(torch.from_numpy(np.asarray(x)) for x in jext))
    jm = jfeat.extract_features_nms(jext, p.edge_threshold, p.surf_threshold)
    tm = tfeat.extract_features_nms(text, p.edge_threshold, p.surf_threshold)
    np.testing.assert_array_equal(tm.corner.numpy(), np.asarray(jm.corner))
    np.testing.assert_array_equal(tm.surface.numpy(), np.asarray(jm.surface))
    assert 0 < int(tm.corner.sum()) < int(tm.surface.sum())


def test_run_frontend_matches_jax(scans):
    """Feature counts equal; corner cloud in the same order; surface cloud
    (per-ring downsampled) as an order-free set; both carry the firing
    offset attr."""
    p_j, p_t = jtiny(), ttiny()
    for packed in scans:
        jinp, tinp = _inputs(packed)
        jo = jax.jit(lambda s: jfront.run_frontend(s, p_j, carry_time=True))(
            jinp.scan)
        to = tfront.run_frontend(tinp.scan, p_t)
        assert int(to.n_corner) == int(jo.n_corner)
        assert int(to.n_surf) == int(jo.n_surf)
        np.testing.assert_allclose(_cloud_rows(*to.corner),
                                   _cloud_rows(*jo.corner), atol=1e-4)
        _same_point_sets(_cloud_rows(*jo.surf), _cloud_rows(*to.surf))


def test_prepare_scan_matches_jax(scans):
    """The mapping-leaf downsampled features and the zero-bias
    preintegration of prepare_scan."""
    p_j, p_t = jtiny(), ttiny()
    jinp, tinp = _inputs(scans[2])
    a = jax.tree.map(np.asarray, jax.jit(lambda i: jmap.prepare_scan(i, p_j))(jinp))
    b = convert.to_numpy(tmap.prepare_scan(tinp, p_t))
    for name in ("corner", "surf"):
        m = getattr(a, name + "_mask")
        np.testing.assert_array_equal(getattr(b, name + "_mask"), m)
        rows = lambda s: np.concatenate([getattr(s, name + "_xyz"),  # noqa: E731
                                         getattr(s, name + "_dt")[:, None]], 1)[m]
        _same_point_sets(rows(a), rows(b))
    for f in ("n_corner", "n_surf", "deskew_on", "f_ok", "imu_available"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_allclose(b.f_mean, a.f_mean, atol=1e-5)


# ---------------------------------------------------------------------------
# IMU preintegration and the ESKF
# ---------------------------------------------------------------------------


def _imu_window(T=48, n_valid=40):
    t = np.cumsum(np.full(T, 0.005, np.float32)) + 3.0
    gyro = (RNG.normal(size=(T, 3)) * 0.3).astype(np.float32)
    acc = (RNG.normal(size=(T, 3)) * 0.5 + [0.0, 0.0, 9.8]).astype(np.float32)
    mask = np.arange(T) < n_valid
    return t, gyro, acc, mask


@pytest.mark.parametrize("reference", ["preintegrate", "preintegrate_sequential"])
def test_preintegrate_matches_jax(reference):
    """All fields against msst_tpu's log-depth and sequential forms, with a
    non-zero bias (1e-5 relative: differently ordered float32 scans)."""
    t, gyro, acc, mask = _imu_window()
    bias = (np.array([0.01, -0.02, 0.005], np.float32),
            np.array([0.05, 0.02, -0.03], np.float32))
    jp = jtiny().imu_params
    want = getattr(jimu, reference)(
        *(jnp.asarray(x) for x in (t, gyro, acc, mask)),
        jimu.ImuBias(*(jnp.asarray(b) for b in bias)), jp)
    got = timu.preintegrate(*(torch.from_numpy(x) for x in (t, gyro, acc, mask)),
                            timu.ImuBias(*(torch.from_numpy(b) for b in bias)),
                            ttiny().imu_params)
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        scale = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g / scale, w / scale, atol=2e-5, err_msg=f)


def _filter_pair():
    """A propagated filter state as numpy leaves of msst_tpu's FilterState."""
    t, gyro, acc, mask = _imu_window()
    pre = jimu.preintegrate(*(jnp.asarray(x) for x in (t, gyro, acc, mask)),
                            jimu.ImuBias.zero(), jtiny().imu_params)
    pose = jse3.Pose.from_vec6(jnp.asarray([0.1, -0.05, 1.2, 3.0, -1.0, 1.5]))
    fs = jfusion.FilterState.initial(pose, velocity=jnp.asarray([1.0, 0.5, 0.0]))
    fs = fs._replace(bias=jimu.ImuBias(jnp.asarray([0.01, 0.0, -0.01]),
                                       jnp.asarray([0.02, -0.01, 0.0])))
    return jax.tree.map(np.asarray, fs), jax.tree.map(np.asarray, pre)


def _assert_filter_close(got, want, atol=1e-5):
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(convert.to_numpy(got))):
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g / scale, w / scale, atol=atol)


def test_propagate_matches_jax():
    fs, pre = _filter_pair()
    p = jtiny().imu_params
    want = jfusion.propagate(jax.tree.map(jnp.asarray, fs),
                             jax.tree.map(jnp.asarray, pre), p,
                             bias_ref=jimu.ImuBias.zero())
    tpre = timu.Preintegrated(*(torch.from_numpy(np.array(x)) for x in pre))
    got = tfusion.propagate(convert.from_numpy(fs, "cpu"), tpre,
                            ttiny().imu_params, bias_ref=timu.ImuBias.zero())
    _assert_filter_close(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("degenerate", [False, True])
def test_update_with_pose_matches_jax(degenerate):
    fs, _ = _filter_pair()
    meas6 = np.array([0.12, -0.04, 1.19, 3.1, -0.9, 1.45], np.float32)
    want = jfusion.update_with_pose(
        jax.tree.map(jnp.asarray, fs), jse3.Pose.from_vec6(jnp.asarray(meas6)),
        0.01, 0.1, jnp.asarray(degenerate))
    got = tfusion.update_with_pose(
        convert.from_numpy(fs, "cpu"), tse3.Pose.from_vec6(torch.from_numpy(meas6)),
        0.01, 0.1, torch.tensor(degenerate))
    _assert_filter_close(got, jax.tree.map(np.asarray, want))
    assert not bool(tfusion.reset_needed(got))


def test_update_with_position_matches_jax_and_oracle():
    """Against msst_tpu, and against the closed form: with a tight fix the
    position moves onto the measurement and the position covariance
    shrinks below the measurement variance."""
    fs, _ = _filter_pair()
    pos = np.array([3.4, -1.2, 1.6], np.float32)
    sig = np.array([0.5, 0.5, 1e3], np.float32)
    want = jfusion.update_with_position(jax.tree.map(jnp.asarray, fs),
                                        jnp.asarray(pos), jnp.asarray(sig))
    got = tfusion.update_with_position(convert.from_numpy(fs, "cpu"),
                                       torch.from_numpy(pos), torch.from_numpy(sig))
    _assert_filter_close(got, jax.tree.map(np.asarray, want))
    tight = tfusion.update_with_position(convert.from_numpy(fs, "cpu"),
                                         torch.from_numpy(pos),
                                         torch.full((3,), 1e-3))
    np.testing.assert_allclose(tight.nav.p.numpy(), pos, atol=1e-3)
    assert float(torch.trace(tight.cov[6:9, 6:9])) < 3 * 1e-6 * 1.01
