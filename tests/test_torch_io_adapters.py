"""The port's own copies of msst_tpu's numpy host adapters, each held
against msst_tpu's on the same inputs, made from a numpy seed: the IMU
adapter, the KITTI raw reader (with and without GPS, with and without an
IMU-to-velodyne calibration), the KITTI metrics, the sensor formats, the
rosbag reader (Velodyne, Ouster and Livox clouds, a bz2 chunk), the map
exports and viewer, the decoder-calibration files, and the sensor-side
helpers (stream sync, navsat alignment, GPS time, laser scan).  All of it
is numpy on both sides, so "against" means equal: arrays bit for bit,
scalars and dicts exactly.  chip_smoke.py's writers of phase 13 (the
synthetic KITTI drive, the Ouster bag) are exercised here at small sizes.
"""

import bz2
import os
import struct
import warnings

import numpy as np
import pytest

import chip_smoke
from msst_torch.utils import calibration_io as t_cal
from msst_torch.utils import gpstime as t_gps
from msst_torch.utils import imu_adapter as t_imu
from msst_torch.utils import io_kitti as t_kitti
from msst_torch.utils import io_rosbag as t_bag
from msst_torch.utils import kitti_eval as t_ke
from msst_torch.utils import laserscan as t_ls
from msst_torch.utils import navsat as t_nav
from msst_torch.utils import sensor_formats as t_sf
from msst_torch.utils import sim as t_sim
from msst_torch.utils import sync as t_sync
from msst_torch.utils import viz as t_viz
from msst_torch.utils import viz_html as t_vh
from msst_tpu.utils import calibration_io as j_cal
from msst_tpu.utils import gpstime as j_gps
from msst_tpu.utils import imu_adapter as j_imu
from msst_tpu.utils import io_kitti as j_kitti
from msst_tpu.utils import io_rosbag as j_bag
from msst_tpu.utils import kitti_eval as j_ke
from msst_tpu.utils import laserscan as j_ls
from msst_tpu.utils import navsat as j_nav
from msst_tpu.utils import sensor_formats as j_sf
from msst_tpu.utils import sync as j_sync
from msst_tpu.utils import viz as j_viz
from msst_tpu.utils import viz_html as j_vh
from tests.test_io import encode_cloud, encode_imu, make_tiny_bag


def assert_same(a, b, path="value"):
    """Equal structure and values: arrays bit for bit (dtype included),
    everything else by ==."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def _rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    from scipy.spatial.transform import Rotation as Rs

    return Rs.from_quat(q).as_matrix()


# ---------------------------------------------------------------------------
# imu_adapter


@pytest.mark.parametrize("attitude", ["rpy", "quat", "none"])
def test_convert_imu_equal(attitude):
    rng = np.random.default_rng(1)
    R, Rp = _rot(rng), _rot(rng)
    gyro, acc = rng.normal(size=(50, 3)), rng.normal(size=(50, 3)) + [0, 0, 9.8]
    kw = {}
    if attitude == "rpy":
        kw["rpy"] = rng.uniform(-1, 1, size=(50, 3))
    elif attitude == "quat":
        q = rng.normal(size=(50, 4))
        kw["quat_wb"] = q / np.linalg.norm(q, axis=1, keepdims=True)
    for ext_rpy in (None, Rp):
        t = t_imu.convert_imu(t_imu.ImuExtrinsics.create(R, ext_rpy), gyro,
                              acc, **kw)
        j = j_imu.convert_imu(j_imu.ImuExtrinsics.create(R, ext_rpy), gyro,
                              acc, **kw)
        assert_same(t, j)


def test_imu_extrinsics_and_scan_dict_equal(tmp_path):
    rng = np.random.default_rng(2)
    R = _rot(rng)
    tv = rng.normal(size=3)
    calib = tmp_path / "calib_imu_to_velo.txt"
    calib.write_text("calib_time: 25-May-2012 12:00:00\nR: "
                     + " ".join(f"{v:.9f}" for v in R.ravel()) + "\nT: "
                     + " ".join(f"{v:.9f}" for v in tv) + "\n")
    te = t_imu.load_kitti_imu_extrinsics(str(calib))
    je = j_imu.load_kitti_imu_extrinsics(str(calib))
    for f in ("ext_rot", "ext_rpy", "ext_trans"):
        assert_same(getattr(te, f), getattr(je, f))
    assert te.is_identity() == je.is_identity() is False
    assert t_imu.ImuExtrinsics.identity().is_identity()
    scan = dict(xyz=np.zeros((3, 3), np.float32),
                imu_gyro=rng.normal(size=(8, 3)).astype(np.float32),
                imu_acc=rng.normal(size=(8, 3)).astype(np.float32),
                imu_rpy=rng.uniform(-1, 1, 3).astype(np.float32))
    assert_same(t_imu.convert_scan_dict(te, scan),
                j_imu.convert_scan_dict(je, scan))
    assert t_imu.convert_scan_dict(t_imu.ImuExtrinsics.identity(), scan) \
        is scan
    with pytest.raises(ValueError, match="9-axis"):
        t_imu.convert_imu(te, scan["imu_gyro"], scan["imu_acc"],
                          quat_wb=np.zeros((8, 4)))


# ---------------------------------------------------------------------------
# io_kitti


@pytest.mark.parametrize("n_rings,limits", [(64, None), (16, None),
                                            (32, (-30.0, 10.0))])
def test_rings_from_elevation_equal(n_rings, limits):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(4000, 3)).astype(np.float32) * [20, 20, 3]
    assert_same(t_kitti.rings_from_elevation(xyz, n_rings, limits),
                j_kitti.rings_from_elevation(xyz, n_rings, limits))
    lat = 48.0 + rng.normal(size=20) * 1e-3
    lon = 11.0 + rng.normal(size=20) * 1e-3
    alt = 500.0 + rng.normal(size=20)
    assert_same(t_kitti.latlon_to_enu(lat, lon, alt, 48.0, 11.0, 500.0),
                j_kitti.latlon_to_enu(lat, lon, alt, 48.0, 11.0, 500.0))


@pytest.fixture(scope="module")
def kitti_drive(tmp_path_factory):
    """A 4-sweep 16 x 360 synthetic drive (chip_smoke's writer) with an
    IMU-to-velodyne calibration beside it, and one without."""
    root = tmp_path_factory.mktemp("kitti")
    d, gt, _ = chip_smoke._write_kitti_drive(
        str(root / "a"), n_scans=4, n_rings=16, horizon=360,
        elev=(-15.0, 15.0))
    d2, _, _ = chip_smoke._write_kitti_drive(
        str(root / "b"), n_scans=4, n_rings=16, horizon=360,
        elev=(-15.0, 15.0), motion=True)
    rng = np.random.default_rng(4)
    R = _rot(rng)
    with open(os.path.join(os.path.dirname(d2), "calib_imu_to_velo.txt"),
              "w") as f:
        f.write("R: " + " ".join(f"{v:.9f}" for v in R.ravel())
                + "\nT: 0.81 -0.32 0.8\n")
    return d, d2, gt


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("with_gps", [False, True])
def test_kitti_iter_scans_equal(kitti_drive, which, with_gps):
    d = kitti_drive[which]
    t = t_kitti.KittiRawDrive(d, n_rings=16)
    j = j_kitti.KittiRawDrive(d, n_rings=16)
    assert len(t) == len(j) == 4
    ts = list(t.iter_scans(with_gps=with_gps))
    js = list(j.iter_scans(with_gps=with_gps))
    assert_same(ts, js)
    assert ("gps_xyz" in ts[0]) == with_gps
    assert_same(t.imu_samples(), j.imu_samples())
    assert_same(t.gps_enu(), j.gps_enu())
    assert_same(t.imu_extrinsics.ext_rot, j.imu_extrinsics.ext_rot)
    assert_same(t_kitti.read_velodyne_bin(t.velo_files[0]),
                j_kitti.read_velodyne_bin(j.velo_files[0]))


def test_kitti_writer_truth(kitti_drive):
    """chip_smoke's drive: the reader's GNSS track is the simulator's
    positions (about the first), its attitude at each sweep the truth's."""
    d, _, gt = kitti_drive
    drive = t_kitti.KittiRawDrive(d, n_rings=16)
    scans = list(drive.iter_scans(with_gps=True))
    for i, s in enumerate(scans):
        np.testing.assert_allclose(s["gps_xyz"], gt[i] - gt[0], atol=1e-3)
        pose = chip_smoke._bench_trajectory().pose(0.1 * i)
        yaw = np.arctan2(pose[1, 0], pose[0, 0])
        assert abs(float(s["imu_rpy"][2]) - yaw) < 1e-5
        np.testing.assert_allclose(s["gps_sigma"],
                                   chip_smoke.KITTI_POS_ACCURACY_M)
        assert len(s["xyz"]) == 16 * 360


# ---------------------------------------------------------------------------
# kitti_eval


def _track(rng, n, step):
    from scipy.spatial.transform import Rotation as Rs

    yaw = np.cumsum(rng.normal(scale=0.02, size=n))
    pos = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw),
                              rng.normal(scale=0.01, size=n)], 1) * step, 0)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rs.from_euler("z", yaw[:, None]).as_matrix()
    T[:, :3, 3] = pos
    return T


def test_kitti_eval_equal():
    rng = np.random.default_rng(5)
    gt = _track(rng, 400, 1.0)            # ~400 m: every segment length
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(scale=0.02, size=(400, 3)), 0)
    assert_same(t_ke.kitti_segment_errors(est, gt),
                j_ke.kitti_segment_errors(est, gt))
    assert_same(t_ke.kitti_summary(est, gt), j_ke.kitti_summary(est, gt))
    assert t_ke.kitti_summary(est, gt)["n_segments"] > 0
    assert_same(t_ke.kitti_summary(est[:5], gt[:5]),
                j_ke.kitti_summary(est[:5], gt[:5]))
    for align in (True, False):
        assert t_ke.ate_rmse(est, gt, align) == j_ke.ate_rmse(est, gt, align)
    for delta in (1, 10):
        assert_same(t_ke.rpe(est, gt, delta), j_ke.rpe(est, gt, delta))


# ---------------------------------------------------------------------------
# sensor_formats


def _cloud(rng, n=200, **extra):
    c = {"x": rng.normal(size=n).astype(np.float32),
         "y": rng.normal(size=n).astype(np.float32),
         "z": rng.normal(size=n).astype(np.float32),
         "ring": rng.integers(0, 16, n).astype(np.uint16),
         "intensity": rng.uniform(0, 255, n).astype(np.float32)}
    c.update(extra)
    return c


def _cloud_cases():
    rng = np.random.default_rng(6)
    n = 200
    nan = _cloud(rng, time=rng.uniform(0, 0.1, n).astype(np.float32))
    nan["x"][[3, 50]] = np.nan
    return {
        "velodyne time": (_cloud(rng, time=rng.uniform(0, 0.1, n).astype(
            np.float32)), "auto"),
        "velodyne t ns": (_cloud(rng, t=rng.integers(0, 10 ** 8, n).astype(
            np.uint32)), "velodyne"),
        "velodyne t s": (_cloud(rng, t=rng.uniform(0, 0.1, n)), "velodyne"),
        "ouster": (_cloud(rng, t=rng.integers(0, 10 ** 8, n).astype(np.uint32),
                          reflectivity=np.zeros(n, np.uint16)), "auto"),
        "ouster no t": (_cloud(rng, reflectivity=np.zeros(n, np.uint16)),
                        "ouster"),
        "livox": (_cloud(rng, time=rng.uniform(0, 0.1, n).astype(
            np.float32)), "livox"),
        "no time": (_cloud(rng), "velodyne"),
        "non-finite rows": (nan, "auto"),
    }


@pytest.mark.parametrize("case", list(_cloud_cases()))
def test_to_xyzirt_equal(case):
    cloud, sensor = _cloud_cases()[case]
    assert t_sf.detect_sensor(cloud) == j_sf.detect_sensor(cloud)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = t_sf.to_xyzirt(cloud, sensor)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = j_sf.to_xyzirt(cloud, sensor)
    assert_same(t, j)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_sensor_format_errors_and_stream_checker():
    rng = np.random.default_rng(7)
    no_ring = _cloud(rng)
    del no_ring["ring"]
    with pytest.raises(ValueError, match="ring channel"):
        t_sf.to_xyzirt(no_ring)
    with pytest.raises(ValueError, match="unknown sensor"):
        t_sf.to_xyzirt(_cloud(rng), "hesai")
    chk = t_sf.ScanStreamChecker("auto")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(3):
            chk.convert(_cloud(rng))
    assert len(w) == 1 and "deskew function disabled" in str(w[0].message)


def test_geometric_rings_and_times_equal():
    rng = np.random.default_rng(8)
    elev = np.radians(np.repeat(np.linspace(-15, 15, 16), 100)
                      + rng.normal(scale=0.01, size=1600))
    az = rng.uniform(-np.pi, np.pi, 1600)
    xyz = np.stack([np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az),
                    np.sin(elev)], 1) * 10
    assert_same(t_sf.rings_from_elevation(xyz), j_sf.rings_from_elevation(xyz))
    assert t_sf.rings_from_elevation(xyz)[1] == 16
    assert_same(t_sf.times_from_azimuth(xyz), j_sf.times_from_azimuth(xyz))


# ---------------------------------------------------------------------------
# io_rosbag


def _rec(fields, data):
    h = b""
    for k, v in fields.items():
        e = k.encode() + b"=" + v
        h += struct.pack("<I", len(e)) + e
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _bz2_copy(src, dst):
    """`src` (one uncompressed chunk, as make_tiny_bag and chip_smoke write
    it) with its chunk bz2-compressed."""
    buf = open(src, "rb").read()
    magic, o = b"#ROSBAG V2.0\n", 13
    (hlen,) = struct.unpack_from("<I", buf, o)
    o += 4 + hlen
    (dlen,) = struct.unpack_from("<I", buf, o)
    chunk = buf[o + 4:o + 4 + dlen]
    with open(dst, "wb") as f:
        f.write(magic + _rec({"op": b"\x05", "compression": b"bz2",
                              "size": struct.pack("<I", len(chunk))},
                             bz2.compress(chunk)))


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """Bags of a 4-sweep simulated drive: Velodyne-layout clouds
    (tests/test_io.py's writers), Ouster-layout clouds (chip_smoke's
    writer), and each again with a bz2 chunk."""
    root = tmp_path_factory.mktemp("bags")
    data = t_sim.make_dataset(t_sim.World(), t_sim.SimTrajectory(),
                              n_scans=4, n_scan=16, horizon=360, seed=9)
    imu, clouds = {}, []
    for s in data:
        for k in range(len(s["imu_t"])):
            t = float(s["imu_t"][k]) + 100.0
            imu[round(t, 4)] = (t, encode_imu(t, s["imu_gyro"][k],
                                              s["imu_acc"][k]))
        t0 = s["scan_start"] + 100.0
        clouds.append((t0, encode_cloud(t0, s["xyz"], s["ring"],
                                        s["time_rel"])))
    paths = {"velodyne": str(root / "velodyne.bag"),
             "ouster": str(root / "ouster.bag")}
    make_tiny_bag(paths["velodyne"], sorted(imu.values()), clouds)
    chip_smoke._write_ouster_bag(paths["ouster"], data)
    for name in list(paths):
        paths[name + " bz2"] = str(root / f"{name}_bz2.bag")
        _bz2_copy(paths[name], paths[name + " bz2"])
    return paths, data


@pytest.mark.parametrize("bag,sensor", [
    ("velodyne", "auto"), ("velodyne bz2", "auto"), ("velodyne", "livox"),
    ("ouster", "auto"), ("ouster bz2", "auto"), ("ouster", "ouster")])
def test_iter_lio_inputs_equal(bags, bag, sensor):
    paths, data = bags
    cloud = "/points"
    t = list(t_bag.iter_lio_inputs(paths[bag], cloud, "/imu", sensor=sensor))
    j = list(j_bag.iter_lio_inputs(paths[bag], cloud, "/imu", sensor=sensor))
    assert len(t) == len(data) == 4
    assert_same(t, j)
    for s, sim in zip(t, data):
        np.testing.assert_array_equal(s["xyz"], sim["xyz"])
        np.testing.assert_array_equal(s["ring"], sim["ring"])
        # Ouster's point time is integer nanoseconds
        np.testing.assert_allclose(s["time_rel"], sim["time_rel"], rtol=0,
                                   atol=1e-9)


def test_same_imu_sees_a_changed_sample(bags):
    paths, data = bags
    s = next(t_bag.iter_lio_inputs(paths["ouster"], "/points", "/imu"))
    assert chip_smoke._same_imu(s, data[0])
    k = len(s["imu_t"]) // 2
    for key in ("imu_gyro", "imu_acc"):
        bent = dict(s, **{key: s[key].copy()})
        bent[key][k, 1] += 1e-3
        assert not chip_smoke._same_imu(bent, data[0])
    short = {k2: (v[1:-1] if k2.startswith("imu_") and k2 != "imu_rpy"
                  else v) for k2, v in s.items()}
    assert chip_smoke._same_imu(short, data[0])
    gap = {k2: (np.delete(v, k, 0) if k2.startswith("imu_")
                and k2 != "imu_rpy" else v) for k2, v in s.items()}
    assert not chip_smoke._same_imu(gap, data[0])


def test_ouster_bag_writer_attitude_and_imu(bags):
    """chip_smoke's bag: each cloud follows the IMU messages of its scan's
    window, so the reader gives back the simulator's IMU samples, and its
    attitude is the one of the window's last sample (msst_tpu's reader takes
    the last message of its window)."""
    from scipy.spatial.transform import Rotation as Rs

    paths, data = bags
    scans = list(t_bag.iter_lio_inputs(paths["ouster"], "/points", "/imu"))
    traj = chip_smoke._bench_trajectory()
    for s, sim in zip(scans, data):
        assert chip_smoke._same_imu(s, sim)
        want = Rs.from_matrix(traj.pose(s["imu_t"][-1])[:3, :3]).as_euler(
            "xyz")
        np.testing.assert_allclose(s["imu_rpy"], want, atol=1e-6)
        assert s["scan_start"] == sim["scan_start"]


def test_rosbag_reader_and_decoders_equal(bags):
    paths, _ = bags
    tr, jr = t_bag.RosbagReader(paths["velodyne"]), \
        j_bag.RosbagReader(paths["velodyne"])
    tm, jm = list(tr.messages()), list(jr.messages())
    assert_same(tm, jm)
    assert tr.connections == jr.connections
    imu = next(raw for topic, _, _, raw in tm if topic == "/imu")
    assert_same(t_bag.decode_imu(imu), j_bag.decode_imu(imu))
    cloud = next(raw for topic, _, _, raw in tm if topic == "/points")
    assert_same(t_bag.decode_pointcloud2(cloud),
                j_bag.decode_pointcloud2(cloud))
    rng = np.random.default_rng(10)
    odo = (struct.pack("<I", 0) + struct.pack("<II", 12, 5 * 10 ** 8)
           + struct.pack("<I", 3) + b"map" + struct.pack("<I", 4) + b"base"
           + struct.pack("<3d", *rng.normal(size=3))
           + struct.pack("<4d", 0, 0, 0, 1) + rng.normal(size=36).tobytes())
    assert_same(t_bag.decode_odometry(odo), j_bag.decode_odometry(odo))
    with open(os.path.join(os.path.dirname(paths["velodyne"]), "x.bag"),
              "wb") as f:
        f.write(b"#ROSBAG V1.2\n")
    with pytest.raises(ValueError, match="rosbag 2.0"):
        t_bag.RosbagReader(f.name)


# ---------------------------------------------------------------------------
# viz, viz_html


def test_write_ply_and_trajectory_json_equal(tmp_path):
    rng = np.random.default_rng(11)
    xyz = rng.normal(size=(50, 3)).astype(np.float32) * 10
    color = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    for c in (None, color):
        t_viz.write_ply(str(tmp_path / "t.ply"), xyz, c)
        j_viz.write_ply(str(tmp_path / "j.ply"), xyz, c)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
    t_vh.write_trajectory_json(str(tmp_path / "t.json"), xyz)
    j_vh.write_trajectory_json(str(tmp_path / "j.json"), xyz)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    out = t_vh.write_viewer(str(tmp_path / "v"))
    assert open(out).read() == j_vh.VIEWER_HTML.replace("msst_tpu",
                                                        "msst_torch")


def test_export_session(tmp_path, monkeypatch):
    """export_session over the port's LioSam: the map PCDs, the PLY of both
    feature maps and the trajectory plot's inputs (the plot itself needs
    matplotlib, which is recorded here instead)."""
    from msst_torch.models.liosam import LioSam
    from msst_torch.models.liosam.params import tiny_params

    data = t_sim.make_dataset(t_sim.World(), t_sim.SimTrajectory(),
                              n_scans=3, n_scan=16, horizon=360, seed=12)
    lio = LioSam(tiny_params(loop_closure_enabled=False), device="cpu")
    for s in data:
        lio.process_scan(s["xyz"], s["ring"], s["time_rel"], s["scan_start"],
                         imu_t=s["imu_t"], imu_gyro=s["imu_gyro"],
                         imu_acc=s["imu_acc"], imu_rpy=s["imu_rpy"])
    plots = []
    monkeypatch.setattr(t_viz, "plot_trajectory",
                        lambda *a, **k: plots.append(a))
    m = t_viz.export_session(lio, str(tmp_path))
    both = np.concatenate([m["corner_map"], m["surf_map"]])
    assert len(both) > 0
    head = (tmp_path / "global_map.ply").read_text().splitlines()[2]
    assert head == f"element vertex {len(both)}"
    for name in ("corner_map", "surf_map", "global_map"):
        assert (tmp_path / f"{name}.pcd").exists()
    (path, est, gt, pts), = plots
    assert path == str(tmp_path / "trajectory.png") and gt is None
    np.testing.assert_array_equal(est, lio.trajectory.as_matrices()[:, :3, 3])
    np.testing.assert_array_equal(pts, both)


# ---------------------------------------------------------------------------
# calibration_io


def test_calibration_files_equal(tmp_path):
    rng = np.random.default_rng(13)
    lasers = [{"laser_id": float(i), "rot_correction": float(r),
               "vert_correction": float(v), "dist_correction": float(d),
               "two_pt_correction_available": float(i % 2),
               "focal_slope": 0.5}
              for i, (r, v, d) in enumerate(zip(
                  rng.normal(scale=0.02, size=16), np.linspace(-0.26, 0.26, 16),
                  rng.normal(scale=0.02, size=16)))]
    calib = {"num_lasers": 16, "distance_resolution": 0.002,
             "lasers": lasers}
    t_cal.write_calibration_yaml(str(tmp_path / "t.yaml"), calib)
    j_cal.write_calibration_yaml(str(tmp_path / "j.yaml"), calib)
    assert (tmp_path / "t.yaml").read_text() == \
        (tmp_path / "j.yaml").read_text()
    block = "num_lasers: 2\ndistance_resolution: 0.004\nlasers:\n" + "".join(
        f"- laser_id: {i}\n  rot_correction: {0.01 * i}\n  "
        f"vert_correction: {-0.1 + 0.2 * i}\n" for i in range(2))
    (tmp_path / "block.yaml").write_text(block)
    for path in ("t.yaml", "block.yaml"):
        t, j = t_cal.load_calibration_yaml(str(tmp_path / path)), \
            j_cal.load_calibration_yaml(str(tmp_path / path))
        assert_same(t, j)
        tc = t_cal.decoder_config_from_calibration(t, min_range=0.9)
        jc = j_cal.decoder_config_from_calibration(j, min_range=0.9)
        import dataclasses

        assert_same(dataclasses.asdict(tc), dataclasses.asdict(jc))
        assert_same(tc.laser_tables(), jc.laser_tables())
    xml = "<boost_serialization><DB><points_>" + "".join(
        f"<item><px><id_>{i}</id_><rotCorrection_>{0.5 * i}</rotCorrection_>"
        f"<vertCorrection_>{-15 + 2 * i}</vertCorrection_>"
        f"<distCorrection_>{1.5 * i}</distCorrection_>"
        f"<vertOffsetCorrection_>0.2</vertOffsetCorrection_>"
        f"<horizOffsetCorrection_>0.1</horizOffsetCorrection_></px></item>"
        for i in (2, 0, 1)) + "</points_></DB></boost_serialization>"
    (tmp_path / "db.xml").write_text(xml)
    assert_same(t_cal.convert_velodyne_xml(str(tmp_path / "db.xml")),
                j_cal.convert_velodyne_xml(str(tmp_path / "db.xml")))


# ---------------------------------------------------------------------------
# sync, navsat, gpstime, laserscan


def test_approximate_time_sync_equal():
    rng = np.random.default_rng(14)
    events = [(int(s), float(t)) for s, t in zip(
        rng.integers(0, 3, 120), np.cumsum(rng.uniform(0, 0.03, 120)))]
    for slop in (0.01, 0.05):
        got, want = [], []
        ts = t_sync.ApproximateTimeSynchronizer(
            3, slop=slop, callback=lambda *m: got.append(m))
        js = j_sync.ApproximateTimeSynchronizer(
            3, slop=slop, callback=lambda *m: want.append(m))
        for i, (s, t) in enumerate(events):
            ts.push(s, t, i)
            js.push(s, t, i)
        assert got == want and ts.matched == js.matched
        assert [list(q) for q in ts.queues] == [list(q) for q in js.queues]


def test_imu_lidar_sync_equal():
    rng = np.random.default_rng(15)
    t_s, j_s = t_sync.ImuLidarSync(max_imu=50), j_sync.ImuLidarSync(max_imu=50)
    for t in np.cumsum(rng.uniform(0, 0.01, 300)):
        for s in (t_s, j_s):
            s.push_imu(float(t), {"t": float(t)})
        if rng.uniform() < 0.05:
            assert t_s.on_lidar(float(t)) == j_s.on_lidar(float(t))
    assert (t_s.stats_matched, t_s.stats_frames) == \
        (j_s.stats_matched, j_s.stats_frames)


def test_navsat_aligner_equal():
    rng = np.random.default_rng(16)
    ta, ja = t_nav.NavsatAligner(min_pairs=5), j_nav.NavsatAligner(min_pairs=5)
    yaw = 0.4
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                  [0, 0, 1]])
    for k in range(12):
        lat, lon, alt = 48 + k * 1e-5, 11 + k * 2e-5, 500 + rng.normal()
        enu = j_nav.latlon_to_enu(np.asarray([lat]), np.asarray([lon]),
                                  np.asarray([alt]), 48, 11, 500)[0]
        odom = R @ enu + [1, 2, 0] + rng.normal(scale=0.01, size=3)
        assert_same(ta.add_fix(lat, lon, alt, odom),
                    ja.add_fix(lat, lon, alt, odom))
        assert ta.is_aligned == ja.is_aligned
        got, want = ta.gps_to_map(lat, lon, alt), ja.gps_to_map(lat, lon, alt)
        assert (got is None and want is None) or assert_same(got, want) is None
    cov = np.array([1.0, 0, 0, 0, 3.0, 0, 0, 0, 1.0])
    assert ta.covariance_gate(cov) == ja.covariance_gate(cov)


def test_gpstime_and_laserscan_equal():
    rng = np.random.default_rng(17)
    for _ in range(50):
        us = int(rng.integers(0, 3600 * 10 ** 6))
        recv = 1.7e9 + float(rng.uniform(0, 7200))
        assert t_gps.resolve_hour_timestamp(us, recv) == \
            j_gps.resolve_hour_timestamp(us, recv)
    pkt = rng.integers(0, 256, 1206).astype(np.uint8).tobytes()
    assert t_gps.packet_timestamp_us(pkt) == j_gps.packet_timestamp_us(pkt)
    xyz = rng.normal(size=(3000, 3)).astype(np.float32) * [30, 30, 2]
    ring = rng.integers(0, 16, 3000)
    for idx in (-1, 3):
        assert_same(t_ls.extract_laserscan(xyz, ring, idx),
                    j_ls.extract_laserscan(xyz, ring, idx))
