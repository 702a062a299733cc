"""The port's LIO host commands on the CPU: ``msst-torch lio-kitti`` and
``lio-bag`` with ``--tiny --device cpu`` over a 4-sweep synthetic KITTI
drive (chip_smoke.py's writer, 16 x 360) and a 4-sweep bag
(tests/test_io.py's writers), each against msst_tpu's ``_lio_run`` over
the same input, in this process; ``decode-pcap`` against msst_tpu's numpy
decode; the streamed viewer files and ``viz-serve``'s live reload; the GPS
datum of ``_lio_run`` against msst_tpu's; and every new command raising
where no card is present and no ``--device cpu`` is given.

msst_tpu's ``odometry_core`` reads an undefined name ``inp`` where it means
its prepared scan (mapping.py:1295-1301), so its CLI cannot run as it is.
Its ``_lio_run`` runs here with a test-local jitted step that binds
``mapping.inp = ps`` while it traces (as tests/test_torch_slice.py does),
in place of ``pipeline.odometry_step_packed`` for one module fixture.

The trajectories are held to the slice's drive tolerance, 0.08 m
(tests/test_torch_slice.py: the tiny profile's 3-point voxel planes
amplify float32 rounding over a drive).
"""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from msst_torch import cli as tcli
from msst_torch.utils import viz as t_viz
from msst_torch.utils.kitti_eval import ate_rmse
from msst_torch.utils import viz_html as t_vh
from msst_torch.utils.io_pcd import read_pcd
from msst_tpu import cli as jcli
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam import pipeline as jpipe
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.utils import io_kitti as j_kitti
from msst_tpu.utils import io_rosbag as j_bag
from msst_tpu.utils import packets as jp
from msst_tpu.utils import sim
from tests.test_io import encode_cloud, encode_imu, make_tiny_bag

DRIVE_GAP_M = 0.08
PCAP_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops, many of them: one torch thread while the suite's parallel
    workers run (as tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_step(state, points, aux, p):
    ps = jmap.prepare_scan(jmap.unpack_step_input(points, aux, p), p)
    jmap.inp = ps   # the name msst_tpu's odometry_core reads; see docstring
    try:
        return jmap.odometry_core(state, ps, p)
    finally:
        del jmap.inp


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The synthetic KITTI drive and bag, and msst_tpu's ``_lio_run`` over
    each (one jitted step: both runs share the tiny profile)."""
    root = tmp_path_factory.mktemp("lio")
    drive, gt, _ = chip_smoke._write_kitti_drive(
        str(root / "kitti"), n_scans=4, n_rings=16, horizon=360,
        elev=(-15.0, 15.0))
    data = sim.make_dataset(sim.World(), sim.SimTrajectory(), n_scans=4,
                            n_scan=16, horizon=360, seed=9)
    imu, clouds = {}, []
    for s in data:
        for k in range(len(s["imu_t"])):
            t = float(s["imu_t"][k]) + 1000.0
            imu[round(t, 4)] = (t, encode_imu(t, s["imu_gyro"][k],
                                              s["imu_acc"][k]))
        t0 = s["scan_start"] + 1000.0
        clouds.append((t0, encode_cloud(t0, s["xyz"], s["ring"],
                                        s["time_rel"])))
    bag = str(root / "session.bag")
    make_tiny_bag(bag, sorted(imu.values()), clouds)

    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "odometry_step_packed",
               jax.jit(_reference_step, static_argnames=("p",)))
    try:
        p = jtiny(n_scan=16, loop_closure_enabled=False, max_points=8192)
        ref_kitti = jcli._lio_run(
            j_kitti.KittiRawDrive(drive, n_rings=16).iter_scans(), params=p,
            progress=False)
        ref_bag = jcli._lio_run(
            j_bag.iter_lio_inputs(bag, "/points", "/imu"),
            params=jtiny(loop_closure_enabled=False, sensor="velodyne"),
            progress=False)
        ref = {"kitti": (ref_kitti.trajectory.as_matrices(),
                         ref_kitti.last_run_stats),
               "bag": (ref_bag.trajectory.as_matrices(),
                       ref_bag.last_run_stats)}
    finally:
        mp.undo()
    return dict(root=root, drive=drive, gt=gt, bag=bag, ref=ref)


def _kitti_rows(path):
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    assert np.isfinite(rows).all()
    return rows


def test_lio_kitti_cpu(inputs, capsys, tmp_path):
    out, stats = str(tmp_path / "traj.txt"), str(tmp_path / "stats.json")
    tcli.main(["lio-kitti", inputs["drive"], "--rings", "16", "--tiny",
               "--max-points", "8192", "--device", "cpu", "--output", out,
               "--stats-json", stats])
    text = capsys.readouterr().out
    rows = _kitti_rows(out)
    assert rows.shape == (4, 3, 4)
    assert f"4 poses -> {out} (KITTI format)" in text
    # the report's ATE is the trajectory's against the OXTS track (here the
    # simulator's positions about the first), in cm to one decimal
    ate = [ln for ln in text.splitlines() if ln.startswith("ATE RMSE: ")]
    est = np.tile(np.eye(4), (4, 1, 1))
    est[:, :3, :] = rows
    truth = np.tile(np.eye(4), (4, 1, 1))
    truth[:, :3, 3] = inputs["gt"] - inputs["gt"][0]
    want_cm = 100 * ate_rmse(est, truth)
    assert len(ate) == 1 and abs(float(ate[0].split()[2]) - want_cm) <= 0.051
    assert want_cm < 10.0
    want, want_stats = inputs["ref"]["kitti"]
    got_stats = json.load(open(stats))
    assert got_stats["scans"] == want_stats["scans"] == 4
    assert got_stats["loops_closed"] == want_stats["loops_closed"] == 0
    assert set(got_stats) == set(want_stats)
    np.testing.assert_allclose(rows[:, :, 3], want[:, :3, 3], rtol=0,
                               atol=DRIVE_GAP_M)
    np.testing.assert_allclose(rows[:, :, 3], inputs["gt"] - inputs["gt"][0],
                               rtol=0, atol=0.15)


@pytest.mark.parametrize("matplotlib_present", [True, False])
def test_lio_kitti_streams_the_viewer_files(inputs, capsys, tmp_path,
                                            monkeypatch, matplotlib_present):
    """--viz-every: global_map.ply, trajectory.json and viewer.html in the
    viz directory; trajectory.png only where matplotlib imports, else one
    line on stderr says it was skipped."""
    import importlib.util
    import sys

    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    png = matplotlib_present and \
        importlib.util.find_spec("matplotlib") is not None
    viz = tmp_path / "viz"
    tcli.main(["lio-kitti", inputs["drive"], "--rings", "16", "--tiny",
               "--max-points", "8192", "--device", "cpu", "--scans", "3",
               "--output", str(tmp_path / "t.txt"), "--viz-every", "1",
               "--viz-dir", str(viz)])
    err = capsys.readouterr().err
    ply = (viz / "global_map.ply").read_text().splitlines()
    n = int(ply[2].split()[-1])
    assert n > 0 and len(ply) == n + 7
    xyz = json.load(open(viz / "trajectory.json"))["xyz"]
    assert len(xyz) == 3
    assert "webgl" in (viz / "viewer.html").read_text()
    assert err.count("viz: scan") == 4
    assert (viz / "trajectory.png").exists() == png
    assert err.count("trajectory.png is skipped") == (0 if png else 1)


def test_lio_bag_cpu(inputs, capsys, tmp_path):
    out = str(tmp_path / "traj.txt")
    tcli.main(["lio-bag", inputs["bag"], "--cloud-topic", "/points",
               "--imu-topic", "/imu", "--tiny", "--device", "cpu",
               "--output", out])
    assert f"4 poses -> {out}" in capsys.readouterr().out
    rows = _kitti_rows(out)
    want, _ = inputs["ref"]["bag"]
    assert rows.shape == (len(want), 3, 4) == (4, 3, 4)
    np.testing.assert_allclose(rows[:, :, 3], want[:, :3, 3], rtol=0,
                               atol=DRIVE_GAP_M)


class _FakeLio:
    """Stands in for LioSam in ``_lio_run``: records what each scan is fed
    and reports the scan's true position as its pose."""

    def __init__(self, params=None, device=None, as_torch=True):
        self.calls, self.as_torch = [], as_torch
        self.trajectory = None
        self.state = type("S", (), {"n_loop": 0})()

    def process_scan(self, xyz, ring, time_rel, scan_start, **kw):
        self.calls.append(kw)
        pose6 = np.concatenate([np.zeros(3), xyz[0]]).astype(np.float32)
        degenerate = len(self.calls) % 7 == 0
        if self.as_torch:
            pose6, degenerate = torch.from_numpy(pose6), torch.tensor(
                degenerate)
        return type("O", (), {"pose6": pose6, "degenerate": degenerate,
                              "kf_count": len(self.calls)})()


def test_lio_run_gps_datum_against_msst_tpu(monkeypatch):
    """30 fixes, then the datum (mean of estimate - fix) is frozen and every
    later fix is fed as fix + datum with its sigma; the same calls as
    msst_tpu's ``_lio_run``."""
    import msst_torch.models.liosam as tls
    import msst_tpu.models.liosam as jls

    rng = np.random.default_rng(30)
    offset = np.array([1.5, -2.0, 0.25])
    scans = []
    for i in range(40):
        p = np.array([0.5 * i, 0.1 * i, 0.0]) + rng.normal(scale=0.05, size=3)
        scans.append(dict(xyz=p[None].astype(np.float32), ring=np.zeros(1),
                          time_rel=np.zeros(1), scan_start=0.1 * i,
                          imu_rpy=np.zeros(3, np.float32),
                          gps_xyz=(p - offset).astype(np.float32),
                          gps_sigma=np.full(3, 0.3, np.float32)))
    runs = {}
    for name, mod, run, as_torch in (("port", tls, tcli._lio_run, True),
                                     ("msst_tpu", jls, jcli._lio_run, False)):
        monkeypatch.setattr(mod, "LioSam", lambda p=None, device=None,
                            t=as_torch: _FakeLio(p, device, t))
        runs[name] = run(iter(scans), gps=True, progress=False)
    got, want = runs["port"], runs["msst_tpu"]
    assert len(got.calls) == len(want.calls) == 40
    for g, w in zip(got.calls, want.calls):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert all("gps_xyz" not in c for c in got.calls[:30])
    datum = np.mean([s["xyz"][0] - s["gps_xyz"] for s in scans[:30]], axis=0)
    for c, s in zip(got.calls[30:], scans[30:]):
        np.testing.assert_allclose(c["gps_xyz"], s["gps_xyz"] + datum,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(c["gps_sigma"], s["gps_sigma"])
    assert got.last_run_stats == want.last_run_stats == {
        "scans": 40, "degenerate_scans": 5, "loops_closed": 0}


def test_decode_pcap_against_msst_tpu(tmp_path, capsys, monkeypatch):
    pk = np.fromfile(os.path.join(os.path.dirname(__file__), "data",
                                  "golden_packets.bin"), np.uint8)
    pk = np.tile(pk.reshape(4, 1206), (3, 1))
    stamps = 1.6e9 + 0.5 + np.arange(len(pk)) * 0.0012
    pcap, out = str(tmp_path / "in.pcap"), str(tmp_path / "out.pcd")
    chip_smoke._write_pcap(pcap, pk, stamps)
    tcli.main(["decode-pcap", pcap, out])
    text = capsys.readouterr().out
    monkeypatch.setattr(jp, "_load_native", lambda: False)
    xyz, ring, trel, inten = jp.packets_to_scan(pk, stamps=stamps)
    assert f"{len(pk)} packets, {len(xyz)} points -> {out}" in text
    pcd = read_pcd(out)
    assert len(pcd["xyz"]) == len(xyz) > 1000
    np.testing.assert_allclose(pcd["xyz"], xyz, rtol=0, atol=PCAP_ATOL)
    np.testing.assert_allclose(pcd["fields"]["intensity"], inten, rtol=0,
                               atol=PCAP_ATOL)
    with pytest.raises(SystemExit, match="no 1206-byte packets"):
        chip_smoke._write_pcap(pcap, pk[:0], stamps[:0])
        tcli.main(["decode-pcap", pcap, out])


def test_viz_serve_live_reload(tmp_path, monkeypatch):
    """make_server serves the viewer files with caching off, and an
    overwrite (the --viz-every stream) is seen on the next fetch; the
    command hands its directory and port to ``serve``."""
    d = str(tmp_path)
    t_viz.write_ply(os.path.join(d, "global_map.ply"),
                    np.asarray([[0.0, 0, 0], [1, 2, 3]]))
    t_vh.write_trajectory_json(os.path.join(d, "trajectory.json"),
                               np.zeros((2, 3)))
    srv = t_vh.make_server(d, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        def get(name):
            r = urllib.request.urlopen(f"http://127.0.0.1:{port}/{name}",
                                       timeout=10)
            assert r.headers["Cache-Control"] == "no-store"
            return r.read().decode()

        assert "msst_torch viewer" in get("viewer.html")
        assert "element vertex 2" in get("global_map.ply")
        tmp = os.path.join(d, ".global_map.ply.tmp")
        t_viz.write_ply(tmp, np.zeros((3, 3)))
        os.replace(tmp, os.path.join(d, "global_map.ply"))
        assert "element vertex 3" in get("global_map.ply")
        assert json.loads(get("trajectory.json"))["xyz"] == [[0, 0, 0]] * 2
    finally:
        srv.shutdown()
        srv.server_close()
    served = []
    monkeypatch.setattr(t_vh, "serve", lambda *a, **k: served.append((a, k)))
    tcli.main(["viz-serve", d, "--port", "9911"])
    assert served == [((d,), {"port": 9911})]


@pytest.mark.parametrize("argv", [
    ["lio-kitti", "DIR"],
    ["lio-bag", "BAG", "--cloud-topic", "/p", "--imu-topic", "/i"],
])
def test_commands_raise_without_a_card(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


@pytest.mark.parametrize("cmd", ["viz-serve", "decode-pcap"])
def test_host_commands_take_no_device(cmd, tmp_path, capsys, monkeypatch):
    """viz-serve and decode-pcap use no card: without one, and without a
    --device option (which they no longer take), each runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cmd == "viz-serve":
        served = []
        monkeypatch.setattr(t_vh, "serve",
                            lambda *a, **k: served.append((a, k)))
        tcli.main(["viz-serve", str(tmp_path)])
        assert served == [((str(tmp_path),), {"port": 8642})]
    else:
        pk = np.fromfile(os.path.join(os.path.dirname(__file__), "data",
                                      "golden_packets.bin"), np.uint8)
        pcap, out = str(tmp_path / "in.pcap"), str(tmp_path / "out.pcd")
        chip_smoke._write_pcap(pcap, pk.reshape(4, 1206),
                               1.6e9 + np.arange(4) * 0.0012)
        tcli.main(["decode-pcap", pcap, out])
        assert "4 packets" in capsys.readouterr().out
        assert len(read_pcd(out)["xyz"]) > 100
    args = ["DIR"] if cmd == "viz-serve" else ["IN.pcap", "OUT.pcd"]
    with pytest.raises(SystemExit):   # argparse: no such option
        tcli.main([cmd, *args, "--device", "cpu"])
