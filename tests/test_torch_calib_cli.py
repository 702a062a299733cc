"""The port's command line, ``msst-torch`` (``msst_torch/cli.py``), on the
CPU (``--device cpu``) with temporary PCD and CSV files: ``calibrate`` by
each method writes the JSON of the library call it makes, ``allan`` the
YAML msst_tpu's ``msst allan`` writes (values to 2e-3 relative, see
test_torch_calibration.py's Allan test), ``manual-calib`` builds its
calibrator on the device asked for, and without ``--device cpu`` every
command raises where no CUDA device is present.
"""

import json

import numpy as np
import pytest
import torch

from msst_torch import cli as tcli
from msst_torch.models.calibration import auto_calib as tac
from msst_torch.models.calibration import device as tdevice
from msst_torch.models.calibration import manual_calib as tman
from msst_torch.models.calibration import ndt_calib as tnd
from msst_torch.utils import io_pcd as tio
from msst_tpu import cli as jcli
from tests.test_torch_calib_ops import (N, _one_torch_thread,  # noqa: F401
                                        structured_scene, view_from)
from tests.test_torch_calibration import _T, _imu_rows


@pytest.fixture(scope="module")
def pcds(tmp_path_factory):
    d = tmp_path_factory.mktemp("pcd")
    world = structured_scene(np.random.default_rng(80))
    tgt = view_from(world, [0, 0, 0], [0, 0, 1.5])
    src = view_from(world, [0.02, -0.03, 0.5], [2.0, 1.0, 1.4])
    child = view_from(world, [0.0, 0.0, 0.1], [0.5, 0.3, 1.5])
    paths = {}
    for name, pts in (("tgt", tgt), ("src", src), ("child", child)):
        paths[name] = str(d / f"{name}.pcd")
        tio.write_pcd(paths[name], pts)
    T_gt = np.linalg.inv(_T([0, 0, 0], [0, 0, 1.5])) @ _T(
        [0.02, -0.03, 0.5], [2.0, 1.0, 1.4])
    return paths, tgt, src, child, T_gt


def _run(tmp_path, *argv):
    out = str(tmp_path / "out.json")
    tcli.main([*argv, "--output", out, "--device", "cpu"])
    with open(out) as f:
        return json.load(f)


def test_calibrate_ndt_equals_the_library_and_msst(pcds, tmp_path):
    paths, tgt, _, child, _ = pcds
    got = _run(tmp_path, "calibrate", paths["tgt"], paths["child"],
               "--method", "ndt")["source_0"]
    cal = tnd.NdtCalibrator(device="cpu")
    cal.process_pair(tgt, child)
    assert got["matrix"] == N(cal.pose.to_matrix()).tolist()
    assert got["score"] == cal.history[-1]
    assert got["tf_command"] == cal.static_transform_command()
    ref = str(tmp_path / "ref.json")
    jcli.main(["calibrate", paths["tgt"], paths["child"], "--method", "ndt",
               "--output", ref])
    with open(ref) as f:
        want = json.load(f)["source_0"]
    # NDT's maps differ by their sums' order (test_torch_calibration.py)
    np.testing.assert_allclose(got["matrix"], want["matrix"], atol=5e-5)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-5)


def test_calibrate_auto_equals_the_library(pcds, tmp_path):
    paths, tgt, src, _, _ = pcds
    got = _run(tmp_path, "calibrate", paths["tgt"], paths["src"],
               "--method", "auto")["source_0"]
    m_x, m_m = tdevice.pad(tgt, tcli.AUTO_CAPACITY, "cpu")
    s_x, s_m = tdevice.pad(src, tcli.AUTO_CAPACITY, "cpu")
    r = tac.auto_calibrate(m_x, m_m, s_x, s_m, tac.AutoCalibConfig(),
                           torch.Generator().manual_seed(0))
    assert got["matrix"] == N(r.pose.to_matrix()).tolist()
    assert got["fitness"] == float(r.icp_rmse)


def test_calibrate_lica_recovers_the_mount(pcds, tmp_path):
    """MultiLicaConfig's defaults (16384 points, k = 48 FPFH, 1024 matches)
    through ``standard_calibration``: the true mount within
    tests/test_calibration.py's gates (1 degree, 0.1 m)."""
    paths, _, _, _, T_gt = pcds
    got = _run(tmp_path, "calibrate", paths["tgt"], paths["src"])["source_0"]
    T = np.asarray(got["matrix"])
    c = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 1.0
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 0.1
    assert got["fitness"] > 0.7 and got["rmse"] > 0.0


def test_allan_matches_msst(tmp_path, capsys):
    t, gyro, acc = _imu_rows(20_000, 0.005, 81)
    csv = str(tmp_path / "imu.csv")
    np.savetxt(csv, np.column_stack([t, gyro, acc]), delimiter=",")
    tcli.main(["allan", csv, "--name", "x", "--output",
               str(tmp_path / "t.yaml"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.split("noise YAML")[0])
    jcli.main(["allan", csv, "--name", "x", "--output",
               str(tmp_path / "j.yaml")])
    want = json.loads(capsys.readouterr().out.split("noise YAML")[0])
    assert got.keys() == want.keys()
    for key in ("gyr_n", "gyr_w", "acc_n", "acc_w", "duration_min"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-3,
                                   err_msg=key)
    lines = (tmp_path / "t.yaml").read_text().splitlines()
    assert lines[:4] == ["%YAML:1.0", "---", "type: IMU", "name: x"]


def test_manual_calib_builds_on_the_device(pcds, monkeypatch):
    paths = pcds[0]
    made = []
    monkeypatch.setattr(tman.ManualCalibrator, "run_interactive",
                        lambda self: made.append(self))
    tcli.main(["manual-calib", paths["tgt"], paths["src"], "--device", "cpu"])
    assert len(made) == 1 and made[0].device == torch.device("cpu")
    assert made[0].src.shape[0] == len(pcds[2])


@pytest.mark.parametrize("argv", [
    ["calibrate", "TGT", "SRC", "--method", "ndt"],
    ["calibrate", "TGT", "SRC"],
    ["allan", "CSV"],
    ["manual-calib", "TGT", "SRC"],
])
def test_commands_raise_without_a_card(pcds, tmp_path, monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = pcds[0]
    csv = tmp_path / "imu.csv"
    np.savetxt(csv, np.zeros((100, 7)), delimiter=",")
    subst = {"TGT": paths["tgt"], "SRC": paths["src"], "CSV": str(csv)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([subst.get(a, a) for a in argv])
