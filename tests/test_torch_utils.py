"""The port's host modules and new commands, on the CPU: the state
checkpoint (``utils.checkpoint``), against msst_tpu's in both directions;
``utils.profiling``; ``msst-torch heading | track | lio-sim --device
cpu`` on temporary PCDs against the library calls made the command's way;
and the raise of every new entry point where no CUDA device is present.

Tolerances: a checkpoint restores every leaf bit for bit with its dtype
and device (it is an npz of the leaves); the commands' JSON lines equal
the library's (the same calls on the same device); the lio-sim output
equals the demo's line for line but the one wall-clock line.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch import cli as tcli
from msst_torch import convert
from msst_torch.models import fusion as tfu
from msst_torch.models import heading as th
from msst_torch.models import target_tracker as ttr
from msst_torch.models.calibration import device as tdevice
from msst_torch.models.liosam import demo as tdemo
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.models.liosam.state import init_state as tinit
from msst_torch.utils import checkpoint as tck
from msst_torch.utils import profiling as tprof
from msst_torch.utils.io_pcd import read_pcd, write_pcd
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.models.liosam.state import init_state as jinit
from msst_tpu.utils import checkpoint as jck
from tests.test_torch_calib_ops import N, _one_torch_thread  # noqa: F401
from tests.test_torch_heading import corridor_cloud
from tests.test_torch_tracker_fusion import target_frame

METHODS = ("voxel", "knn")   # the knn state holds hash grids, voxel None


def _leaves(state):
    from torch.utils import _pytree as pytree

    return [x for x in pytree.tree_leaves(state) if x is not None]


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.device == y.device, i
        assert torch.equal(x, y), i


def _mutated(method):
    s = tinit(ttiny(scan2map_method=method), "cpu")
    return s._replace(
        pose6=torch.tensor([0.1, 0.2, 0.3, 1.0, 2.0, 3.0]),
        initialized=torch.tensor(True), n_loop=torch.tensor(3, dtype=torch.int32),
        kf=s.kf._replace(count=torch.tensor(2, dtype=s.kf.count.dtype)))


@pytest.mark.parametrize("method", METHODS)
def test_checkpoint_roundtrip(tmp_path, method):
    s = _mutated(method)
    path = str(tmp_path / "state.npz")
    tck.save_state(path, s)
    back = tck.load_state(path, tinit(ttiny(scan2map_method=method), "cpu"))
    _assert_same_state(back, s)
    assert (back.local_map.corner_grid is None) == (method == "voxel")
    with pytest.raises(ValueError, match="leaves|shape"):
        tck.load_state(path, tinit(ttiny(scan2map_method=method,
                                         max_keyframes=32), "cpu"))


def test_checkpoint_leaf_count_mismatch_raises(tmp_path):
    """A voxel state (no hash grids) into a knn template: fewer leaves."""
    path = str(tmp_path / "state.npz")
    tck.save_state(path, _mutated("voxel"))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_state(path, tinit(ttiny(scan2map_method="knn"), "cpu"))


def _jax_state(method):
    js = jinit(jtiny(scan2map_method=method))
    return js._replace(
        pose6=jnp.asarray([0.1, 0.2, 0.3, 1, 2, 3], jnp.float32),
        initialized=jnp.asarray(True), n_gps=jnp.asarray(4, js.n_gps.dtype))


def _from_jax(js):
    return convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")


@pytest.mark.parametrize("method", METHODS)
def test_checkpoint_from_msst_tpu(tmp_path, method):
    """msst_tpu's ``save_state`` loaded by the port equals
    ``convert.from_numpy`` of the same state.  On the voxel path msst_tpu
    keeps the knn hash grids that the port holds as None, so its
    checkpoint loads into a template that has them (the port's own
    init_state is refused: 10 leaves fewer)."""
    js = _jax_state(method)
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, js)
    template = _from_jax(jinit(jtiny(scan2map_method=method)))
    _assert_same_state(tck.load_state(path, template), _from_jax(js))
    own = tinit(ttiny(scan2map_method=method), "cpu")
    if method == "knn":
        _assert_same_state(tck.load_state(path, own), _from_jax(js))
    else:
        with pytest.raises(ValueError, match="89 leaves, template has 79"):
            tck.load_state(path, own)


def test_checkpoint_to_msst_tpu(tmp_path):
    """The port's knn state loaded by msst_tpu's ``load_state`` is the
    port's state."""
    path = str(tmp_path / "torch.npz")
    ts = _mutated("knn")
    tck.save_state(path, ts)
    back = jck.load_state(path, jinit(jtiny(scan2map_method="knn")))
    _assert_same_state(_from_jax(back), ts)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_heading_command_equals_the_library(tmp_path, capsys):
    rng = np.random.default_rng(60)
    paths = []
    for i, yaw in enumerate((0.0, 3.0, 6.0)):
        paths.append(str(tmp_path / f"h{i}.pcd"))
        pts = corridor_cloud(rng, *np.radians([2.0, -1.0, yaw]))
        write_pcd(paths[-1], pts[rng.permutation(len(pts))])
    tcli.main(["heading", *paths, "--max-points", "4096", "--device", "cpu"])
    got = _lines(capsys)
    cfg = th.HeadingConfig(max_points=4096)
    st = th.HeadingState.create("cpu")
    for i, path in enumerate(paths):
        pts, mask = tdevice.pad(read_pcd(path)["xyz"], 4096, "cpu")
        st, r = th.heading_step(st, pts, mask, 0.1 * (i + 1),
                                torch.Generator().manual_seed(i), cfg)
        assert got[i] == {
            "frame": i, "roll_deg": round(float(r.roll), 3),
            "pitch_deg": round(float(r.pitch), 3),
            "yaw_deg": round(float(r.yaw), 3),
            "distances_LF_LB_RF_RB": [round(float(x), 3) for x in r.distances],
            "confidence": int(r.confidence)}
    assert len(got) == 3 and got[-1]["confidence"] >= 1


@pytest.mark.parametrize("seed", [61, 62])
def test_track_command_equals_the_library(tmp_path, capsys, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(4):
        xyz, inten, mask = target_frame(rng, [5.0 + 0.2 * i, 2.0])
        paths.append(str(tmp_path / f"t{i}.pcd"))
        write_pcd(paths[-1], xyz[mask], inten[mask])
    tcli.main(["track", *paths, "--device", "cpu"])
    got = _lines(capsys)
    cfg = ttr.TargetConfig()
    st = ttr.TrackerState.create("cpu")
    for i, path in enumerate(paths):
        pcd = read_pcd(path)
        pts, mask = tdevice.pad(pcd["xyz"], cfg.max_points, "cpu")
        iv = np.zeros(cfg.max_points, np.float32)
        iv[:len(pcd["xyz"])] = pcd["fields"]["intensity"]
        st, o = ttr.track_step(st, pts, torch.from_numpy(iv), mask,
                               0.1 * (i + 1), torch.Generator().manual_seed(i),
                               cfg)
        assert got[i] == {
            "frame": i, "valid": bool(o.is_valid), "x": round(float(o.x), 4),
            "y": round(float(o.y), 4), "distance": round(float(o.distance), 4),
            "points": int(o.point_count),
            "track": [round(float(o.track_x), 4), round(float(o.track_y), 4)]}
        assert got[i]["valid"]


def test_lio_sim_command_is_the_demo(capsys):
    argv = ["--scans", "4", "--horizon", "360"]
    tcli.main(["lio-sim", *argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    tdemo.main(["--cpu", *argv])
    want = capsys.readouterr().out.splitlines()

    def steady(lines):   # all but the wall-clock line
        return [x for x in lines if " scans in " not in x]

    assert steady(got) == steady(want) and "ATE RMSE" in "\n".join(got)
    assert len(steady(got)) == len(got) - 1


# ---------------------------------------------------------------------------
# no card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", [
    "heading state", "tracker state", "fusion",
    "cli heading", "cli track", "cli lio-sim",
])
def test_entry_points_raise_without_a_card(tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcd = str(tmp_path / "a.pcd")
    write_pcd(pcd, np.zeros((10, 3), np.float32))
    calls = {
        "heading state": lambda: th.HeadingState.create(),
        "tracker state": lambda: ttr.TrackerState.create(),
        "fusion": lambda: tfu.PointCloudFusion(tfu.FusionConfig()),
        "cli heading": lambda: tcli.main(["heading", pcd]),
        "cli track": lambda: tcli.main(["track", pcd]),
        "cli lio-sim": lambda: tcli.main(["lio-sim", "--scans", "1"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not os.path.exists(str(tmp_path / "trajectory.txt"))
