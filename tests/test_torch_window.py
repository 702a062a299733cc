"""Windowed dispatch (``LioSam(window=W)``, ``process_window`` and its
async form) of the port against msst_tpu's, on the tiny-profile circle drive
(16 scans, seed 5) at W = 4.

msst_tpu's ``odometry_core`` reads an undefined name ``inp`` where it means
its prepared scan ``ps`` (mapping.py:1295-1301), so every trace of its window
step raises NameError.  Its window programs are run here without editing
it: a test-local ``_window_core`` (msst_tpu's ``lax.scan`` of ``lax.cond``)
binds ``mapping.inp = ps`` only while it traces, and replaces
``mapping._window_core`` for the duration of the fixture, as
tests/test_torch_slice.py does for the single-scan step.

Held against msst_tpu:

* ``range_image.deskew_grid`` to 1e-6, and against the port's per-point
  ``deskew`` on the same grid to 1e-5 (tests/test_range_image.py's check);
* ``frontend.run_frontend_grid`` on a simulated scan's grids: the same
  feature counts and masks, the corner cloud and its firing times to 1e-5,
  the surface cloud (per-voxel means, summed in another order by msst_tpu)
  to 1e-4;
* ``_pack_window`` byte for byte in all four layouts (range-image grids once
  a window, per scan where one scan's grids differ by one ulp, int16 rows,
  float32 rows), on full and partial windows; ``_ri_points`` to 1e-5;
* the window drive in the ``ri2`` and q16 layouts, two ways, as
  tests/test_torch_slice.py holds the single-scan step: each of msst_tpu's
  recorded windows (its state before the window + the uploaded buffer)
  through the port's decoder (the same decoder is chosen; per slot up to
  the window's first keyframe the same keyframe decision, iterations,
  degeneracy, keyframe count, surface count, corner count (within one on
  the grid layout), pose to 1e-4; after it, see the test), and
  the drive as a whole (the same keyframe times, both within 0.15 m of the
  truth, loop attempts after the same scans).

The port alone: W = 4 with ``quantized_upload=False`` is bit-equal to
W = 1 for both scan-to-map methods; the async feed is bit-equal to the
synchronous one; a partial window echoes the last pose; the bootstrap
replays its whole first window; the int16 point packer is bit-equal to the
numpy formula and raises where its library does not build.
"""

import jax
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.models.liosam import LioSam as TLioSam
from msst_torch.models.liosam import frontend as tfront
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam.params import tiny_params as ttiny
from msst_torch.ops import range_image as tri
from msst_torch.utils import native
from msst_tpu.models.liosam import frontend as jfront
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.models.liosam import pipeline as jpipe
from msst_tpu.models.liosam.params import tiny_params as jtiny
from msst_tpu.ops import range_image as jri
from msst_tpu.utils import sim

W = 4
N_SCANS = 16
GT_ERR_M = 0.15
DRIVE_GAP_M = 0.08     # tests/test_torch_slice.py's drive gap
# one loop attempt every 7 scans: windows of 4 cross a multiple of 7 at
# some windows and not at others (msst_tpu folds the frequency out of its
# compiled programs' key, so this costs no compile)
LOOP_FREQ = 10.0 / 7.0
SCAN_KEYS = ("xyz", "ring", "time_rel", "scan_start", "imu_t", "imu_gyro",
             "imu_acc", "imu_rpy")
GRID_KEYS = ("ranges", "azimuth", "col_time", "elev")
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops, many of them: one torch thread while this module runs
    (the suite's parallel workers would oversubscribe the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive():
    return sim.make_dataset(sim.World(),
                            sim.SimTrajectory(kind="circle", radius=10.0,
                                              speed=2.0),
                            n_scans=N_SCANS, scan_dt=0.1, n_scan=16,
                            horizon=360, seed=5)


def _batch(scans, grids=True):
    keys = SCAN_KEYS + (GRID_KEYS if grids else ())
    return [{k: s[k] for k in keys} for s in scans]


def _windows(data, grids=True, w=W):
    return [_batch(data[i:i + w], grids) for i in range(0, len(data), w)]


def _gt(data):
    return np.stack([s["gt_pose"][:3, 3] - data[0]["gt_pose"][:3, 3]
                     for s in data])


def _binding_window_core(state, preps, valid_w, p):
    """msst_tpu's ``_window_core`` with ``mapping.inp`` bound to the slot's
    prepared scan while ``odometry_core`` traces (see the module docstring)."""

    def body(st, pv):
        ps, valid = pv

        def core(s):
            jmap.inp = ps
            try:
                return jmap.odometry_core(s, ps, p)
            finally:
                del jmap.inp

        return jax.lax.cond(valid, core,
                            lambda s: (s, jmap._passthrough_output(s, p)), st)

    return jax.lax.scan(body, state, (preps, valid_w))


def _record_reference(data, grids):
    """msst_tpu's LioSam(window=W) over the drive, recording every window
    (decoder, state before it, uploaded buffer, outputs) and the scan count
    at every loop attempt."""
    p = jtiny(loop_closure_enabled=True, loop_closure_frequency=LOOP_FREQ)
    calls, attempts = [], []
    select = jmap.select_window_fn
    try_loop = jpipe.LioSam._try_loop_closure

    def recording_select(p_, flat_w):
        fn = select(p_, flat_w)

        def run(state, flat, p__):
            before = jax.tree.map(np.asarray, state)  # the state is donated
            new_state, outs = fn(state, flat, p__)
            calls.append((fn.__name__, before, np.asarray(flat),
                          jax.tree.map(np.asarray, outs)))
            return new_state, outs

        return run

    def counting_try(self):
        attempts.append(self._scan_count)
        return try_loop(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(jmap, "_window_core", _binding_window_core)
    mp.setattr(jmap, "select_window_fn", recording_select)
    mp.setattr(jpipe.LioSam, "_try_loop_closure", counting_try)
    try:
        lio = jpipe.LioSam(p, window=W)
        for batch in _windows(data, grids):
            lio.process_window(batch)
        traj = lio.trajectory.as_matrices()[:, :3, 3]
        n = int(lio.state.kf.count)
        kf_time = np.asarray(lio.state.kf.time)[:n]
    finally:
        mp.undo()
    return dict(calls=calls, attempts=attempts, traj=traj, kf_time=kf_time)


@pytest.fixture(scope="module")
def reference(drive):
    """msst_tpu's drives in the ri2 (grids attached) and q16 layouts."""
    return {"ri2": _record_reference(drive, grids=True),
            "q16": _record_reference(drive, grids=False)}


def _port(p=None, **kw):
    p = p or ttiny(loop_closure_enabled=True,
                   loop_closure_frequency=LOOP_FREQ)
    return TLioSam(p, device="cpu", window=kw.pop("window", W), **kw)


# ---------------------------------------------------------------------------
# the grid frontend
# ---------------------------------------------------------------------------


def _gyro_window(T=24):
    t = np.linspace(0.0, 0.1, T).astype(np.float32)
    gyro = RNG.normal(size=(T, 3)).astype(np.float32) * 0.5
    return t, gyro


def test_deskew_grid_matches_reference_and_per_point():
    T, S, H = 24, 6, 50
    t, gyro = _gyro_window(T)
    xyz = RNG.normal(size=(S, H, 3)).astype(np.float32) * 5.0
    # columns before, inside and past the IMU window (the clamps)
    tcol = np.linspace(-0.01, 0.13, H).astype(np.float32)
    jt, jr = jri.imu_rotation_timeline(jri.ImuWindow(
        jax.numpy.asarray(t), jax.numpy.asarray(gyro),
        jax.numpy.zeros((T, 3)), jax.numpy.ones(T, bool)))
    tt, tr = tri.imu_rotation_timeline(tri.ImuWindow(
        torch.from_numpy(t), torch.from_numpy(gyro), torch.zeros(T, 3),
        torch.ones(T, dtype=torch.bool)))
    t0, on = torch.tensor(0.01), torch.tensor(True)
    want = np.asarray(jri.deskew_grid(
        jax.numpy.asarray(xyz), jax.numpy.asarray(tcol), jt, jr,
        jax.numpy.asarray(T), t_start=jax.numpy.asarray(0.01)))
    got = tri.deskew_grid(torch.from_numpy(xyz), torch.from_numpy(tcol), tt,
                          tr, torch.tensor(T), t0, on)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    flat = tri.deskew(torch.from_numpy(xyz.reshape(-1, 3)),
                      t0 + torch.from_numpy(np.tile(tcol, S)), tt, tr,
                      torch.tensor(T), t0, on)
    np.testing.assert_allclose(got.numpy().reshape(-1, 3), flat.numpy(),
                               atol=1e-5)
    assert np.abs(got.numpy() - xyz).max() > 1e-3   # it did rotate
    off = tri.deskew_grid(torch.from_numpy(xyz), torch.from_numpy(tcol), tt,
                          tr, torch.tensor(T), t0, torch.tensor(False))
    np.testing.assert_array_equal(off.numpy(), xyz)


def _scan_aux(lio_cls, p, s, **kw):
    """One scan's aux rows as each package's packer makes them."""
    lio = lio_cls(p, **kw)
    return lio._make_aux_np(p.n_scan * p.horizon_scan, s["col_time"],
                            s["scan_start"], imu_t=s["imu_t"],
                            imu_gyro=s["imu_gyro"], imu_acc=s["imu_acc"],
                            imu_rpy=s["imu_rpy"])


def test_run_frontend_grid_matches_reference(drive):
    """The grid frontend on scan 3's grids (rings 0 and 15 fail the range
    gate where the beam misses; the IMU turns the sensor): the same feature
    counts and masks, clouds and firing-time attrs to 1e-5."""
    s = drive[3]
    p_j, p_t = jtiny(), ttiny()
    aux = _scan_aux(jpipe.LioSam, p_j, s)
    np.testing.assert_array_equal(
        _scan_aux(TLioSam, p_t, s, device="cpu"), aux)
    S, H = p_t.n_scan, p_t.horizon_scan
    grids = [np.asarray(s[k], np.float32) for k in GRID_KEYS]
    grids[0] = grids[0].reshape(S, H)

    @jax.jit
    def ref(r, az, tcol, elev, aux):
        sc = jmap.unpack_step_input(jax.numpy.zeros((0, 5)), aux, p_j).scan
        return jfront.run_frontend_grid(
            r, az, tcol, elev, sc.scan_start, sc.imu_t, sc.imu_gyro,
            sc.imu_acc, sc.imu_mask, sc.imu_available, p_j, carry_time=True)

    want = jax.tree.map(np.asarray, ref(*grids, aux))
    sc = tmap.unpack_step_input(torch.zeros(0, 5), torch.from_numpy(aux),
                                p_t).scan
    got = tfront.run_frontend_grid(
        *(torch.from_numpy(g) for g in grids), sc.scan_start, sc.imu_t,
        sc.imu_gyro, sc.imu_acc, sc.imu_mask, sc.imu_available, p_t)
    assert int(got.n_corner) == int(want.n_corner) > 20
    assert int(got.n_surf) == int(want.n_surf) > 200
    # corners are picked points; surface points are per-voxel means, which
    # msst_tpu takes as differences of float32 prefix sums over the cloud
    # (2.2e-5 apart here; tests/test_torch_frontend.py holds the same means
    # of the point-row frontend to 1e-4)
    for g, w, atol in ((got.corner, want.corner, 1e-5),
                       (got.surf, want.surf, 1e-4)):
        np.testing.assert_array_equal(g.mask.numpy(), w.mask)
        np.testing.assert_allclose(g.xyz.numpy()[w.mask], w.xyz[w.mask],
                                   atol=atol)
        np.testing.assert_allclose(g.attrs.numpy()[w.mask],
                                   w.attrs[w.mask], atol=atol)


def test_ri_points_match_reference():
    p = ttiny()
    S, H = p.n_scan, p.horizon_scan
    r = RNG.uniform(0.0, 60.0, (2, S * H)).astype(np.float32)
    az = RNG.uniform(-np.pi, np.pi, (2, H)).astype(np.float32)
    tcol = RNG.uniform(0.0, 0.1, (2, H)).astype(np.float32)
    elev = RNG.uniform(-0.3, 0.3, (2, S)).astype(np.float32)
    want = np.asarray(jmap._ri_points(*(jax.numpy.asarray(x)
                                        for x in (r, az, tcol, elev)),
                                      jtiny()))
    got = tmap._ri_points(*(torch.from_numpy(x) for x in (r, az, tcol, elev)),
                          p).numpy()
    assert got.shape == want.shape == (2, p.max_points, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[:, :, 3:], want[:, :, 3:])


# ---------------------------------------------------------------------------
# the packers
# ---------------------------------------------------------------------------


def _jitter(batch):
    """The second scan's azimuths one ulp off: the grids cannot be hoisted."""
    batch = [dict(s) for s in batch]
    batch[1]["azimuth"] = np.nextafter(np.asarray(batch[1]["azimuth"]),
                                       np.float32(np.inf))
    return batch


@pytest.mark.parametrize("layout,quant,grids,n,shape", [
    ("ri2", True, True, 4, "1-D"),
    ("ri2", True, True, 3, "1-D"),
    ("ri", True, "jitter", 4, "rows"),
    ("q16", True, False, 4, "rows"),
    ("q16", True, False, 2, "rows"),
    ("f32", False, True, 4, "rows"),
])
def test_pack_window_bit_equal(drive, layout, quant, grids, n, shape):
    """Two windows packed by each package's LioSam (the second's aux rows
    depend on the first's last stamp): the same bytes, the same decoder."""
    p_j = jtiny(quantized_upload=quant)
    p_t = ttiny(quantized_upload=quant)
    lj = jpipe.LioSam(p_j, window=W)
    lt = TLioSam(p_t, device="cpu", window=W)
    names = {"ri2": "odometry_window_flat_ri2",
             "ri": "odometry_window_flat_ri",
             "q16": "odometry_window_flat_q16", "f32": "odometry_window_flat"}
    for scans in (drive[:W], drive[W:W + n]):
        batch = _batch(scans, grids is not False)
        if grids == "jitter":
            batch = _jitter(batch)
        want, jtimes, jprev = lj._pack_window(batch)
        got, ttimes, tprev = lt._pack_window(batch)
        got = got.numpy()
        assert (got.ndim == 1) == (shape == "1-D")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
        assert ttimes == jtimes and tprev == jprev
        assert (tmap.select_window_fn(p_t, torch.from_numpy(got)).__name__
                == jmap.select_window_fn(p_j, want).__name__
                == names[layout])


def test_q16_packer_matches_numpy_and_raises_without_library(
        tmp_path, monkeypatch):
    """The native packer against ``clip(rint(x * s), +-32767)``, bit for
    bit, with points past 128 m and times past 2 s clipped and a short scan
    zero-padded; a library that does not build raises, with no fallback."""
    n, cap = 900, 1000
    xyz = RNG.uniform(-150, 150, (n, 3)).astype(np.float32)
    xyz[:5] = [[0.5 / 256, 1.5 / 256, -2.5 / 256]] * 5   # ties: half to even
    t = RNG.uniform(-2.5, 2.5, n).astype(np.float32)
    ring = RNG.integers(0, 64, n)
    scales = np.asarray(tmap.POINT_QUANT, np.float32)
    out = np.full(cap * 5, 7, np.int16)
    assert native.pack_scan_q16(xyz, t, ring, cap, scales, out) == n
    pts = np.zeros((cap, 5), np.float32)
    pts[:n, :3], pts[:n, 3], pts[:n, 4] = xyz, t, ring
    want = np.clip(np.rint(pts * scales), -32767, 32767).astype(np.int16)
    np.testing.assert_array_equal(out, want.reshape(-1))
    assert (np.abs(want) == 32767).any()
    bad = tmp_path / "broken.cc"
    bad.write_text("void pack_scan_q16( {\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    lio = TLioSam(ttiny(), device="cpu", window=W)
    with pytest.raises(RuntimeError, match="broken.cc"):
        lio._pack_window(_batch([_bare_scan(xyz, t, ring)], grids=False))


def _bare_scan(xyz, t, ring):
    return {"xyz": xyz, "ring": ring, "time_rel": t, "scan_start": 100.0,
            "imu_t": None, "imu_gyro": None, "imu_acc": None,
            "imu_rpy": None}


# ---------------------------------------------------------------------------
# the window drive against msst_tpu
# ---------------------------------------------------------------------------


def _assert_slot_matches(got, want, i, corner_slack):
    assert bool(got.is_keyframe[i]) == bool(want.is_keyframe[i])
    assert int(got.s2m_iterations[i]) == int(want.s2m_iterations[i])
    assert bool(got.degenerate[i]) == bool(want.degenerate[i])
    assert int(got.kf_count[i]) == int(want.kf_count[i])
    assert abs(int(got.n_corner[i]) - int(want.n_corner[i])) <= corner_slack
    assert int(got.n_surf[i]) == int(want.n_surf[i])
    np.testing.assert_allclose(got.pose6[i].numpy(), want.pose6[i],
                               atol=1e-4)


@pytest.mark.parametrize("layout", ["ri2", "q16"])
def test_windows_match_reference(reference, layout):
    """Each recorded window of msst_tpu (its state before the window and
    the buffer it uploaded) through the port's decoder: the same decoder,
    and per slot the same step results up to the window's first keyframe
    (the boot's first pass and its re-feed included).

    A slot after a keyframe inside the window steps from the port's own
    keyframe insert, whose stored surface cloud (per-voxel means) lies up
    to 2.2e-5 m from msst_tpu's (msst_tpu sums each voxel as a difference
    of float32 prefix sums); the tiny profile's 3-point voxel planes then
    move the next registration by millimetres (measured 1.9e-3 to 2.8e-2
    m).  From msst_tpu's own post-keyframe state the port's step lands
    within 7.7e-7 m of it, and msst_tpu's window program equals its
    single-scan step chained, bit for bit.  Those slots are held to the
    keyframe decision and to tests/test_torch_slice.py's drive gap.

    The grid layout reconstructs xyz through cos and sin of the azimuths,
    whose float32 results differ in the last bit between XLA and torch on
    14 (cos) and 28 (sin) of the 360 columns; a corner at the curvature
    threshold then flips, so the corner count may differ by one there
    (measured on 4 of 24 slots, their poses within 1.4e-6 m)."""
    calls = reference[layout]["calls"]
    assert len(calls) == 6    # 2 boot windows, their re-feed, 2 more
    p = ttiny(loop_closure_enabled=True)
    n_kf = n_reg = n_strict = 0
    for name, state_np, flat, want in calls:
        flat_t = torch.from_numpy(flat)
        fn = tmap.select_window_fn(p, flat_t)
        assert fn.__name__ == name
        _, got = fn(convert.from_numpy(state_np, "cpu"), flat_t, p)
        assert got.pose6.shape == (W, 6)
        after_kf = False
        for i in range(W):
            if after_kf:
                assert bool(got.is_keyframe[i]) == bool(want.is_keyframe[i])
                np.testing.assert_allclose(got.pose6[i].numpy(),
                                           want.pose6[i], atol=DRIVE_GAP_M)
            else:
                _assert_slot_matches(got, want, i,
                                     corner_slack=int(layout == "ri2"))
                n_strict += 1
            after_kf |= bool(want.is_keyframe[i])
            n_kf += bool(want.is_keyframe[i])
            n_reg += int(want.s2m_iterations[i]) > 0
    assert n_kf >= 3 and n_reg >= N_SCANS and n_strict >= 12


@pytest.mark.parametrize("layout", ["ri2", "q16"])
def test_window_drive_matches_reference(drive, reference, layout):
    """The whole drive, each package threading its own state: the same
    keyframes (their scan times), both within 0.15 m of the truth, and the
    loop attempts after the same scans (msst_tpu's count at each)."""
    ref = reference[layout]
    lio = _port()
    attempts = []
    inner = lio._try_loop_closure

    def counting(t_cur=None):
        attempts.append(lio._scan_count)
        return inner(t_cur)

    lio._try_loop_closure = counting
    for batch in _windows(drive, grids=layout == "ri2"):
        lio.process_window(batch)
    traj = lio.trajectory.as_matrices()[:, :3, 3]
    n = int(lio.state.kf.count)
    np.testing.assert_array_equal(lio.state.kf.time[:n].numpy(),
                                  ref["kf_time"])
    gt = _gt(drive)
    assert traj.shape == ref["traj"].shape == (N_SCANS, 3)
    assert np.linalg.norm(traj - gt, axis=1).max() < GT_ERR_M
    assert np.linalg.norm(ref["traj"] - gt, axis=1).max() < GT_ERR_M
    # the boot's two windows cross 7, its re-feed crosses 7 again, then
    # 12 does not cross 14 and 16 does
    assert attempts == ref["attempts"] == [8, 8, 16]


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------


def _drive_port(lio, data, w, grids, asyn=False):
    outs = []
    if w == 1 and not grids:
        for s in data:
            outs.append(lio.process_scan(**{k: s[k] for k in SCAN_KEYS}))
    else:
        feed = lio.process_window_async if asyn else lio.process_window
        outs = [feed(b) for b in _windows(data, grids, w)]
    return lio.trajectory.as_matrices(), outs


def _kf_store(lio):
    n = int(lio.state.kf.count)
    return lio.state.kf.pose6[:n].numpy(), lio.state.kf.time[:n].numpy()


@pytest.mark.parametrize("method", ["voxel", "knn"])
def test_window_bit_equal_to_single_scans(drive, method):
    """quantized_upload=False and no grids: the window carries the scans'
    float32 rows, and W = 4 gives the bits of W = 1 (the boot of 8 scans is
    two whole windows)."""
    p = ttiny(loop_closure_enabled=False, quantized_upload=False,
              scan2map_method=method)
    one = _port(p, window=1)
    four = _port(p)
    t1, _ = _drive_port(one, drive, 1, grids=False)
    t4, _ = _drive_port(four, drive, W, grids=False)
    assert t1.shape == (N_SCANS, 4, 4)
    np.testing.assert_array_equal(t4, t1)
    for a, b in zip(_kf_store(four), _kf_store(one)):
        np.testing.assert_array_equal(a, b)


def test_async_bit_equal_to_sync(drive):
    """process_window_async (the boot's windows run synchronously, the rest
    on the worker): the same trajectory and window outputs, bit for bit."""
    sync, asyn = _port(), _port()
    ts, outs_s = _drive_port(sync, drive, W, grids=True)
    ta, futs = _drive_port(asyn, drive, W, grids=True, asyn=True)
    np.testing.assert_array_equal(ta, ts)
    assert asyn._executor is not None and asyn._dispatch_future is None
    for s, f in zip(outs_s[2:], futs[2:]):
        np.testing.assert_array_equal(f.result().pose6.numpy(),
                                      s.pose6.numpy())
    for a, b in zip(_kf_store(asyn), _kf_store(sync)):
        np.testing.assert_array_equal(a, b)


def test_partial_window_echoes_last_pose(drive):
    """A window of 2 scans in W = 4: the padded slots echo the state of the
    last real one and count as no scan."""
    lio = _port()
    for batch in _windows(drive[:12], grids=True):
        lio.process_window(batch)
    out = lio.process_window(_batch(drive[12:14]))
    for i in (2, 3):
        np.testing.assert_array_equal(out.pose6[i].numpy(),
                                      out.pose6[1].numpy())
        np.testing.assert_array_equal(out.pose_matrix[i].numpy(),
                                      out.pose_matrix[1].numpy())
        assert not bool(out.is_keyframe[i])
        assert int(out.s2m_iterations[i]) == 0 == int(out.n_corner[i])
        assert int(out.kf_count[i]) == int(out.kf_count[1])
    assert int(out.s2m_iterations[1]) > 0
    traj = lio.trajectory
    assert len(traj.times) == 14 and lio._scan_count == 14
    np.testing.assert_array_equal(traj.poses[-1], out.pose_matrix[1].numpy())


def test_bootstrap_replays_whole_first_window(drive):
    """With boot_scans=2 at W = 4 the boot ends with the first window, and
    its re-feed replays all 4 scans of it; without quantization the result
    is bit-equal to W = 1 booting on 4 scans (as chip_smoke's W = 64 drive
    against its W = 1 drive booting on 64)."""
    p = ttiny(loop_closure_enabled=False, quantized_upload=False)
    four = _port(p, boot_scans=2)
    out = four.process_window(_batch(drive[:W], grids=False))
    assert four._boot_scans is None and four._init_vel is not None
    assert four._scan_count == W and out.pose6.shape == (W, 6)
    for b in _windows(drive[W:], grids=False):
        four.process_window(b)
    one = _port(p, window=1, boot_scans=W)
    t1, _ = _drive_port(one, drive, 1, grids=False)
    np.testing.assert_array_equal(four.trajectory.as_matrices(), t1)
    np.testing.assert_array_equal(one._init_vel, four._init_vel)
