"""The port's packet decoder against msst_tpu's: the numpy decoders bit for
bit on the golden stream and on rich configurations (every per-laser
correction, azimuth windows, ``hide_rings``, the TM16 denoiser, the banked
64-laser layout); the native C++ decoder (``msst_torch/native/
msst_native.cc``, built here by g++ at its first use) within 2e-3 of numpy
with rings and validity equal, as msst_tpu holds its own native decoder
(tests/test_io.py); the pcap reader on a pcap made here; the live-capture
and ring-buffer functions of the library; ``packets_to_scan``; and
``packets_to_fixed_frame`` on the CPU within 1e-5 m of msst_tpu's.  A failed
build raises, and nothing decodes with numpy unless ``force_numpy`` asks.
"""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch

import chip_smoke
from msst_torch.utils import native
from msst_torch.utils import packets as tp
from msst_tpu.utils import packets as jp
from tests.test_io import make_packet

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_packets.bin")
NATIVE_ATOL = 2e-3
AZIMUTH_STEP_DEG = 0.01 + 1e-6   # the packets' azimuth quantum
FIXED_FRAME_ATOL = 1e-5
KEYS = ("x", "y", "z", "intensity", "time_us", "azimuth_deg")


def _rich(cls, **over):
    kw = dict(
        rot_correction_deg=tuple(np.linspace(-2.0, 2.0, 16)),
        dist_correction=tuple(np.linspace(-0.05, 0.08, 16)),
        two_pt_correction_available=(1,) * 8 + (0,) * 8,
        dist_correction_x=tuple(np.linspace(0.01, 0.06, 16)),
        dist_correction_y=tuple(np.linspace(-0.04, 0.02, 16)),
        vert_offset_correction=tuple(np.linspace(-0.02, 0.02, 16)),
        horiz_offset_correction=tuple(np.linspace(-0.03, 0.03, 16)),
        focal_distance=(1000.0,) * 16, focal_slope=(0.5,) * 16,
        min_intensity=(2.0,) * 16, max_intensity=(250.0,) * 16)
    kw.update(over)
    return cls(**kw)


def _configs(cls):
    vert64 = tuple(np.linspace(-24.0, 2.0, 64))
    return {
        "default": cls(),
        "rich": _rich(cls),
        "windows, hide_rings": _rich(cls, hide_rings=(0, 3, 7, 15),
                                     azimuth_windows=((300.0, 40.0),
                                                      (90.0, 200.0))),
        "tm16 filter": _rich(cls, filter_threshold=(1, 10, 10, 10)),
        "banked 64": cls(num_lasers=64, vert_angles_deg=vert64,
                         rot_correction_deg=tuple(np.linspace(-1, 1, 64)),
                         azimuth_windows=((10.0, 350.0),), hide_rings=(5,)),
    }


def _stream():
    """The golden stream, then 8 packets of a second sweep: banked flags on
    half of them, a bad flag, azimuth wrap-around and dropouts."""
    rng = np.random.default_rng(21)
    golden = np.fromfile(GOLDEN, np.uint8).reshape(4, 1206)
    more = []
    for k in range(8):
        azs = (350.0 + k * 2.4 + np.arange(12) * 0.2) % 360.0
        dists = rng.uniform(0.3, 120.0, (12, 32))
        dists[rng.uniform(size=dists.shape) < 0.05] = 0.0
        flags = [0xEEFF if (b + k) % 2 else 0xDDFF for b in range(12)] \
            if k % 2 else None
        if k == 5:
            flags = [0xEEFF] * 7 + [0x1234] + [0xEEFF] * 4
        more.append(np.frombuffer(make_packet(azs, dists=dists, flags=flags,
                                              intensity=int(10 + 20 * k)),
                                  np.uint8))
    return np.concatenate([golden, np.stack(more)])


@pytest.mark.parametrize("name", list(_configs(tp.DecoderConfig)))
def test_numpy_decoder_bit_equal(name):
    pk = _stream()
    tc, jc = _configs(tp.DecoderConfig)[name], _configs(jp.DecoderConfig)[name]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    got, want = tp.decode_packets_numpy(pk, tc), jp.decode_packets_numpy(pk, jc)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    forced = tp.decode_packets(pk, tc, force_numpy=True)
    for k in want:
        np.testing.assert_array_equal(forced[k], want[k], err_msg=k)


def test_golden_fixture_decodes_as_recorded():
    exp = np.load(os.path.join(os.path.dirname(GOLDEN),
                               "golden_packets_expected.npz"))
    pk = np.fromfile(GOLDEN, np.uint8).reshape(4, 1206)
    out = tp.decode_packets_numpy(pk, _configs(tp.DecoderConfig)["rich"])
    for k in exp.files:
        np.testing.assert_array_equal(out[k], exp[k], err_msg=k)


@pytest.mark.parametrize("name", list(_configs(tp.DecoderConfig)))
def test_native_decoder_within_tolerance(name):
    pk = _stream()
    cfg = _configs(tp.DecoderConfig)[name]
    nat = tp.decode_packets(pk, cfg)
    ref = tp.decode_packets_numpy(pk, cfg)
    np.testing.assert_array_equal(nat["valid"], ref["valid"])
    np.testing.assert_array_equal(nat["ring"], ref["ring"])
    v = ref["valid"]
    assert v.sum() > 20
    for k in KEYS[:-1]:
        np.testing.assert_allclose(nat[k][v], ref[k][v], rtol=0,
                                   atol=NATIVE_ATOL, err_msg=k)
    # the native decoder rounds the interpolated azimuth in float32, numpy
    # in float64: a firing at a half-centidegree lands one step apart (one
    # point of this stream, in msst_tpu's two decoders alike)
    step = np.abs(nat["azimuth_deg"][v] - ref["azimuth_deg"][v])
    np.testing.assert_allclose(step, 0.0, rtol=0, atol=AZIMUTH_STEP_DEG)
    assert (step > NATIVE_ATOL).sum() <= max(1, v.sum() // 1000)


def test_native_decoder_checks_the_packet_shape():
    pk = _stream()
    for bad in (pk[:, :1200], pk.reshape(-1), pk[None]):
        with pytest.raises(ValueError, match="1206"):
            tp.decode_packets(bad)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int decode_packets( {\n")
    with pytest.raises(RuntimeError, match="broken.cc"):
        native.build(bad)
    assert not native.library_path(bad).exists()
    # no quiet fallback: without a library, decode_packets raises
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="broken.cc"):
        tp.decode_packets(_stream())
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "SOURCE", tmp_path / "other.cc")
    (tmp_path / "other.cc").write_text("int f() { return 0; }\n")
    with pytest.raises(OSError):
        native.build(tmp_path / "other.cc")


def test_pcap_reader(tmp_path):
    pk = _stream()
    stamps = 1.7e9 + 0.25 + np.arange(len(pk)) * 0.00118
    path = str(tmp_path / "drive.pcap")
    chip_smoke._write_pcap(path, pk, stamps)
    got, st = native.read_pcap(path, 100)
    np.testing.assert_array_equal(got, pk)
    np.testing.assert_allclose(st, stamps, rtol=0, atol=1e-6)
    got, st = native.read_pcap(path, 5)
    np.testing.assert_array_equal(got, pk[:5])
    (tmp_path / "not.pcap").write_bytes(b"\x00" * 64)
    with pytest.raises(OSError, match="pcap read failed"):
        native.read_pcap(str(tmp_path / "not.pcap"), 10)
    with pytest.raises(OSError):
        native.read_pcap(str(tmp_path / "missing.pcap"), 10)


def test_udp_capture_and_ring_buffer():
    lib = native.load()
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    fd = lib.udp_open(port, 1 << 20)
    assert fd >= 0
    pk = _stream()
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for p in pk[:3]:
            tx.sendto(p.tobytes(), ("127.0.0.1", port))
        tx.sendto(b"short", ("127.0.0.1", port))
        tx.close()
        out = np.zeros((8, 1206), np.uint8)
        n = lib.udp_recv_batch(fd, out.ctypes.data, 8, 200)
    finally:
        lib.udp_close(fd)
    assert n == 3
    np.testing.assert_array_equal(out[:3], pk[:3])

    ring = lib.ring_create(4)
    try:
        pushed = [lib.ring_push(ring, p.ctypes.data, 10.0 + i)
                  for i, p in enumerate(np.ascontiguousarray(pk[:6]))]
        assert pushed == [1, 1, 1, 1, 0, 0] and lib.ring_size(ring) == 4
        out = np.zeros((8, 1206), np.uint8)
        st = np.zeros(8)
        assert lib.ring_pop_batch(ring, out.ctypes.data, st.ctypes.data, 3) == 3
        np.testing.assert_array_equal(out[:3], pk[:3])
        np.testing.assert_array_equal(st[:3], [10.0, 11.0, 12.0])
        assert lib.ring_size(ring) == 1
    finally:
        lib.ring_destroy(ring)


@pytest.mark.parametrize("with_stamps", [False, True])
def test_packets_to_scan(with_stamps):
    pk = _stream()
    stamps = 5.0 + np.arange(len(pk)) * 0.0013 if with_stamps else None
    cfg = _configs(tp.DecoderConfig)["rich"]
    got = tp.packets_to_scan(pk, cfg, stamps, force_numpy=True)
    want = jp.packets_to_scan(pk, _configs(jp.DecoderConfig)["rich"], stamps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    nat = tp.packets_to_scan(pk, cfg, stamps)
    np.testing.assert_array_equal(nat[1], want[1])
    np.testing.assert_allclose(nat[0], want[0], rtol=0, atol=NATIVE_ATOL)
    np.testing.assert_allclose(nat[2], want[2], rtol=0, atol=1e-6)


def _timeline(n_pkt):
    t = 1000.0 + np.arange(n_pkt + 1) * 0.004
    rng = np.random.default_rng(22)
    poses6 = np.zeros((n_pkt + 1, 6), np.float32)
    poses6[:, :3] = np.cumsum(rng.normal(scale=0.05, size=(n_pkt + 1, 3)), 0)
    poses6[:, 3:] = np.cumsum(rng.normal(scale=0.2, size=(n_pkt + 1, 3)), 0)
    return t, poses6


@pytest.mark.parametrize("per_point", [True, False])
def test_packets_to_fixed_frame_against_msst_tpu(per_point):
    pk = _stream()
    stamps = 1000.0 + 0.001 + np.arange(len(pk)) * 0.003
    pose_t, poses6 = _timeline(len(pk))
    got = tp.packets_to_fixed_frame(pk, stamps, pose_t, poses6,
                                    per_point_times=per_point, device="cpu",
                                    force_numpy=True)
    want = jp.packets_to_fixed_frame(pk, stamps, pose_t, poses6,
                                     per_point_times=per_point)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FIXED_FRAME_ATOL)
    assert np.abs(got[0]).max() > 10.0
    nat = tp.packets_to_fixed_frame(pk, stamps, pose_t, poses6,
                                    per_point_times=per_point, device="cpu")
    np.testing.assert_allclose(nat[0], want[0], rtol=0, atol=NATIVE_ATOL)


def test_fixed_frame_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk = _stream()
    pose_t, poses6 = _timeline(len(pk))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.packets_to_fixed_frame(pk, pose_t[:-1], pose_t, poses6)


def test_config_tables_and_status_angles_equal():
    for name, tc in _configs(tp.DecoderConfig).items():
        jc = _configs(jp.DecoderConfig)[name]
        t, j = tc.laser_tables(), jc.laser_tables()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert tc.azimuth_windows_cd() == jc.azimuth_windows_cd()
    new = tuple(a + 0.5 for a in tp.DecoderConfig().vert_angles_deg)
    assert tp.DecoderConfig().with_status_vertical_angles(new) \
        .vert_angles_deg == new
    with pytest.raises(ValueError, match="vertical angles"):
        tp.DecoderConfig().with_status_vertical_angles(new[:8])
