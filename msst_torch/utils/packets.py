"""Vendor LiDAR packet decoding (host-side).

Rebuild of the driver stack ``timoo/`` + ``tmlidar_ws/`` (the two
Velodyne-style vendor forks): 1206-byte UDP packets of 12 blocks x (2-byte
bank flag, 2-byte azimuth in 0.01 deg, 32 x [2-byte distance, 1-byte
intensity]).

Behavior sources (all in ``timoo/src/timoo_pointcloud/src/lib/rawdata.cc``):

* TM16 dual-firing unpack with per-point azimuth interpolation and the
  block-skip rules on angle overflow (``unpack_tm16`` :520-745),
* generic multi-bank unpack for 32/64-laser devices (``unpack`` :306-519;
  lower bank 0xDDFF = lasers 32..63),
* full per-laser correction math: rot correction, distance correction,
  two-point distance interpolation, horiz/vert offsets, focal-curve
  intensity correction (:334-460 and the TM16 copy :620-735),
* firing timings: full cycle 49.152 us, single firing 3.072 us, offsets
  rebased to the packet END (``buildTimings`` :148-199 — note the
  ``- single_packet_cycle`` term),
* ``hide_line`` semantics: listed rings are RESTRICTED to the azimuth
  windows; unlisted rings bypass the window entirely (:212-214, window test
  :601-618).  In the generic path the window applies to every point.
* the TM16 3-tap per-ring denoise filter (``filter_tm16`` :748-796,
  thresholds from the launch files, e.g. ``launch/TM16.launch:35``).

Two implementations behind one API:
* the C++ batch decoder, ``msst_torch/native/msst_native.cc`` via ctypes,
  built at its first use (``utils/native.py``; a failed build raises), and
* a vectorized NumPy decoder (same outputs), where a caller asks for it
  with ``force_numpy=True``.

Both decode a whole scan's packet batch at once; the pipeline consumes the
resulting arrays directly.  ``packets_to_fixed_frame`` re-projects on the
card (``device="cuda"``) unless the caller asks for the CPU.

The port's own copy of ``msst_tpu.utils.packets``, held equal to it by
tests/test_torch_packets.py (the port imports nothing of msst_tpu).
Unlike msst_tpu's, ``decode_packets`` never falls back to numpy quietly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PACKET_SIZE = 1206
BLOCKS_PER_PACKET = 12
CHANNELS_PER_BLOCK = 32
UPPER_BANK = 0xEEFF
LOWER_BANK = 0xDDFF
BLOCK_FLAG = UPPER_BANK  # back-compat alias

# VLP-16-class vertical angles (degrees), ring order laser id 0..15
VLP16_VERT_ANGLES = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    dtype=np.float32,
)
# laser id -> ring index (sorted by elevation, like Calibration::read's
# laser_ring ranking, calibration.cc:167-187)
VLP16_RING = np.argsort(VLP16_VERT_ANGLES).argsort().astype(np.int32)

# timing constants (rawdata.cc buildTimings :158-159: full firing cycle
# 49.152 us, single firing 3.072 us; TM16_BLOCK_TDURATION = 98.304 us,
# single-return packet cycle 1179.648 us = 24 firing cycles)
FIRING_CYCLE_US = 49.152
SINGLE_FIRING_US = 3.072

# two-point distance-interpolation anchors (rawdata.cc:409-419: corrections
# measured at 25.04 m vs 2.40 m (x) / 1.93 m (y))
_TWO_PT_FAR = 25.04
_TWO_PT_NEAR_X = 2.4
_TWO_PT_NEAR_Y = 1.93


def _ring_rank(vert):
    vert = np.asarray(vert, np.float32)
    return np.argsort(vert, kind="stable").argsort().astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static decode parameters + per-laser calibration tables.

    Per-laser tuples may be empty (= all zeros / defaults) or length
    ``num_lasers``.  Angles: ``vert_angles_deg`` in degrees,
    ``rot_correction_deg`` in degrees (the reference stores radians
    internally; `calibration_io.decoder_config_from_calibration` converts).
    """

    num_lasers: int = 16              # 16 = TM16 dual-firing; 32/64 = banked
    distance_resolution: float = 0.002
    min_range: float = 0.4
    max_range: float = 130.0
    vert_angles_deg: tuple = tuple(VLP16_VERT_ANGLES.tolist())
    # --- per-laser corrections (rawdata.cc:334-460; calibration.h:51-73)
    rot_correction_deg: tuple = ()
    dist_correction: tuple = ()       # meters, added to decoded distance
    two_pt_correction_available: tuple = ()  # bools
    dist_correction_x: tuple = ()
    dist_correction_y: tuple = ()
    vert_offset_correction: tuple = ()
    horiz_offset_correction: tuple = ()
    focal_distance: tuple = ()
    focal_slope: tuple = ()
    min_intensity: tuple = ()         # default 0
    max_intensity: tuple = ()         # default 255
    # --- timing (buildTimings :148-199)
    firing_cycle_us: float = FIRING_CYCLE_US
    single_firing_us: float = SINGLE_FIRING_US
    # --- filters
    hide_rings: tuple = ()            # `hide_line`: rings restricted to the
                                      # azimuth windows (rawdata.cc:212-214)
    # kept azimuth sectors in degrees [(min, max), ...]; a window with
    # min > max wraps through 0 (setup() :208-238 left/right windows)
    azimuth_windows: tuple = ((0.0, 360.0),)
    # TM16 3-tap denoiser thresholds (4 distance bands); () disables.
    # Launch files use (1,10,10,10) or (10,10,10,10); the code default
    # "0,0,0,0" would emit nothing (rawdata.cc:71-75, :760-788).
    filter_threshold: tuple = ()

    def with_status_vertical_angles(self, vertical_angle_list_deg
                                    ) -> "DecoderConfig":
        """Live ``timooStatus`` consumption: the convert node overrides the
        per-laser vertical angles from the device's status/DIFOP message at
        runtime (``convert.cc:75-76`` -> ``RawData::unpackDifop``,
        ``rawdata.cc:489-505`` — degrees in, radians recomputed).  Returns a
        new config; feed it to the decoder for subsequent packets."""
        angles = tuple(float(a) for a in vertical_angle_list_deg)
        if len(angles) != self.num_lasers:
            raise ValueError(
                f"status carries {len(angles)} vertical angles, decoder has "
                f"{self.num_lasers} lasers")
        return dataclasses.replace(self, vert_angles_deg=angles)

    def laser_tables(self):
        """Dense per-laser arrays (num_lasers,) for the decode math."""
        L = self.num_lasers

        def arr(t, default=0.0):
            a = np.full(L, default, np.float32)
            t = tuple(t)
            if t:
                a[: len(t)] = np.asarray(t[:L], np.float32)
            return a

        vert = arr(self.vert_angles_deg)
        return {
            "vert_rad": np.radians(vert),
            "ring": _ring_rank(vert),
            "rot_rad": np.radians(arr(self.rot_correction_deg)),
            "dist": arr(self.dist_correction),
            "two_pt": arr(self.two_pt_correction_available) > 0.5,
            "dist_x": arr(self.dist_correction_x),
            "dist_y": arr(self.dist_correction_y),
            "vert_off": arr(self.vert_offset_correction),
            "horiz_off": arr(self.horiz_offset_correction),
            "focal_dist": arr(self.focal_distance),
            "focal_slope": arr(self.focal_slope),
            "min_int": arr(self.min_intensity, 0.0),
            "max_int": arr(self.max_intensity, 255.0),
        }

    def azimuth_windows_cd(self):
        """Validated windows in integer centidegrees (setup() :218-238:
        out-of-range or min==max windows open up to the full circle)."""
        wins = []
        for lo, hi in self.azimuth_windows:
            if not (0 <= lo <= 360) or not (0 <= hi <= 360) or lo == hi:
                lo, hi = 0.0, 360.0
            wins.append((int(round(lo * 100)), int(round(hi * 100))))
        return wins or [(0, 36000)]


def _in_windows(az_cd: np.ndarray, windows) -> np.ndarray:
    """Azimuth-window test with wraparound (unpack :351-364, :601-618)."""
    ok = np.zeros(az_cd.shape, bool)
    for lo, hi in windows:
        if lo < hi:
            ok |= (az_cd >= lo) & (az_cd <= hi)
        else:  # wraps through 0
            ok |= (az_cd <= hi) | (az_cd >= lo)
    return ok


def _correction_math(raw_dist, az_cd, laser, intensity_raw, cfg, tab,
                     tm16_intensity_quirk):
    """The shared per-point correction pipeline (rawdata.cc:334-460).

    raw_dist: uint distance counts; az_cd: int centidegree azimuth;
    laser: per-point laser ids.  Returns x, y, z (ROS frame), intensity,
    corrected distance.
    """
    dist = raw_dist.astype(np.float32) * cfg.distance_resolution + \
        tab["dist"][laser]

    az_rad = az_cd.astype(np.float32) * (np.pi / 18000.0)
    # cos(a-b)/sin(a-b) expansion with the per-laser rot correction (:373-381)
    ang = az_rad - tab["rot_rad"][laser]
    cos_rot = np.cos(ang).astype(np.float32)
    sin_rot = np.sin(ang).astype(np.float32)

    cos_v = np.cos(tab["vert_rad"])[laser].astype(np.float32)
    sin_v = np.sin(tab["vert_rad"])[laser].astype(np.float32)
    v_off = tab["vert_off"][laser]
    h_off = tab["horiz_off"][laser]

    xy = dist * cos_v - v_off * sin_v
    xx = np.abs(xy * sin_rot - h_off * cos_rot)
    yy = np.abs(xy * cos_rot + h_off * sin_rot)

    # two-point linear interpolation of the distance correction (:404-421)
    dc, dcx, dcy = tab["dist"][laser], tab["dist_x"][laser], tab["dist_y"][laser]
    corr_x = (dc - dcx) * (xx - _TWO_PT_NEAR_X) / (_TWO_PT_FAR - _TWO_PT_NEAR_X) \
        + dcx - dc
    corr_y = (dc - dcy) * (yy - _TWO_PT_NEAR_Y) / (_TWO_PT_FAR - _TWO_PT_NEAR_Y) \
        + dcy - dc
    avail = tab["two_pt"][laser]
    corr_x = np.where(avail, corr_x, 0.0).astype(np.float32)
    corr_y = np.where(avail, corr_y, 0.0).astype(np.float32)

    dist_x = dist + corr_x
    dist_y = dist + corr_y
    x = (dist_x * cos_v - v_off * sin_v) * sin_rot - h_off * cos_rot
    y = (dist_y * cos_v - v_off * sin_v) * cos_rot + h_off * sin_rot
    z = dist_y * sin_v + v_off * cos_v

    # ROS right-hand frame swap (:454-456)
    x_ros, y_ros, z_ros = y, -x, z

    # focal-curve intensity correction + clamp (:460-473)
    fo = 256.0 * (1.0 - tab["focal_dist"][laser] / 13100.0) ** 2
    if tm16_intensity_quirk:
        # the TM16 path divides the raw uint by 65535 in INTEGER math
        # (rawdata.cc:718: `tmp.uint / 65535`), so the term is 256 except at
        # exactly 65535 — reproduced faithfully
        term = 256.0 * (1.0 - (raw_dist.astype(np.int64) // 65535)) ** 2
    else:
        term = 256.0 * (1.0 - raw_dist.astype(np.float32) / 65535.0) ** 2
    inten = intensity_raw.astype(np.float32) + \
        tab["focal_slope"][laser] * np.abs(fo - term)
    inten = np.clip(inten, tab["min_int"][laser], tab["max_int"][laser])
    return (x_ros.astype(np.float32), y_ros.astype(np.float32),
            z_ros.astype(np.float32), inten.astype(np.float32),
            dist.astype(np.float32))


def _parse_body(packets):
    P = packets.shape[0]
    assert packets.shape[1] == PACKET_SIZE
    body = packets[:, : BLOCKS_PER_PACKET * 100].reshape(P, BLOCKS_PER_PACKET, 100)
    flag = body[:, :, 0].astype(np.uint16) | (body[:, :, 1].astype(np.uint16) << 8)
    rot = (body[:, :, 2].astype(np.int64) | (body[:, :, 3].astype(np.int64) << 8))
    ch = body[:, :, 4:].reshape(P, BLOCKS_PER_PACKET, CHANNELS_PER_BLOCK, 3)
    dist_raw = ch[..., 0].astype(np.uint32) | (ch[..., 1].astype(np.uint32) << 8)
    inten_raw = ch[..., 2]
    return flag, rot, dist_raw, inten_raw


def _decode_tm16_numpy(packets, cfg):
    """TM16 dual-firing decode (unpack_tm16 :520-745)."""
    P = packets.shape[0]
    flag, rot, dist_raw, inten_raw = _parse_body(packets)
    tab = cfg.laser_tables()

    # a non-UPPER_BANK header aborts the REST of the packet (:540-549)
    bad = flag != UPPER_BANK
    first_bad = np.where(bad.any(axis=1), bad.argmax(axis=1), BLOCKS_PER_PACKET)
    blk_ok = np.arange(BLOCKS_PER_PACKET)[None, :] < first_bad[:, None]

    # per-block azimuth step with the angle-overflow fallback (:551-580):
    # negative diff -> reuse last positive diff, or skip the block
    az_diff = np.zeros((P, BLOCKS_PER_PACKET), np.float32)
    last = np.zeros(P, np.float32)
    for b in range(BLOCKS_PER_PACKET):
        if b < BLOCKS_PER_PACKET - 1:
            rd = rot[:, b + 1] - rot[:, b]
            d = ((36000 + rd) % 36000).astype(np.float32)
            neg = rd < 0
            use_last = neg & (last > 0)
            skip = neg & ~(last > 0)
            d = np.where(use_last, last, d)
            blk_ok[:, b] &= ~skip
            az_diff[:, b] = d
            last = np.where(skip, last, d)
        else:
            az_diff[:, b] = last

    # per-point interpolated azimuth (:585-591): fraction of the block
    # duration by firing sequence position
    c = np.arange(CHANNELS_PER_BLOCK)
    dsr = c % 16
    firing = c // 16
    frac = (dsr * cfg.single_firing_us + firing * cfg.firing_cycle_us) / \
        (2.0 * cfg.firing_cycle_us)
    # floor(x+0.5) == C's round() for the positive angles here (np.round
    # would banker's-round .5 cases differently from the native decoder)
    az_cd = (np.floor(rot[:, :, None] + az_diff[:, :, None] * frac[None, None, :]
                      + 0.5).astype(np.int64)) % 36000

    laser = np.broadcast_to(dsr, az_cd.shape)
    x, y, z, inten, dist = _correction_math(
        dist_raw, az_cd, laser, inten_raw, cfg, tab, tm16_intensity_quirk=True)

    ring = tab["ring"][laser]
    valid = blk_ok[:, :, None] & (dist >= cfg.min_range) & (dist <= cfg.max_range)

    # hide_line: listed rings keep only azimuth-window points (:601-618)
    if cfg.hide_rings:
        hidden = np.isin(ring, np.asarray(cfg.hide_rings, np.int32))
        valid &= ~hidden | _in_windows(az_cd, cfg.azimuth_windows_cd())

    # timing offsets rebased to packet end (buildTimings :160-176)
    seq = 2 * np.arange(BLOCKS_PER_PACKET)[:, None] + firing[None, :]
    t_us = (seq * cfg.firing_cycle_us + (dsr[None, :] + 1) * cfg.single_firing_us
            - 2 * BLOCKS_PER_PACKET * cfg.firing_cycle_us)
    t_us = np.broadcast_to(t_us[None], dist.shape).astype(np.float32)

    # optional 3-tap per-ring denoiser (filter_tm16 :748-796): the stream per
    # ring is one point per firing; processing point k emits point k-2 when
    # both neighbor deltas are below the band threshold of point k's distance
    if cfg.filter_threshold and any(t > 0 for t in cfg.filter_threshold):
        thr = np.asarray((tuple(cfg.filter_threshold) + (0,) * 4)[:4], np.float32)
        # (F, 16) firing-major streams per dsr (== per ring for TM16)
        dstream = dist.reshape(P * BLOCKS_PER_PACKET * 2, 16)
        F = dstream.shape[0]
        emit = np.zeros((F, 16), bool)
        if F >= 4:
            d_km3, d_km2, d_km1, d_k = (dstream[:-3], dstream[1:-2],
                                        dstream[2:-1], dstream[3:])
            delta1 = np.abs(d_km3 - d_km2) * 200.0
            delta2 = np.abs(d_km1 - d_km2) * 200.0
            band = np.select(
                [d_k < 2.56, d_k < 5.12, d_k < 10.24],
                [8 * 0.1 * thr[0], 26 * 0.1 * thr[1], 48 * 0.1 * thr[2]],
                default=1024 * 0.1 * thr[3]).astype(np.float32)
            emit[1:F - 2] = (delta1 < band) & (delta2 < band)
        valid &= emit.reshape(valid.shape)

    return {
        "x": x.reshape(-1), "y": y.reshape(-1), "z": z.reshape(-1),
        "intensity": inten.reshape(-1),
        "ring": ring.reshape(-1).astype(np.int32),
        "time_us": t_us.reshape(-1),
        "azimuth_deg": (az_cd.astype(np.float32) / 100.0).reshape(-1),
        "valid": valid.reshape(-1),
    }


def _decode_banked_numpy(packets, cfg):
    """Generic 32/64-laser decode (unpack :306-519): upper bank 0xEEFF =
    lasers 0..31, lower bank 0xDDFF = 32..63; block azimuth used directly;
    the azimuth window applies to every point; no per-point timings
    (buildTimings :178-181 supports only TM16)."""
    P = packets.shape[0]
    flag, rot, dist_raw, inten_raw = _parse_body(packets)
    tab = cfg.laser_tables()

    bank = np.where(flag == LOWER_BANK, 32, 0)            # (P, 12)
    known = (flag == UPPER_BANK) | (flag == LOWER_BANK)
    laser = (bank[:, :, None] + np.arange(CHANNELS_PER_BLOCK)[None, None, :])
    laser = np.minimum(laser, cfg.num_lasers - 1)
    in_device = (bank[:, :, None] + np.arange(CHANNELS_PER_BLOCK)[None, None, :]
                 ) < cfg.num_lasers

    az_cd = np.broadcast_to(rot[:, :, None] % 36000,
                            (P, BLOCKS_PER_PACKET, CHANNELS_PER_BLOCK))
    x, y, z, inten, dist = _correction_math(
        dist_raw, az_cd, laser, inten_raw, cfg, tab, tm16_intensity_quirk=False)

    valid = (known[:, :, None] & in_device & (dist_raw > 0)   # :342-346
             & _in_windows(az_cd, cfg.azimuth_windows_cd())   # :351-364
             & (dist >= cfg.min_range) & (dist <= cfg.max_range))
    ring = tab["ring"][laser]
    if cfg.hide_rings:
        valid &= ~np.isin(ring, np.asarray(cfg.hide_rings, np.int32))

    return {
        "x": x.reshape(-1), "y": y.reshape(-1), "z": z.reshape(-1),
        "intensity": inten.reshape(-1),
        "ring": ring.reshape(-1).astype(np.int32),
        "time_us": np.zeros(valid.size, np.float32),
        "azimuth_deg": (az_cd.astype(np.float32) / 100.0).reshape(-1),
        "valid": valid.reshape(-1),
    }


def decode_packets_numpy(packets: np.ndarray, cfg: DecoderConfig = DecoderConfig()):
    """packets: (P, 1206) uint8.  Returns dict of flat (P*12*32,) arrays
    (x, y, z, intensity, ring, time_us, azimuth_deg, valid)."""
    if cfg.num_lasers == 16:
        return _decode_tm16_numpy(packets, cfg)
    return _decode_banked_numpy(packets, cfg)


def _native_cfg_struct(cfg: DecoderConfig):
    """Mirror of DecCfg in msst_native.cc (kept in lockstep)."""
    import ctypes

    MAXL = 64

    class DecCfg(ctypes.Structure):
        _fields_ = [
            ("num_lasers", ctypes.c_int),
            ("distance_resolution", ctypes.c_float),
            ("min_range", ctypes.c_float),
            ("max_range", ctypes.c_float),
            ("firing_cycle_us", ctypes.c_float),
            ("single_firing_us", ctypes.c_float),
            ("n_windows", ctypes.c_int),
            ("win_lo", ctypes.c_int * 4),
            ("win_hi", ctypes.c_int * 4),
            ("hide_mask", ctypes.c_uint64),
            ("filter_enabled", ctypes.c_int),
            ("filter_threshold", ctypes.c_float * 4),
            ("vert_rad", ctypes.c_float * MAXL),
            ("rot_rad", ctypes.c_float * MAXL),
            ("dist_corr", ctypes.c_float * MAXL),
            ("two_pt", ctypes.c_float * MAXL),
            ("dist_x", ctypes.c_float * MAXL),
            ("dist_y", ctypes.c_float * MAXL),
            ("vert_off", ctypes.c_float * MAXL),
            ("horiz_off", ctypes.c_float * MAXL),
            ("focal_dist", ctypes.c_float * MAXL),
            ("focal_slope", ctypes.c_float * MAXL),
            ("min_int", ctypes.c_float * MAXL),
            ("max_int", ctypes.c_float * MAXL),
            ("ring", ctypes.c_int * MAXL),
        ]

    tab = cfg.laser_tables()
    s = DecCfg()
    s.num_lasers = cfg.num_lasers
    s.distance_resolution = cfg.distance_resolution
    s.min_range = cfg.min_range
    s.max_range = cfg.max_range
    s.firing_cycle_us = cfg.firing_cycle_us
    s.single_firing_us = cfg.single_firing_us
    wins = cfg.azimuth_windows_cd()[:4]
    s.n_windows = len(wins)
    for i, (lo, hi) in enumerate(wins):
        s.win_lo[i] = lo
        s.win_hi[i] = hi
    mask = 0
    for r in cfg.hide_rings:
        if 0 <= int(r) < 64:
            mask |= 1 << int(r)
    s.hide_mask = mask
    ft = tuple(cfg.filter_threshold)
    s.filter_enabled = 1 if (ft and any(t > 0 for t in ft)) else 0
    for i in range(4):
        s.filter_threshold[i] = float(ft[i]) if i < len(ft) else 0.0

    def fill(field, arr):
        dst = getattr(s, field)
        for i in range(cfg.num_lasers):
            dst[i] = float(arr[i])

    fill("vert_rad", tab["vert_rad"])
    fill("rot_rad", tab["rot_rad"])
    fill("dist_corr", tab["dist"])
    fill("two_pt", tab["two_pt"].astype(np.float32))
    fill("dist_x", tab["dist_x"])
    fill("dist_y", tab["dist_y"])
    fill("vert_off", tab["vert_off"])
    fill("horiz_off", tab["horiz_off"])
    fill("focal_dist", tab["focal_dist"])
    fill("focal_slope", tab["focal_slope"])
    fill("min_int", tab["min_int"])
    fill("max_int", tab["max_int"])
    for i in range(cfg.num_lasers):
        s.ring[i] = int(tab["ring"][i])
    return s


def decode_packets(packets: np.ndarray, cfg: DecoderConfig = DecoderConfig(),
                   force_numpy: bool = False):
    """Decode a packet batch with the native C++ decoder, built at its first
    use (a failed build raises), or with the numpy decoder where
    ``force_numpy`` asks for it.  Both paths honor the FULL DecoderConfig
    (corrections, windows, hide_line, filter) and produce the same outputs
    (tested)."""
    if force_numpy:
        return decode_packets_numpy(packets, cfg)

    import ctypes

    from . import native

    if packets.ndim != 2 or packets.shape[1] != PACKET_SIZE:
        raise ValueError(f"packets must be (P, {PACKET_SIZE}) bytes, got "
                         f"{packets.shape}")
    lib = native.load()
    P = packets.shape[0]
    n = P * BLOCKS_PER_PACKET * CHANNELS_PER_BLOCK
    pk = np.ascontiguousarray(packets, np.uint8)
    s = _native_cfg_struct(cfg)
    x = np.empty(n, np.float32)
    y = np.empty(n, np.float32)
    z = np.empty(n, np.float32)
    inten = np.empty(n, np.float32)
    ring = np.empty(n, np.int32)
    t_us = np.empty(n, np.float32)
    az = np.empty(n, np.float32)
    valid = np.empty(n, np.uint8)
    lib.decode_packets(
        pk.ctypes.data, P, ctypes.byref(s),
        x.ctypes.data, y.ctypes.data, z.ctypes.data,
        inten.ctypes.data, ring.ctypes.data, t_us.ctypes.data,
        az.ctypes.data, valid.ctypes.data,
    )
    return {"x": x, "y": y, "z": z, "intensity": inten, "ring": ring,
            "time_us": t_us, "azimuth_deg": az, "valid": valid.astype(bool)}


def packets_to_scan(packets: np.ndarray, cfg: DecoderConfig = DecoderConfig(),
                    stamps=None, force_numpy: bool = False):
    """Decode + compact to the (xyz, ring, time_rel) arrays the LIO frontend
    takes (the convert-node role, ``convert.cc:126``).

    ``stamps``: optional per-packet capture times (seconds, e.g. from
    ``pcap_read_packets``).  Per-point times combine the packet stamp with
    the in-packet firing offset, like the reference's
    ``timing_offsets[i][j] + (pkt.stamp - scan_start)`` (rawdata.cc:736-738).
    Without stamps, packets are assumed back-to-back at the single-return
    packet cycle (24 firing cycles).  ``force_numpy`` as in
    :func:`decode_packets`."""
    d = decode_packets(packets, cfg, force_numpy)
    P = packets.shape[0]
    if stamps is None:
        packet_cycle_s = 2 * BLOCKS_PER_PACKET * cfg.firing_cycle_us * 1e-6
        stamps = np.arange(P, dtype=np.float64) * packet_cycle_s
    stamps = np.asarray(stamps, np.float64)
    per_point_stamp = np.repeat(stamps - stamps.min(),
                                BLOCKS_PER_PACKET * CHANNELS_PER_BLOCK)
    t_abs = per_point_stamp + d["time_us"].astype(np.float64) * 1e-6

    v = d["valid"]
    xyz = np.stack([d["x"][v], d["y"][v], d["z"][v]], axis=1)
    t = t_abs[v]
    t0 = t.min() if len(t) else 0.0
    return xyz, d["ring"][v], (t - t0).astype(np.float32), d["intensity"][v]


def packets_to_fixed_frame(packets: np.ndarray, stamps,
                           pose_times, poses6,
                           cfg: DecoderConfig = DecoderConfig(),
                           per_point_times: bool = True, device="cuda",
                           force_numpy: bool = False):
    """Decode a packet batch and re-project every point into a fixed frame
    given a sensor pose timeline — the transform node
    (``transform.cc:28-74``), which re-projects each packet by the TF at its
    stamp instead of assuming one rigid scan.

    stamps: (P,) per-packet capture times; pose_times: (M,) ascending;
    poses6: (M, 6) (roll,pitch,yaw,x,y,z) sensor poses in the fixed frame.
    per_point_times=True adds the in-packet firing offsets to each point's
    time before interpolation (finer than the reference's per-packet TF).
    The interpolation runs on `device`: the card unless the caller asks for
    the CPU (raises where it names CUDA and no CUDA device is present).
    Returns numpy (xyz_fixed, ring, intensity)."""
    import torch

    from ..models.calibration.device import resolve
    from ..ops import se3
    from ..ops.pointcloud import transform_to_fixed_frame

    dev = resolve(device)
    d = decode_packets(packets, cfg, force_numpy)
    stamps = np.asarray(stamps, np.float64)
    t = np.repeat(stamps, BLOCKS_PER_PACKET * CHANNELS_PER_BLOCK)
    if per_point_times:
        t = t + d["time_us"].astype(np.float64) * 1e-6
    v = d["valid"]
    xyz = np.stack([d["x"][v], d["y"][v], d["z"][v]], axis=1)

    pose_times = np.asarray(pose_times, np.float64)
    epoch = pose_times[0]

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    poses = se3.Pose.from_vec6(on_dev(poses6))
    out = transform_to_fixed_frame(on_dev(xyz), on_dev(t[v] - epoch),
                                   on_dev(pose_times - epoch), poses.q, poses.t)
    return out.cpu().numpy(), d["ring"][v], d["intensity"][v]
