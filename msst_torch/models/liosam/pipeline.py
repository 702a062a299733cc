"""Host-side orchestration of the LIO-SAM pipeline (port of
``msst_tpu.models.liosam.pipeline.LioSam``): pad raw sensor arrays to the
static shapes, thread the state through the odometry step on the chosen
device, run the loop-closure program at its own lower rate, and collect the
trajectory; export the map (``save_map``) and the IMU-rate pose
(``imu_rate_pose``).

``process_scan`` feeds one scan a step.  ``process_window`` feeds up to
``window`` scans from one host->device copy in one of msst_tpu's four
upload layouts (float32 rows; int16-quantized rows under the default
``quantized_upload``; the int16 range-image grids, per scan or once a
window, for sources that attach ``ranges``/``azimuth``/``col_time``/
``elev``), decoded on the device and stepped slot by slot
(``mapping.select_window_fn``); ``process_window_async`` packs on the
caller's thread and dispatches on one worker thread, one window in flight.
On the card the step launches the CUDA kernels in either form; on the CPU
(``device="cpu"``, as the tests run) their plain twins.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ...ops import imu as imu_ops
from ...ops import se3
from ...ops.pointcloud import Cloud
from ...ops.voxel import voxel_downsample
from ...utils import native, profiling
from ...utils.io_pcd import write_pcd
from ...utils.profiling import span, to_host
from .loop import loop_closure_step
from .mapping import (POINT_QUANT, RI_RANGE_SCALE, odometry_step_packed,
                      ri2_flat_len, ri_flat_width, select_window_fn)
from .params import LioParams
from .state import LioState, init_state

_SENSOR_KEYS = ("imu_t", "imu_gyro", "imu_acc", "imu_rpy", "gps_xyz",
                "gps_sigma")
# the range-image upload hint: a scan carrying all four ships as its grids
_GRID_KEYS = ("ranges", "azimuth", "col_time", "elev")
_Q16_SCALES = np.asarray(POINT_QUANT, np.float32)


@dataclasses.dataclass
class Trajectory:
    times: list
    poses: list  # 4x4 matrices

    def as_matrices(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))

    def ate_rmse(self, gt: np.ndarray, align: bool = True) -> float:
        """Absolute trajectory error against ground-truth positions (N, 3),
        Umeyama-aligned (rotation and translation) like the standard
        KITTI/TUM evaluators."""
        est = self.as_matrices()[:, :3, 3]
        n = min(len(est), len(gt))
        est, gt = est[:n], gt[:n]
        if align and n >= 3:
            mu_e, mu_g = est.mean(0), gt.mean(0)
            H = (est - mu_e).T @ (gt - mu_g)
            U, _, Vt = np.linalg.svd(H)
            d = np.sign(np.linalg.det(Vt.T @ U.T))
            R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
            est = (est - mu_e) @ R.T + mu_g
        return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


class LioSam:
    """Tightly-coupled LiDAR-inertial odometry, one step per scan on
    `device`: the GPU unless the caller asks for ``device="cpu"`` (on a CUDA
    device the scan-to-map correspondences run as the CUDA kernels, on the
    CPU as their plain twins)."""

    def __init__(self, params: Optional[LioParams] = None, device="cuda",
                 window: int = 1, boot_scans: int = 8,
                 readback_interval: Optional[int] = None):
        self.p = params or LioParams()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"LioSam runs on device={str(device)!r} and no CUDA device is "
                "present; pass device='cpu' to run on the CPU")
        # scans a process_window call takes, from one upload
        self.window = max(1, window)
        # loop closure: one attempt every `_loop_every` scans (assuming
        # ~10 Hz scans), after the step of the scan that reaches it
        self.loop_enabled = self.p.loop_closure_enabled
        self._loop_every = max(
            1, int(round(1.0 / max(self.p.loop_closure_frequency, 1e-3) * 10)))
        # dynamic init: the first scan is deskewed with an unknown velocity,
        # so its smeared cloud anchors the map ~v*sweep/2 off the start
        # pose.  Buffer the first `boot_scans` scans, read back the
        # converged velocity, reset, and re-feed with the hint
        # (StepInput.init_vel_*).  msst_tpu boots on 8 scans at window=1 and
        # on its whole first window otherwise (64 scans in bench.py), and
        # so does this class: the boot ends with the window that reaches
        # `boot_scans`.
        self._init_vel = None
        self._boot_scans: Optional[list] = [] if self.p.dynamic_init else None
        self._boot_n = boot_scans
        self.state: LioState = init_state(self.p, self.device)
        self._trajectory = Trajectory([], [])
        self._scan_count = 0
        self._last_scan_time = None
        # device times are float32 offsets from the first received stamp
        # (absolute epoch stamps would collapse every dt in float32)
        self._epoch: Optional[float] = None
        # poses and map telemetry are copied to the host in batches of this
        # many scans (one copy each, not one per scan)
        self._readback_interval = max(
            1, max(8, 4 * self.window) if readback_interval is None
            else readback_interval)
        # (time, pose_matrix, occupancy, dropped) of a scan, or ([times],
        # (W, 4, 4) pose matrices, last slot's occupancy and dropped) of a
        # window
        self._pending: list = []
        self._pending_loops: list = []  # device `found` flags, read lazily
        # a closed loop rewrote keyframe history: the recorded trajectory is
        # stale until the next resync, which the consumers (trajectory,
        # flush) run; the loop pre-gate's radius margin absorbs the stale tail
        self._resync_needed = False
        # capped-structure health: running max of the local-map occupancy
        # and the cumulative overflow-dropped cell count
        self.map_health = {"max_occupancy": 0.0, "dropped_cells": 0}
        self._overflow_warned = False
        # host seconds per stage, summed over the run: the stage spans'
        # clocks (pack, dispatch, flush -> flush_get, resync, loop_attempt
        # -> loop_dispatch), always on
        self.timings: dict = {}
        self._executor = None          # process_window_async's worker
        self._dispatch_future = None

    # -- input assembly -----------------------------------------------------

    def _make_input_np(self, xyz, ring, time_rel, scan_start,
                       imu_t=None, imu_gyro=None, imu_acc=None, imu_rpy=None,
                       gps_xyz=None, gps_sigma=None):
        """Pack one scan into two host arrays (points, aux); layout in
        mapping.unpack_step_input."""
        p = self.p
        n = min(len(xyz), p.max_points)
        points = np.zeros((p.max_points, 5), np.float32)
        points[:n, :3] = np.asarray(xyz, np.float32)[:n]
        points[:n, 3] = np.asarray(time_rel, np.float32)[:n]
        points[:n, 4] = np.asarray(ring, np.float32)[:n]
        aux = self._make_aux_np(n, time_rel, scan_start, imu_t=imu_t,
                                imu_gyro=imu_gyro, imu_acc=imu_acc,
                                imu_rpy=imu_rpy, gps_xyz=gps_xyz,
                                gps_sigma=gps_sigma)
        return points, aux

    def _make_aux_np(self, n, time_rel, scan_start,
                     imu_t=None, imu_gyro=None, imu_acc=None, imu_rpy=None,
                     gps_xyz=None, gps_sigma=None):
        p = self.p
        T = p.imu_window
        if imu_t is None or len(imu_t) == 0:
            imu_t = np.zeros(0, np.float64)
            imu_gyro = np.zeros((0, 3), np.float32)
            imu_acc = np.zeros((0, 3), np.float32)
        # selection + rebasing in float64; only offsets are cast to float32
        scan_start = float(scan_start)
        if self._epoch is None:
            self._epoch = scan_start
        imu_t = np.asarray(imu_t, np.float64)
        imu_gyro = np.asarray(imu_gyro, np.float32)
        imu_acc = np.asarray(imu_acc, np.float32)

        scan_end = scan_start + (float(np.max(time_rel)) if n else 0.1)
        in_scan = (imu_t >= scan_start - 0.01) & (imu_t <= scan_end + 0.01)
        t_prev = (self._last_scan_time if self._last_scan_time is not None
                  else scan_start)
        in_pre = (imu_t >= t_prev) & (imu_t <= scan_start + 0.005)

        aux = np.zeros((2 * T + 3, 8), np.float32)

        def fill(rows, sel):
            k = min(int(sel.sum()), T)
            aux[rows:rows + k, 0] = (imu_t[sel][:k] - self._epoch).astype(np.float32)
            aux[rows:rows + k, 1:4] = imu_gyro[sel][:k]
            aux[rows:rows + k, 4:7] = imu_acc[sel][:k]
            aux[rows:rows + k, 7] = 1.0
            return k

        k_scan = fill(0, in_scan)
        fill(T, in_pre)
        misc = aux[2 * T]
        misc[0] = scan_start - self._epoch
        misc[1] = n
        misc[2] = 1.0 if k_scan > 1 else 0.0
        if imu_rpy is not None:
            misc[3:6] = np.asarray(imu_rpy, np.float32)
        misc[6] = 1.0 if gps_xyz is not None else 0.0
        if gps_xyz is not None:
            aux[2 * T + 1, :3] = np.asarray(gps_xyz, np.float32)
            aux[2 * T + 1, 3:6] = np.asarray(
                gps_sigma if gps_sigma is not None else np.ones(3), np.float32)
        else:
            aux[2 * T + 1, 3:6] = 1.0
        misc[7] = 1.0  # scan-valid flag
        if self._init_vel is not None:
            aux[2 * T + 2, :3] = self._init_vel
            aux[2 * T + 2, 3] = 1.0
        return aux

    def _host_zeros(self, shape, dtype) -> torch.Tensor:
        """A zeroed host buffer for one window's upload: pinned when the
        step runs on the card, so the copy is asynchronous.  Each window
        gets its own; the caching host allocator hands a block out again
        only once the copy that read it has finished."""
        return torch.zeros(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _pack_points_q16(self, xyz, ring, time_rel, out) -> int:
        """One-pass quantized point pack into an int16 row view (the native
        ``pack_scan_q16``; raises where the library does not build)."""
        return native.pack_scan_q16(xyz, time_rel, ring, self.p.max_points,
                                    _Q16_SCALES, out[:self.p.max_points * 5])

    def _pack_window(self, scans):
        """Pack up to `window` scans into one host buffer, in the layout
        msst_tpu's packer picks for them, byte for byte: the range-image
        grids where every scan carries them (and max_points holds a grid),
        else int16 rows under ``quantized_upload``, else float32 rows.
        Returns (buffer, scan times, scan count before the window)."""
        W = self.window
        if not 1 <= len(scans) <= W:
            raise ValueError(f"expected 1..{W} scans, got {len(scans)}")
        p = self.p
        n5 = p.max_points * 5
        a8 = (2 * p.imu_window + 3) * 8
        quant = p.quantized_upload
        if quant and p.max_points >= p.n_scan * p.horizon_scan and all(
                all(k in s for k in _GRID_KEYS) for s in scans):
            return self._pack_window_ri(scans)
        if quant:
            buf = self._host_zeros((W, n5 + 2 * a8), torch.int16)
        else:
            buf = self._host_zeros((W, n5 + a8), torch.float32)
        flat_w = buf.numpy()
        times = []
        prev_count = self._scan_count
        for i, s in enumerate(scans):
            kw = {k: v for k, v in s.items() if k in _SENSOR_KEYS}
            if quant:
                n_i = self._pack_points_q16(s["xyz"], s["ring"],
                                            s["time_rel"], flat_w[i, :n5])
                aux_i = self._make_aux_np(n_i, s["time_rel"],
                                          s["scan_start"], **kw)
                flat_w[i, n5:] = aux_i.reshape(-1).view(np.int16)
            else:
                pts_i, aux_i = self._make_input_np(
                    s["xyz"], s["ring"], s["time_rel"], s["scan_start"], **kw)
                flat_w[i, :n5] = pts_i.reshape(-1)
                flat_w[i, n5:] = aux_i.reshape(-1)
            self._last_scan_time = float(s["scan_start"])
            self._scan_count += 1
            times.append(float(s["scan_start"]))
        return buf, times, prev_count

    def _pack_window_ri(self, scans):
        """Range-image window pack (layouts in mapping.odometry_window_flat_ri
        and _ri2).  Where every scan of the window carries the same azimuth,
        column-time and elevation grids (a fixed firing pattern), the grids
        ship once a window in a 1-D buffer; otherwise each scan carries its
        own."""
        p = self.p
        W = self.window
        S, H = p.n_scan, p.horizon_scan
        n_pix = S * H
        a16 = (2 * p.imu_window + 3) * 8 * 2

        grids = [tuple(np.asarray(s[k], np.float32).reshape(-1)
                       for k in ("azimuth", "col_time", "elev"))
                 for s in scans]
        hoist = all(all(np.array_equal(a, b) for a, b in zip(g, grids[0]))
                    for g in grids[1:])

        def put_f32(dst, o, a, width):
            f = np.zeros(width, np.float32)
            a = np.asarray(a, np.float32).reshape(-1)[:width]
            f[:len(a)] = a
            dst[o:o + 2 * width] = f.view(np.int16)
            return o + 2 * width

        if hoist:
            buf = self._host_zeros(ri2_flat_len(p, W), torch.int16)
            flat_w = buf.numpy()
            o = len(flat_w) - 2 * (2 * H + S)
            o = put_f32(flat_w, o, grids[0][0], H)
            o = put_f32(flat_w, o, grids[0][1], H)
            put_f32(flat_w, o, grids[0][2], S)
        else:
            buf = self._host_zeros((W, ri_flat_width(p)), torch.int16)
            flat_w = buf.numpy()
        times = []
        prev_count = self._scan_count
        for i, s in enumerate(scans):
            kw = {k: v for k, v in s.items() if k in _SENSOR_KEYS}
            r = np.asarray(s["ranges"], np.float32).reshape(-1)[:n_pix]
            rq = np.clip(np.rint(r * RI_RANGE_SCALE), 0, 32767).astype(
                np.int16)
            aux_i = self._make_aux_np(n_pix, s["col_time"], s["scan_start"],
                                      **kw)
            if hoist:
                flat_w[i * n_pix:i * n_pix + len(rq)] = rq
                ao = W * n_pix + i * a16
                flat_w[ao:ao + a16] = aux_i.reshape(-1).view(np.int16)
            else:
                flat_w[i, :len(rq)] = rq
                o = n_pix
                o = put_f32(flat_w[i], o, s["azimuth"], H)
                o = put_f32(flat_w[i], o, s["col_time"], H)
                o = put_f32(flat_w[i], o, s["elev"], S)
                flat_w[i, o:] = aux_i.reshape(-1).view(np.int16)
            self._last_scan_time = float(s["scan_start"])
            self._scan_count += 1
            times.append(float(s["scan_start"]))
        return buf, times, prev_count

    # -- public API ---------------------------------------------------------

    def process_scan(self, xyz, ring, time_rel, scan_start, **sensors):
        """Feed one scan (+ optional imu_t/imu_gyro/imu_acc/imu_rpy/gps_xyz/
        gps_sigma keyword arrays; other keys are ignored); returns the
        StepOutput."""
        sensors = {k: v for k, v in sensors.items() if k in _SENSOR_KEYS}
        self._join_dispatch()  # never race an in-flight async window
        with span("pipeline", (self._scan_count, 1)):
            with span("pack", sink=self.timings, key="pack"):
                points, aux = self._make_input_np(xyz, ring, time_rel,
                                                  scan_start, **sensors)
                with span("upload"):
                    points = torch.from_numpy(points).to(self.device)
                    aux = torch.from_numpy(aux).to(self.device)
            self.state, out = odometry_step_packed(self.state, points, aux,
                                                   self.p)
            self._last_scan_time = float(scan_start)
            self._scan_count += 1
            self._pending.append((scan_start, out.pose_matrix,
                                  out.map_occupancy, out.map_dropped))

            if self._boot_scans is not None:
                self._boot_scans.append(dict(xyz=xyz, ring=ring,
                                             time_rel=time_rel,
                                             scan_start=scan_start, **sensors))
                if self._scan_count >= self._boot_n:
                    res = self._bootstrap_refeed()
                    return res if res is not None else out

            if len(self._pending) >= self._readback_interval:
                self._flush_pending()
            if self.loop_enabled and self._scan_count % self._loop_every == 0:
                self._try_loop_closure()
            return out

    def process_window(self, scans):
        """Feed up to ``window`` scans from one upload.  ``scans`` is a list
        of dicts with keys ``xyz, ring, time_rel, scan_start``, the optional
        sensor keywords of ``process_scan``, and optionally the grids
        ``ranges, azimuth, col_time, elev``.  The same results as
        ``process_scan`` per element under the same upload (the window's
        step is the per-scan step); a partial window is padded with slots
        that pass the state through.  Returns the StepOutput stacked on the
        window axis (padded slots echo the state)."""
        self._join_dispatch()  # never race an in-flight async window
        with span("pipeline", (self._scan_count, len(scans))):
            with span("pack", sink=self.timings, key="pack"):
                packed = self._pack_window(scans)
            outs = self._dispatch_window(*packed)
            if self._boot_scans is not None:
                self._boot_scans.extend(scans)
                if self._scan_count >= self._boot_n:
                    res = self._bootstrap_refeed()
                    return res if res is not None else outs
            return outs

    def process_window_async(self, scans):
        """:meth:`process_window` pipelined: the window is packed here, on
        the caller's thread, and stepped on one worker thread, so the next
        window's packing overlaps this one's step.  Returns a
        ``concurrent.futures.Future[StepOutput]``; windows resolve in feed
        order (one dispatch in flight: the state is a chain).  The worker
        launches on the caller's current CUDA stream.  ``flush()``,
        ``trajectory``, ``save_map``, ``process_scan`` and
        ``process_window`` join it first.  During the dynamic-init boot the
        window runs synchronously (the bootstrap reads the state back)."""
        import concurrent.futures as cf

        if self._boot_scans is not None:
            fut = cf.Future()
            fut.set_result(self.process_window(scans))
            return fut
        if self._executor is None:
            self._executor = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="lio-dispatch")
        with span("pipeline", (self._scan_count, len(scans))):
            with span("pack", sink=self.timings, key="pack"):
                packed = self._pack_window(scans)
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
            fut = self._executor.submit(self._dispatch_on, stream, packed,
                                        profiling.current())
        self._dispatch_future = fut
        return fut

    def _dispatch_on(self, stream, packed, parent=None):
        """The worker's window: a ``pipeline`` span of the window's scans
        under the span that dispatched it (`parent`)."""
        _, times, prev_count = packed
        with span("pipeline", (prev_count, len(times)), parent=parent):
            if stream is None:
                return self._dispatch_window(*packed)
            with torch.cuda.stream(stream):
                return self._dispatch_window(*packed)

    def _join_dispatch(self):
        if self._dispatch_future is not None:
            f, self._dispatch_future = self._dispatch_future, None
            f.result()

    def _dispatch_window(self, buf, times, prev_count):
        """One window: the upload (one copy), the step, the pending pose
        entry, a flush every `readback_interval` scans, and a loop attempt
        where the window crossed a multiple of `loop_every` scans."""
        window_fn = select_window_fn(self.p, buf)
        with span("dispatch", (prev_count, len(times)), sink=self.timings,
                  key="dispatch"):
            with span("upload"):
                flat = buf.to(self.device, non_blocking=True)
            self.state, outs = window_fn(self.state, flat, self.p,
                                         n_valid=len(times))
        self._pending.append((times, outs.pose_matrix,
                              outs.map_occupancy[-1], outs.map_dropped[-1]))
        if len(self._pending) * self.window >= self._readback_interval:
            self._flush_pending()
        count = prev_count + len(times)
        if (self.loop_enabled and count // self._loop_every
                > prev_count // self._loop_every):
            self._try_loop_closure(t_cur=times[-1])
        return outs

    def _bootstrap_refeed(self):
        """Dynamic init second pass: reset the estimator and replay the
        buffered boot scans with the converged velocity as the first-scan
        deskew/filter hint.  Returns the output of the last re-fed scan."""
        from scipy.spatial.transform import Rotation as Rs

        scans = self._boot_scans
        self._boot_scans = None  # the re-feed must not re-trigger
        self._pending_loops.clear()
        self._resync_needed = False
        with span("boot_refeed", (0, len(scans))):
            fs = self.state.filter
            q = to_host(fs.nav.q.double(),
                        "pipeline.boot_attitude").numpy()   # wxyz
            v = to_host(fs.nav.v.double(), "pipeline.boot_velocity").numpy()
            if not (np.isfinite(q).all() and np.isfinite(v).all()
                    and np.linalg.norm(v) < 1e3):
                return None  # keep the first pass; nothing sane to re-feed
            v_b = Rs.from_quat([q[1], q[2], q[3], q[0]]).inv().apply(v)
            self._init_vel = v_b.astype(np.float32)

            self.state = init_state(self.p, self.device)
            self._trajectory = Trajectory([], [])
            self._pending.clear()
            self._scan_count = 0
            self._last_scan_time = None
            out = None
            if self.window > 1:
                for i in range(0, len(scans), self.window):
                    out = self.process_window(scans[i:i + self.window])
            else:
                for s in scans:
                    kw = {k: val for k, val in s.items()
                          if k not in ("xyz", "ring", "time_rel",
                                       "scan_start")}
                    out = self.process_scan(s["xyz"], s["ring"],
                                            s["time_rel"], s["scan_start"],
                                            **kw)
            return out

    def _try_loop_closure(self, t_cur=None):
        """One loop-closure attempt, unless the host pre-gate rules it out.
        Its `found` flag is read at the next flush, where a closed loop
        marks the trajectory for a resync.  `t_cur`: the stamp of the last
        scan stepped (default: the last packed)."""
        with span("loop_gate"):
            plausible = self._loop_plausible(t_cur)
        if not plausible:
            return
        self.state, loop = loop_closure_step(self.state, self.p,
                                             timings=self.timings)
        self._pending_loops.append(loop.found)

    def _loop_plausible(self, t_cur=None) -> bool:
        """Host-side pre-gate: skip the attempt where the candidate search
        (``detectLoopClosureDistance`` :610-643) provably finds nothing.

        * age, exact: keyframe times are a subset of the scan times, so a
          session younger than the age gate has no eligible candidate;
        * radius: the flushed trajectory holds the keyframe positions; if
          no pose old enough lies within the radius plus a margin for the
          unflushed travel (2x the recent speed over the readback lag, +1 m)
          of the latest known pose, none can on the device.  At worst a
          detection moves to the next attempt.  Unknown positions (nothing
          flushed yet) dispatch."""
        p = self.p
        if t_cur is None:
            t_cur = self._last_scan_time
        if t_cur is None or self._epoch is None:
            return True
        if (t_cur - self._epoch) <= p.history_keyframe_search_time_diff:
            return False
        times = self._trajectory.times
        if not times:
            return True
        t = np.asarray(times, np.float64)
        old = (t_cur - t) > p.history_keyframe_search_time_diff
        if not old.any():
            return True
        pos = np.asarray([m[:3, 3] for m in self._trajectory.poses])
        dt_tail = max(t[-1] - t[max(len(t) - 8, 0)], 1e-3)
        v = float(np.linalg.norm(pos[-1] - pos[max(len(t) - 8, 0)])) / dt_tail
        margin = 2.0 * v * max(t_cur - t[-1], 0.0) + 1.0
        d = np.linalg.norm(pos[old] - pos[-1], axis=1)
        return bool((d < p.history_keyframe_search_radius + margin).any())

    def _flush_pending(self):
        """Fetch the pending poses, map telemetry and loop flags in one copy
        each, then check for divergence (reinitialize on a non-finite
        pose)."""
        loops, self._pending_loops = self._pending_loops, []
        scans = None
        if profiling.recording() and profiling.current() is None:
            # a flush of the caller's (trajectory, flush): the pending scans
            n = sum(len(t) if isinstance(t, list) else 1
                    for t, *_ in self._pending)
            scans = (self._scan_count - n, n)
        with span("flush", scans, sink=self.timings, key="flush_get"):
            if loops and to_host(torch.stack(loops).any(),
                                 "pipeline.loop_found", bool):
                self._resync_needed = True
            if not self._pending:
                return
            pending, self._pending = self._pending, []
            times, blocks = [], []
            for t, m, _, _ in pending:
                if isinstance(t, list):   # a window: padded rows drop below
                    times.extend(t)
                    blocks.append(m)
                else:
                    times.append(t)
                    blocks.append(m[None])
            mats_all = to_host(torch.cat(blocks), "pipeline.flush").numpy()
            occ = to_host(torch.stack([o for _, _, o, _ in pending]),
                          "pipeline.flush_occupancy").numpy()
            drop = to_host(torch.stack([d for _, _, _, d in pending]),
                           "pipeline.flush_dropped").numpy()
        rows, off = [], 0
        for (t, *_), m in zip(pending, blocks):
            rows.append(mats_all[off:off + (len(t) if isinstance(t, list)
                                            else 1)])
            off += m.shape[0]
        mats = np.concatenate(rows)
        self._update_map_health(occ, drop)
        if not np.isfinite(mats).all():
            warnings.warn("odometry diverged (non-finite pose); reinitializing")
            self.state = init_state(self.p, self.device)
            self._last_scan_time = None
            self._init_vel = None  # a stale bootstrap hint must not re-apply
            self._resync_needed = False  # a fresh store: nothing to resync
            for t, m in zip(times, mats):  # keep the finite prefix
                if np.isfinite(m).all():
                    self._trajectory.times.append(t)
                    self._trajectory.poses.append(m)
            return
        self._trajectory.times.extend(times)
        self._trajectory.poses.extend(list(mats))

    def _resync_trajectory(self):
        """Rewrite the recorded poses of the keyframe scans from the
        optimized keyframe store (copied to the host once)."""
        with span("resync", (0, self._scan_count), sink=self.timings,
                  key="resync"):
            self._resync_needed = False
            kf = self.state.kf
            n = to_host(kf.count, "pipeline.resync_count", int)
            if n == 0 or not self._trajectory.times:
                return
            mats = se3.Pose.from_vec6(to_host(
                kf.pose6[:n], "pipeline.resync_poses")).to_matrix().numpy()
            # keyframe times are float32 offsets from the epoch, trajectory
            # times absolute float64: match the nearest within half a 10 Hz
            # period
            times = to_host(kf.time[:n], "pipeline.resync_times").numpy(
            ).astype(np.float64) + (self._epoch or 0.0)
            traj_t = np.asarray(self._trajectory.times, np.float64)
            order = np.argsort(traj_t, kind="stable")
            sorted_t = traj_t[order]
            hi = np.searchsorted(sorted_t, times)
            for t, m, j in zip(times, mats, hi):
                best, best_dt = -1, 0.02
                for k in (j - 1, j):
                    if (0 <= k < len(sorted_t)
                            and abs(sorted_t[k] - t) < best_dt):
                        best, best_dt = int(order[k]), abs(sorted_t[k] - t)
                if best >= 0:
                    self._trajectory.poses[best] = m

    def _update_map_health(self, occ, drop):
        """Fold flushed telemetry into map_health; warn once on saturation
        (occupancy > 0.98) or dropped cells — overflow thins the map with a
        spatial bias, so it must not pass silently."""
        h = self.map_health
        max_occ = float(np.max(occ))
        dropped = int(np.max(drop))
        h["max_occupancy"] = max(h["max_occupancy"], max_occ)
        h["dropped_cells"] = max(h["dropped_cells"], dropped)
        if not self._overflow_warned and (max_occ > 0.98 or dropped > 0):
            warnings.warn(
                f"local-map capacity saturated: occupancy {max_occ:.2f}, "
                f"{dropped} cells dropped — raise map_corner_cap/map_surf_cap")
            self._overflow_warned = True

    @property
    def trajectory(self) -> Trajectory:
        """Host trajectory (drains pending device results first)."""
        self.flush()
        return self._trajectory

    def flush(self):
        """Drain pending device results into the host trajectory, and
        resync it after a closed loop."""
        self._join_dispatch()
        self._flush_pending()
        if self._resync_needed:
            self._resync_trajectory()

    def save_map(self, directory: Optional[str] = None,
                 resolution: float = 0.0) -> dict:
        """Terminal map export (the ``save_map`` service,
        ``mapOptmization.cpp:355-419``): returns a dict of numpy arrays
        (trajectory pose6 and times of the keyframes, their corner and surf
        features in the map frame) and, if `directory` is given, writes
        trajectory.txt and the corner, surf and global PCDs (the first two
        voxel-downsampled to `resolution` when it is > 0, on the device)."""
        self.flush()
        kf = self.state.kf
        n = to_host(kf.count, "export.count", int)

        def host(x, what):
            return to_host(x[:n], "export." + what).numpy()

        pose6 = host(kf.pose6, "poses")
        cx, cm = host(kf.corner_xyz, "corner"), host(kf.corner_mask,
                                                      "corner_mask")
        sx, sm = host(kf.surf_xyz, "surf"), host(kf.surf_mask, "surf_mask")
        out = {"trajectory": pose6,
               "times": host(kf.time, "times").astype(np.float64)
               + (self._epoch or 0.0)}
        # in float64, as msst_tpu rotates them, so that the PCDs match
        R = se3.rpy_to_matrix(torch.from_numpy(pose6).double()[:, :3])
        R, t = R.float().numpy(), pose6[:, None, 3:]
        out["corner_map"] = (np.einsum("kij,kpj->kpi", R, cx) + t)[cm]
        out["surf_map"] = (np.einsum("kij,kpj->kpi", R, sx) + t)[sm]
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            np.savetxt(os.path.join(directory, "trajectory.txt"),
                       np.concatenate([out["times"][:, None],
                                       out["trajectory"]], axis=1),
                       header="time roll pitch yaw x y z")
            for name in ("corner_map", "surf_map"):
                pts = out[name]
                if resolution > 0 and len(pts):
                    c = voxel_downsample(Cloud.create(
                        torch.from_numpy(np.ascontiguousarray(pts)).to(
                            self.device)), resolution)
                    pts = to_host(c.xyz[c.mask], "export.map").numpy()
                write_pcd(os.path.join(directory, f"{name}.pcd"), pts)
            write_pcd(os.path.join(directory, "global_map.pcd"),
                      np.concatenate([out["corner_map"], out["surf_map"]]))
        return out

    def imu_rate_pose(self, imu_t, imu_gyro, imu_acc):
        """The latest optimized state composed with the IMU increments since
        the last scan: the smooth high-rate ``odometry/imu`` output (the
        reference's TransformFusion, ``imuPreintegration.cpp:23-154``).
        Returns (se3.Pose on the device, velocity as numpy (3,))."""
        self._join_dispatch()  # read a settled filter state
        fs = self.state.filter
        T = self.p.imu_window
        t = np.asarray(imu_t, np.float64)[-T:]
        epoch = (self._epoch if self._epoch is not None
                 else t[0] if len(t) else 0.0)
        t = (t - epoch).astype(np.float32)
        g = np.asarray(imu_gyro, np.float32)[-T:]
        a = np.asarray(imu_acc, np.float32)[-T:]
        k = len(t)
        pad = T - k

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        pre = imu_ops.preintegrate(
            dev(np.pad(t, (0, pad))), dev(np.pad(g, ((0, pad), (0, 0)))),
            dev(np.pad(a, ((0, pad), (0, 0)))), dev(np.arange(T) < k),
            fs.bias, self.p.imu_params)
        nav = imu_ops.predict(fs.nav, pre, fs.bias, fs.bias, self.p.imu_params)
        return se3.Pose(nav.q, nav.p), to_host(nav.v,
                                               "imu_rate.velocity").numpy()
