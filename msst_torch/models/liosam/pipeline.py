"""Host-side orchestration of the LIO-SAM pipeline (port of
``msst_tpu.models.liosam.pipeline.LioSam`` at window=1): pad raw sensor
arrays to the static shapes, thread the state through the odometry step on
the chosen device, run the loop-closure program at its own lower rate, and
collect the trajectory.

Not ported yet, and refused where selected: windowed dispatch (window > 1,
ROADMAP item L4)."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ...ops import se3
from .loop import loop_closure_step
from .mapping import odometry_step_packed
from .params import LioParams
from .state import LioState, init_state

_SENSOR_KEYS = ("imu_t", "imu_gyro", "imu_acc", "imu_rpy", "gps_xyz",
                "gps_sigma")
# poses and map telemetry are copied to the host in batches of this many
# scans (one copy each, not one per scan)
_READBACK_INTERVAL = 8


@dataclasses.dataclass
class Trajectory:
    times: list
    poses: list  # 4x4 matrices

    def as_matrices(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))


class LioSam:
    """Tightly-coupled LiDAR-inertial odometry, one step per scan on
    `device`: the GPU unless the caller asks for ``device="cpu"`` (on a CUDA
    device the scan-to-map correspondences run as the CUDA kernels, on the
    CPU as their plain twins)."""

    def __init__(self, params: Optional[LioParams] = None, device="cuda",
                 window: int = 1, boot_scans: int = 8):
        self.p = params or LioParams()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"LioSam runs on device={str(device)!r} and no CUDA device is "
                "present; pass device='cpu' to run on the CPU")
        if window != 1:
            raise NotImplementedError(
                f"window={window}: windowed dispatch is not ported yet "
                "(ROADMAP item L4); use window=1")
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
        # on its whole first window otherwise (64 scans in bench.py).
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
        self._pending: list = []  # (time, pose_matrix, occupancy, dropped)
        self._pending_loops: list = []  # device `found` flags, read lazily
        # a closed loop rewrote keyframe history: the recorded trajectory is
        # stale until the next resync, which the consumers (trajectory,
        # flush) run; the loop pre-gate's radius margin absorbs the stale tail
        self._resync_needed = False
        # capped-structure health: running max of the local-map occupancy
        # and the cumulative overflow-dropped cell count
        self.map_health = {"max_occupancy": 0.0, "dropped_cells": 0}
        self._overflow_warned = False

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

    # -- public API ---------------------------------------------------------

    def process_scan(self, xyz, ring, time_rel, scan_start, **sensors):
        """Feed one scan (+ optional imu_t/imu_gyro/imu_acc/imu_rpy/gps_xyz/
        gps_sigma keyword arrays; other keys are ignored); returns the
        StepOutput."""
        sensors = {k: v for k, v in sensors.items() if k in _SENSOR_KEYS}
        points, aux = self._make_input_np(xyz, ring, time_rel, scan_start,
                                          **sensors)
        self.state, out = odometry_step_packed(
            self.state, torch.from_numpy(points).to(self.device),
            torch.from_numpy(aux).to(self.device), self.p)
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

        if len(self._pending) >= _READBACK_INTERVAL:
            self._flush_pending()
        if self.loop_enabled and self._scan_count % self._loop_every == 0:
            self._try_loop_closure()
        return out

    def _bootstrap_refeed(self):
        """Dynamic init second pass: reset the estimator and replay the
        buffered boot scans with the converged velocity as the first-scan
        deskew/filter hint.  Returns the output of the last re-fed scan."""
        from scipy.spatial.transform import Rotation as Rs

        scans = self._boot_scans
        self._boot_scans = None  # the re-feed must not re-trigger
        self._pending_loops.clear()
        self._resync_needed = False
        fs = self.state.filter
        q = fs.nav.q.double().cpu().numpy()   # wxyz
        v = fs.nav.v.double().cpu().numpy()
        if not (np.isfinite(q).all() and np.isfinite(v).all()
                and np.linalg.norm(v) < 1e3):
            return None  # keep the first pass; nothing sane to re-feed with
        v_b = Rs.from_quat([q[1], q[2], q[3], q[0]]).inv().apply(v)
        self._init_vel = v_b.astype(np.float32)

        self.state = init_state(self.p, self.device)
        self._trajectory = Trajectory([], [])
        self._pending.clear()
        self._scan_count = 0
        self._last_scan_time = None
        out = None
        for s in scans:
            kw = {k: val for k, val in s.items()
                  if k not in ("xyz", "ring", "time_rel", "scan_start")}
            out = self.process_scan(s["xyz"], s["ring"], s["time_rel"],
                                    s["scan_start"], **kw)
        return out

    def _try_loop_closure(self):
        """One loop-closure attempt, unless the host pre-gate rules it out.
        Its `found` flag is read at the next flush, where a closed loop
        marks the trajectory for a resync."""
        if not self._loop_plausible():
            return
        self.state, loop = loop_closure_step(self.state, self.p)
        self._pending_loops.append(loop.found)

    def _loop_plausible(self) -> bool:
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
        p, t_cur = self.p, self._last_scan_time
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
        if loops and bool(torch.stack(loops).any()):
            self._resync_needed = True
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        times = [t for t, *_ in pending]
        mats = torch.stack([m for _, m, _, _ in pending]).cpu().numpy()
        occ = torch.stack([o for _, _, o, _ in pending]).cpu().numpy()
        drop = torch.stack([d for _, _, _, d in pending]).cpu().numpy()
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
        self._resync_needed = False
        kf = self.state.kf
        n = int(kf.count)
        if n == 0 or not self._trajectory.times:
            return
        mats = se3.Pose.from_vec6(kf.pose6[:n].cpu()).to_matrix().numpy()
        # keyframe times are float32 offsets from the epoch, trajectory times
        # absolute float64: match the nearest within half a 10 Hz period
        times = kf.time[:n].cpu().numpy().astype(np.float64) + (
            self._epoch or 0.0)
        traj_t = np.asarray(self._trajectory.times, np.float64)
        order = np.argsort(traj_t, kind="stable")
        sorted_t = traj_t[order]
        hi = np.searchsorted(sorted_t, times)
        for t, m, j in zip(times, mats, hi):
            best, best_dt = -1, 0.02
            for k in (j - 1, j):
                if 0 <= k < len(sorted_t) and abs(sorted_t[k] - t) < best_dt:
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
        self._flush_pending()
        if self._resync_needed:
            self._resync_trajectory()
