"""A cell's inputs: the simulated drive of its configuration, made from the
seed during set-up.

The sweeps are cast in worker processes (spawned, joined before the
window, with the semaphore tracker that spawning starts), each sweep from
its own generator, so the drive does not depend on how it was split.  The program and the reference get the same host arrays.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import sim

# scans a worker casts per task
_CHUNK = 16


def sensor_of(cfg: dict) -> sim.Sensor:
    s = cfg["sensor"]
    return sim.Sensor(n_scan=s["n_scan"], horizon=s["horizon"],
                      elev_limits=tuple(s["elev_limits_deg"]),
                      scan_dt=s["scan_dt_s"], max_range=s["max_range_m"],
                      noise=s["range_noise_m"])


def trajectory_of(cfg: dict) -> sim.SimTrajectory:
    d = cfg["drive"]
    return sim.SimTrajectory(radius=d["radius_m"], speed=d["speed_m_s"],
                             z=d["height_m"])


def _cast(args):
    cfg, seed, first, count = args
    return first, sim.make_sweeps(sim.World(), trajectory_of(cfg),
                                  sensor_of(cfg), seed, first, count,
                                  dtype=np.float64)


class Drive:
    """`n` scans of one configuration under one seed, as the dicts that
    ``LioSam.process_scan`` (keys xyz, ring, time_rel, scan_start and the
    IMU's) and ``process_window`` (with the range-image grids) take, and
    the true poses."""

    def __init__(self, cfg: dict, n: int, seed: int, points: bool,
                 grids: bool, workers: int | None = None):
        self.n = n
        sensor = sensor_of(cfg)
        traj = trajectory_of(cfg)
        d = cfg["drive"]
        imu = sim.make_imu(traj, sensor, n, seed, imu_rate=d["imu_rate_hz"],
                           imu_noise_gyr=d["imu_noise_gyr"],
                           imu_noise_acc=d["imu_noise_acc"])
        self.gt = traj.poses(np.arange(n) * sensor.scan_dt)
        ranges = self._cast(cfg, n, seed, workers)
        d_sensor, ring, time_rel, _ = sensor.rays()
        shared = sensor.grids() if grids else {}
        self.scans = []
        for i in range(n):
            s = dict(scan_start=i * sensor.scan_dt,
                     **sim.scan_sensors(imu, sensor, i))
            if points:
                s.update(xyz=(d_sensor * ranges[i][:, None]).astype(
                    np.float32), ring=ring, time_rel=time_rel)
            if grids:
                s.update(ranges=np.maximum(ranges[i], 0.0).astype(np.float32),
                         **shared)
            self.scans.append(s)

    @staticmethod
    def _cast(cfg, n, seed, workers):
        if workers is None:
            workers = min(os.cpu_count() or 1, 8)
        if workers <= 1 or n <= _CHUNK:
            return _cast((cfg, seed, 0, n))[1]
        tasks = [(cfg, seed, a, min(_CHUNK, n - a)) for a in range(0, n, _CHUNK)]
        out = [None] * n
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            for first, part in pool.map(_cast, tasks):
                out[first:first + len(part)] = list(part)
        del pool
        stop_children()
        return out


def _children() -> list:
    """Process ids whose parent is this process, from /proc."""
    me = str(os.getpid())
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:
            out.append(int(p))
    return out


def _stop_tracker() -> None:
    """Stop multiprocessing's semaphore tracker, if this process started
    one, and wait for it to end.  The pool's semaphores are collected
    first, so that none of them starts it again when it is freed."""
    from multiprocessing import resource_tracker

    gc.collect()
    rt = resource_tracker._resource_tracker
    stop = getattr(rt, "_stop", None)
    if stop is not None:
        stop()
        return
    if rt._fd is not None:
        os.close(rt._fd)
        rt._fd = None
    if rt._pid is not None:
        os.waitpid(rt._pid, 0)
        rt._pid = None


def stop_children(timeout: float = 10.0) -> list:
    """End every process this one started and wait for each: the semaphore
    tracker first, then whatever is left, given `timeout` seconds before it
    is killed.  Returns the ids that had to be killed."""
    import signal
    import time

    _stop_tracker()
    for p in multiprocessing.active_children():
        p.join(timeout)
    killed = []
    deadline = time.monotonic() + timeout
    while True:
        left = [pid for pid in _children() if not _reaped(pid)]
        if not left:
            return killed
        if time.monotonic() > deadline:
            for pid in left:
                try:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                except (ProcessLookupError, ChildProcessError):
                    pass
                killed.append(pid)
            return killed
        time.sleep(0.05)


def _reaped(pid: int) -> bool:
    """Whether child `pid` has ended (and is now waited for)."""
    try:
        return os.waitpid(pid, os.WNOHANG)[0] != 0
    except ChildProcessError:
        return True
