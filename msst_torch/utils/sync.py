"""Host-side stream synchronization.

* :class:`ApproximateTimeSynchronizer` — the ``message_filters``
  ApproximateTime policy joining 2-4 sensor streams
  (``lidar_fusion.cpp:19-23``, ``fusion_pointclouds.cpp:15-25``,
  ``multi_lidar_calibrator.cpp:173-188``): emits one tuple per "pivot" set of
  messages whose stamps lie within a window, consuming each message once.
* :class:`ImuLidarSync` — the ``sync_ws`` republisher
  (``imu_lidar_sync_node.cpp:20-73``): buffers IMU messages (bounded deque)
  and, on each LiDAR frame, hands over every IMU sample up to the frame
  stamp.

The port's own copy of ``msst_tpu.utils.sync``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import collections
from typing import Callable, Optional


class ApproximateTimeSynchronizer:
    def __init__(self, n_streams: int, slop: float = 0.05, queue_size: int = 10,
                 callback: Optional[Callable] = None):
        assert 2 <= n_streams <= 8
        self.n = n_streams
        self.slop = slop
        self.queues = [collections.deque(maxlen=queue_size) for _ in range(n_streams)]
        self.callback = callback
        self.matched = []

    def push(self, stream: int, stamp: float, msg):
        self.queues[stream].append((stamp, msg))
        self._try_match()

    def _try_match(self):
        while all(self.queues):
            # candidate set: heads closest to the earliest head
            picks = []
            for q in self.queues:
                picks.append(q[0])
            t0 = min(p[0] for p in picks)
            # for each stream pick the message nearest t0
            chosen = []
            for q in self.queues:
                best = min(q, key=lambda sm: abs(sm[0] - t0))
                chosen.append(best)
            tmin = min(c[0] for c in chosen)
            tmax = max(c[0] for c in chosen)
            if tmax - tmin <= self.slop:
                for q, c in zip(self.queues, chosen):
                    while q and q[0][0] <= c[0]:
                        q.popleft()
                out = tuple(c[1] for c in chosen)
                self.matched.append((tmin, out))
                if self.callback:
                    self.callback(*out)
            else:
                # drop the oldest head and retry
                oldest = min(range(self.n), key=lambda i: self.queues[i][0][0])
                self.queues[oldest].popleft()


class ImuLidarSync:
    """Bounded IMU buffer drained per LiDAR frame (queue length 2000 like the
    reference)."""

    def __init__(self, max_imu: int = 2000):
        self.imu = collections.deque(maxlen=max_imu)
        self.stats_matched = 0
        self.stats_frames = 0

    def push_imu(self, stamp: float, msg):
        self.imu.append((stamp, msg))

    def on_lidar(self, stamp: float):
        """Returns (and consumes) all IMU samples with t <= lidar stamp."""
        out = []
        while self.imu and self.imu[0][0] <= stamp:
            out.append(self.imu.popleft())
        self.stats_matched += len(out)
        self.stats_frames += 1
        return out
