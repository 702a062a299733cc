"""IMU intrinsic calibration by Allan variance (port of
``msst_tpu.models.calibration.imu_allan``).

Rebuild of ``imu_calib/src/imu_utils`` (``imu_an.cpp``): collect IMU samples,
compute each axis' overlapping Allan variance over log-spaced cluster sizes
(``allan_gyr.cpp:41-148``), fit the 5-coefficient model (linear least
squares, ``ops.imu.fit_allan``), and write the noise YAML the LIO pipeline
reads as imuAccNoise/imuGyrNoise/imuAccBiasN/imuGyrBiasN
(``imu_an.cpp:117-202`` writeYAML).  The variance and the fit run on
`device`: the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops import imu as imu_ops
from . import device as device_mod


@dataclasses.dataclass
class AllanCalibrator:
    name: str = "imu"
    max_samples: int = 500_000
    n_clusters: int = 100
    device: str = "cuda"

    def __post_init__(self):
        self._device = device_mod.resolve(self.device)
        self._gyro: list = []
        self._acc: list = []
        self._t: list = []

    def add_sample(self, t: float, gyro, acc):
        if len(self._t) < self.max_samples:
            self._t.append(t)
            self._gyro.append(np.asarray(gyro, np.float64))
            self._acc.append(np.asarray(acc, np.float64))

    @property
    def duration_min(self) -> float:
        if len(self._t) < 2:
            return 0.0
        return (self._t[-1] - self._t[0]) / 60.0

    def compute(self) -> dict:
        t = np.asarray(self._t)
        dt = float(np.median(np.diff(t)))
        gyro = np.stack(self._gyro)     # rad/s
        acc = np.stack(self._acc)       # m/s^2
        ms = imu_ops.log_spaced_clusters(len(t), self.n_clusters)
        taus = ms.numpy().astype(np.float64) * dt
        taus_t = torch.from_numpy(taus.astype(np.float32)).to(self._device)

        def per_axis(sig):
            av = imu_ops.allan_variance(
                torch.from_numpy(sig.astype(np.float32)).to(self._device),
                dt, ms.tolist())
            fit = imu_ops.fit_allan(taus_t, av)
            return {
                "white_noise": float(fit.white_noise),
                "bias_instability": float(fit.bias_instability),
                "taus": taus.tolist(),
                "avar": av.cpu().numpy().tolist(),
            }

        gyr_axes = [per_axis(gyro[:, i]) for i in range(3)]
        acc_axes = [per_axis(acc[:, i]) for i in range(3)]

        def avg(key, axes):
            return float(np.mean([a[key] for a in axes]))

        return {
            "imu_name": self.name,
            "duration_min": self.duration_min,
            "gyr_n": avg("white_noise", gyr_axes),       # -> imuGyrNoise
            "gyr_w": avg("bias_instability", gyr_axes),  # -> imuGyrBiasN
            "acc_n": avg("white_noise", acc_axes),       # -> imuAccNoise
            "acc_w": avg("bias_instability", acc_axes),  # -> imuAccBiasN
            "gyr_axes": gyr_axes,
            "acc_axes": acc_axes,
        }

    def write_yaml(self, path: str):
        r = self.compute()
        lines = [
            "%YAML:1.0",
            "---",
            "type: IMU",
            f"name: {r['imu_name']}",
            "Gyr:",
            "  unit: \"rad/s\"",
            "  avg-axis:",
            f"    gyr_n: {r['gyr_n']:.12e}",
            f"    gyr_w: {r['gyr_w']:.12e}",
            "Acc:",
            "  unit: \"m/s^2\"",
            "  avg-axis:",
            f"    acc_n: {r['acc_n']:.12e}",
            f"    acc_w: {r['acc_w']:.12e}",
        ]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return r
