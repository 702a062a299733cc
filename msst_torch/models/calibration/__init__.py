"""Calibration suite (port of ``msst_tpu.models.calibration``): multi-LiDAR
extrinsics by three methods and IMU intrinsics.

* :mod:`multi_lica`  — targetless FPFH + GNC-TLS coarse init, GICP fine
  (Multi_LiCa, MFI-2024);
* :mod:`auto_calib`  — ground-plane alignment + yaw search + GICP
  (SensorsCalibration lidar2lidar);
* :mod:`ndt_calib`   — online NDT parent/child calibration
  (Calibration_Tookit/multi_lidar);
* :mod:`manual_calib` — keyboard nudges scored by the NN distance;
* :mod:`imu_allan`   — Allan-variance IMU noise identification (imu_utils);
* :mod:`evaluation`  — RMSE against ground truth (Multi_LiCa/evaluation).

Every k-NN of these tools is kernel B2 (``msst_torch/csrc/knn_query.cu``)
on a CUDA tensor.  The host-side entry points (the calibrator classes and
the CLI) run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .evaluation import calibration_rmse  # noqa: F401
