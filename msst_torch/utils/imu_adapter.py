"""IMU -> lidar frame conversion (the reference's ``imuConverter``).

Rebuild of ``liosam_ws/src/LIO-SAM/include/utility.h:252-282`` with the
dual-extrinsic semantics of ``utility.h:108-115,211-215`` and
``README.md:111-113``:

* ``ext_rot`` (``extrinsicRot``) rotates the acceleration and gyro *vectors*
  from the IMU frame into the lidar frame: ``v_l = ext_rot @ v_b``.
* ``ext_rpy`` (``extrinsicRPY``) aligns the *attitude* reading: the IMU
  reports ``q_wb`` (IMU attitude body -> world) but the estimator needs
  ``q_wl`` (lidar -> world).  ``ext_rpy`` is the attitude-frame -> lidar
  rotation matrix (same direction as ``ext_rot``; identical to it when the
  IMU's accelerometer and attitude filter share axes, which is why the
  yaml's commented default sets both equal).  The converter applies
  ``R_wl = R_wb @ ext_rpy^-1`` (``extQRPY = Quaterniond(extRPY).inverse()``,
  ``q_final = q_from * extQRPY``) — ``ext_rpy^-1`` maps lidar coords into
  the attitude body frame, so the product is exactly ``R_{world<-lidar}``.
  The two extrinsics differ whenever the IMU's accelerometer and attitude
  filters use different axes conventions (the reference's Microstrain
  3DM-GX5-25 does; ``README.md:111``).
* ``ext_trans`` (``extrinsicTrans``) is the lidar->IMU lever arm, used to
  shift preintegrated odometry between the frames
  (``imuPreintegration.cpp:203-205``).

Everything here is host-side NumPy: the conversion happens in the input
adapters (KITTI / rosbag / Modbus) before data is packed for the device, like
the reference converts inside every IMU callback.

The port's own copy of ``msst_tpu.utils.imu_adapter``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial.transform import Rotation as _R


@dataclasses.dataclass(frozen=True)
class ImuExtrinsics:
    """IMU mounting extrinsics (see module docstring for conventions)."""

    ext_rot: np.ndarray    # (3, 3) vector rotation IMU frame -> lidar frame
    ext_rpy: np.ndarray    # (3, 3) attitude-frame -> lidar rotation
    ext_trans: np.ndarray  # (3,) lidar position in the IMU frame [m]

    @staticmethod
    def identity() -> "ImuExtrinsics":
        return ImuExtrinsics(np.eye(3), np.eye(3), np.zeros(3))

    @staticmethod
    def create(ext_rot, ext_rpy=None, ext_trans=None) -> "ImuExtrinsics":
        """``ext_rpy`` defaults to ``ext_rot`` (the common same-convention
        IMU case, ``config/params.yaml:49-54``)."""
        ext_rot = np.asarray(ext_rot, np.float64).reshape(3, 3)
        ext_rpy = (ext_rot if ext_rpy is None
                   else np.asarray(ext_rpy, np.float64).reshape(3, 3))
        ext_trans = (np.zeros(3) if ext_trans is None
                     else np.asarray(ext_trans, np.float64).reshape(3))
        return ImuExtrinsics(ext_rot, ext_rpy, ext_trans)

    def is_identity(self) -> bool:
        return (np.allclose(self.ext_rot, np.eye(3))
                and np.allclose(self.ext_rpy, np.eye(3)))


def convert_imu(ext: ImuExtrinsics, gyro: np.ndarray, acc: np.ndarray,
                rpy: np.ndarray | None = None,
                quat_wb: np.ndarray | None = None):
    """Convert IMU samples into the lidar frame (``imuConverter``).

    gyro, acc: (..., 3) angular rate / specific force in the IMU frame.
    rpy:       (..., 3) roll,pitch,yaw of the IMU attitude ``q_wb``
               (R = Rz(yaw) Ry(pitch) Rx(roll), the framework convention), OR
    quat_wb:   (..., 4) the same attitude as an xyzw quaternion.

    Returns ``(gyro_l, acc_l, rpy_l)`` — vectors rotated by ``ext_rot``,
    attitude composed as ``R_wl = R_wb @ ext_rpy^-1`` and re-encoded as rpy
    (None when no attitude was given).
    """
    gyro_l = np.asarray(gyro, np.float64) @ ext.ext_rot.T
    acc_l = np.asarray(acc, np.float64) @ ext.ext_rot.T

    rpy_l = None
    if quat_wb is not None or rpy is not None:
        if quat_wb is not None:
            q_in = np.asarray(quat_wb, np.float64)
            if np.any(np.sum(q_in * q_in, axis=-1) < 0.01):
                raise ValueError(
                    "invalid orientation quaternion — use a 9-axis IMU "
                    "(utility.h:276-280)")
            r_wb = _R.from_quat(q_in)
        else:
            r_wb = _R.from_euler("xyz", np.asarray(rpy, np.float64))
        # q_final = q_from * extQRPY with extQRPY = Quaterniond(extRPY)^-1
        r_wl = r_wb * _R.from_matrix(ext.ext_rpy).inv()
        rpy_l = r_wl.as_euler("xyz")
    return (gyro_l.astype(np.float32), acc_l.astype(np.float32),
            None if rpy_l is None else rpy_l.astype(np.float32))


def convert_scan_dict(ext: ImuExtrinsics, scan: dict) -> dict:
    """Apply :func:`convert_imu` to a per-scan input dict (the adapters'
    common ``imu_gyro/imu_acc/imu_rpy`` keys) in place-of."""
    if ext.is_identity() or "imu_gyro" not in scan:
        return scan
    out = dict(scan)
    gyro_l, acc_l, rpy_l = convert_imu(
        ext, scan["imu_gyro"], scan["imu_acc"], rpy=scan.get("imu_rpy"))
    out["imu_gyro"] = gyro_l
    out["imu_acc"] = acc_l
    if rpy_l is not None:
        out["imu_rpy"] = rpy_l
    return out


def load_kitti_imu_extrinsics(calib_path: str) -> ImuExtrinsics:
    """Build :class:`ImuExtrinsics` from a KITTI ``calib_imu_to_velo.txt``.

    The file gives ``x_velo = R x_imu + t`` (imu->velodyne): vectors map with
    ``ext_rot = R``; the OXTS attitude shares the OXTS body axes, so
    ``ext_rpy = R`` too; the lidar position in the IMU frame is
    ``ext_trans = -R^T t``.
    """
    vals = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                vals[k.strip()] = np.array([float(x) for x in v.split()])
            except ValueError:   # e.g. the calib_time header line
                continue
    R = vals["R"].reshape(3, 3)
    t = vals["T"].reshape(3)
    return ImuExtrinsics(ext_rot=R, ext_rpy=R.copy(), ext_trans=-R.T @ t)
