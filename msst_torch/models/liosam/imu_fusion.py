"""Error-state Kalman filter fusing preintegrated IMU with lidar poses (port
of ``msst_tpu.models.liosam.imu_fusion``; the role of the reference's
``imuPreintegration`` process).  15 states [dtheta_w, dv, dp, dbg, dba]."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...ops import imu as imu_ops
from ...ops import se3

Tensor = torch.Tensor


class FilterState(NamedTuple):
    nav: imu_ops.NavState
    bias: imu_ops.ImuBias
    cov: Tensor  # (15, 15)

    @staticmethod
    def initial(pose: Optional[se3.Pose] = None, rot_sigma: float = 0.1,
                pos_sigma: float = 0.1, vel_sigma: float = 1.0,
                bias_sigma: float = 0.1, velocity: Optional[Tensor] = None,
                device=None) -> "FilterState":
        if pose is not None:
            device = pose.q.device
        nav = imu_ops.NavState.identity(device)
        if pose is not None:
            nav = nav._replace(q=pose.q, p=pose.t)
        if velocity is not None:
            nav = nav._replace(v=velocity.to(torch.float32))
        d = torch.tensor([rot_sigma ** 2] * 3 + [vel_sigma ** 2] * 3
                         + [pos_sigma ** 2] * 3 + [bias_sigma ** 2] * 6,
                         device=device)
        return FilterState(nav, imu_ops.ImuBias.zero(device), torch.diag(d))


def propagate(fs: FilterState, pre: imu_ops.Preintegrated,
              params: imu_ops.ImuParams,
              bias_ref: Optional[imu_ops.ImuBias] = None) -> FilterState:
    """Propagate through a preintegrated delta integrated at `bias_ref`
    (default fs.bias), corrected to fs.bias by the first-order bias
    Jacobians (Forster eq. 70)."""
    nav = imu_ops.predict(fs.nav, pre, fs.bias,
                          fs.bias if bias_ref is None else bias_ref, params)
    dev = fs.cov.device
    R = se3.quat_to_matrix(fs.nav.q)
    dt = pre.dt
    Z = torch.zeros((3, 3), device=dev)
    eye = torch.eye(3, device=dev)
    F = torch.cat([
        torch.cat([eye, Z, Z, R @ pre.J_dR_bg, Z], dim=1),
        torch.cat([-se3.skew(R @ pre.dv), eye, Z, R @ pre.J_dv_bg,
                   R @ pre.J_dv_ba], dim=1),
        torch.cat([-se3.skew(R @ pre.dp), eye * dt, eye, R @ pre.J_dp_bg,
                   R @ pre.J_dp_ba], dim=1),
        torch.cat([Z, Z, Z, eye, Z], dim=1),
        torch.cat([Z, Z, Z, Z, eye], dim=1),
    ], dim=0)
    Rblk = torch.block_diag(R, R, R)
    Q9 = Rblk @ pre.cov @ Rblk.T
    Qb = torch.tensor([params.gyr_bias_noise ** 2] * 3
                      + [params.acc_bias_noise ** 2] * 3,
                      device=dev) * torch.clamp(dt, min=1e-6)
    Q = torch.block_diag(Q9, torch.diag(Qb))
    cov = F @ fs.cov @ F.T + Q
    return FilterState(nav, fs.bias, 0.5 * (cov + cov.T))


def _correct(fs: FilterState, H: Tensor, Rm: Tensor, r: Tensor) -> FilterState:
    """Kalman update with measurement Jacobian H, noise Rm, residual r."""
    S = H @ fs.cov @ H.T + Rm
    S_inv, _ = torch.linalg.inv_ex(S)
    K = fs.cov @ H.T @ S_inv
    dx = K @ r
    cov = (torch.eye(15, device=H.device) - K @ H) @ fs.cov
    cov = 0.5 * (cov + cov.T)
    dq = se3.so3_exp_quat(dx[:3])
    nav = imu_ops.NavState(
        q=se3.quat_normalize(se3.quat_mul(dq, fs.nav.q)),
        p=fs.nav.p + dx[6:9],
        v=fs.nav.v + dx[3:6],
    )
    bias = imu_ops.ImuBias(fs.bias.gyr + dx[9:12], fs.bias.acc + dx[12:15])
    return FilterState(nav, bias, cov)


def update_with_pose(fs: FilterState, meas: se3.Pose, rot_sigma: float,
                     pos_sigma: float, degenerate,
                     degenerate_scale: float = 10.0) -> FilterState:
    """6-dof pose measurement update (world-frame left attitude error); the
    noise widens when the scan match was degenerate (correctionNoise2,
    ``imuPreintegration.cpp:269,378``)."""
    dev = fs.cov.device
    scale = torch.where(torch.as_tensor(degenerate, device=dev),
                        degenerate_scale, 1.0)
    r_theta = se3.so3_log(se3.quat_mul(meas.q, se3.quat_conj(fs.nav.q)))
    r = torch.cat([r_theta, meas.t - fs.nav.p])
    H = torch.zeros((6, 15), device=dev)
    H[:3, :3] = torch.eye(3, device=dev)
    H[3:, 6:9] = torch.eye(3, device=dev)
    sig = torch.cat([(rot_sigma * scale).expand(3), (pos_sigma * scale).expand(3)])
    return _correct(fs, H, torch.diag(sig ** 2), r)


def update_with_position(fs: FilterState, pos: Tensor,
                         sigma: Tensor) -> FilterState:
    """3-dof absolute-position update (the GPS leg of the reference's navsat
    EKF, ``module_navsat.launch:8-19``)."""
    dev = fs.cov.device
    H = torch.zeros((3, 15), device=dev)
    H[:, 6:9] = torch.eye(3, device=dev)
    return _correct(fs, H, torch.diag(sigma ** 2), pos - fs.nav.p)


def reset_needed(fs: FilterState) -> Tensor:
    return imu_ops.failure_detected(fs.nav, fs.bias)
