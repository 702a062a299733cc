# Frozen copy of msst_torch/ops/imu.py at commit e686079, part of the
# benchmark's plain reference (slambench/ref/__init__.py).
"""IMU preintegration (Forster-style), NavState prediction and the failure
gates (port of ``msst_tpu.ops.imu``; the reference's gtsam
``PreintegratedImuMeasurements`` use in ``imuPreintegration.cpp``)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import se3

Tensor = torch.Tensor


class ImuParams(NamedTuple):
    """Continuous-time noise densities (the reference's params.yaml names)."""

    acc_noise: float = 3.9939570888238808e-03
    gyr_noise: float = 1.5636343949698187e-03
    acc_bias_noise: float = 6.4356659353532566e-05
    gyr_bias_noise: float = 3.5640318696367613e-05
    gravity: float = 9.80511
    integration_noise: float = 1e-4


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurement between two scans."""

    dt: Tensor       # () total time
    dq: Tensor       # (4,) integrated rotation
    dv: Tensor       # (3,)
    dp: Tensor       # (3,)
    J_dR_bg: Tensor  # (3, 3) d Log(dR) / d bias_gyr
    J_dv_bg: Tensor
    J_dv_ba: Tensor
    J_dp_bg: Tensor
    J_dp_ba: Tensor
    cov: Tensor      # (9, 9) [rot, vel, pos]
    n_used: Tensor   # () int32 samples integrated


class NavState(NamedTuple):
    """World-frame navigation state (gtsam::NavState)."""

    q: Tensor  # (4,)
    p: Tensor  # (3,)
    v: Tensor  # (3,)

    @staticmethod
    def identity(device=None) -> "NavState":
        return NavState(se3.quat_identity((), device),
                        torch.zeros(3, device=device),
                        torch.zeros(3, device=device))


class ImuBias(NamedTuple):
    gyr: Tensor  # (3,)
    acc: Tensor  # (3,)

    @staticmethod
    def zero(device=None) -> "ImuBias":
        return ImuBias(torch.zeros(3, device=device),
                       torch.zeros(3, device=device))


def _assoc_scan(fn: Callable, elems: tuple) -> tuple:
    """Inclusive scan along dim 0 for an associative ``fn(earlier, later)``
    over a tuple of tensors, in log2(n) doubling steps (Hillis-Steele) —
    the counterpart of ``lax.associative_scan``."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        new = fn(tuple(e[:-d] for e in elems), tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([e[:d], x]) for e, x in zip(elems, new))
        d *= 2
    return elems


def _prev(x: Tensor) -> Tensor:
    """The exclusive prefix of an inclusive one: zeros, then x[:-1]."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def preintegrate(t: Tensor, gyro: Tensor, acc: Tensor, mask: Tensor,
                 bias: ImuBias, params: ImuParams) -> Preintegrated:
    """Integrate a masked IMU window into a relative (dR, dv, dp) with bias
    Jacobians and covariance.  Sample k integrates over t[k+1] - t[k] with
    the k-th measurement (forward Euler, gtsam's integrateMeasurement chain
    :351-358); the chained recurrences are associative, so they run as
    log-depth scans rather than a T-step loop of small ops."""
    T = t.shape[0]
    dev = t.device
    step_mask = mask[1:] & mask[:-1]
    dt = torch.where(step_mask, torch.clamp(t[1:] - t[:-1], 0.0, 0.1), 0.0)
    m = step_mask.to(t.dtype)
    w = (gyro[:-1] - bias.gyr) * m[:, None]
    a = (acc[:-1] - bias.acc) * m[:, None]
    dt3 = dt[:, None, None]

    # rotation chain R_k = prod_{j<=k} exp(w_j dt_j)
    (q_cum,) = _assoc_scan(lambda x, y: (se3.quat_mul(x[0], y[0]),),
                           (se3.so3_exp_quat(w * dt[:, None]),))
    q_cum = se3.quat_normalize(q_cum)
    q_prev = torch.cat([se3.quat_identity((1,), dev), q_cum[:-1]])
    R_prev = se3.quat_to_matrix(q_prev)

    # velocity / position: cumsums of rotated increments
    Ra = torch.einsum("kij,kj->ki", R_prev, a)
    dv_cum = torch.cumsum(Ra * dt[:, None], dim=0)
    dp_steps = _prev(dv_cum) * dt[:, None] + 0.5 * Ra * dt[:, None] ** 2
    dp = torch.sum(dp_steps, dim=0)

    # bias Jacobians: J <- R_incr^T J - Jr dt is affine, x <- A x + b
    incr = w * dt[:, None]
    R_incr_T = se3.quat_to_matrix(se3.so3_exp_quat(incr)).transpose(1, 2)
    Jr = se3.so3_left_jacobian(-incr)
    a_hat = se3.skew(a)

    def affine(x, y):
        return y[0] @ x[0], y[0] @ x[1] + y[1]

    _, JdRbg_cum = _assoc_scan(affine, (R_incr_T, -Jr * dt3))
    Rah = R_prev @ a_hat
    dvbg_steps = (-Rah * dt3) @ _prev(JdRbg_cum)
    Jvbg_cum = torch.cumsum(dvbg_steps, dim=0)
    Jvba_cum = -torch.cumsum(R_prev * dt3, dim=0)
    J_dp_bg = torch.sum(_prev(Jvbg_cum) * dt3 + 0.5 * dvbg_steps * dt3, dim=0)
    J_dp_ba = torch.sum(_prev(Jvba_cum) * dt3 - 0.5 * R_prev * dt3 ** 2, dim=0)

    # covariance Sigma <- A Sigma A^T + Q, composed as (A, Q) pairs
    g2 = params.gyr_noise ** 2
    a2 = params.acc_noise ** 2
    i2 = params.integration_noise ** 2
    Z = torch.zeros((T - 1, 3, 3), device=dev)
    eye = torch.eye(3, device=dev).expand(T - 1, 3, 3)
    A = torch.cat([
        torch.cat([R_incr_T, Z, Z], dim=2),
        torch.cat([-Rah * dt3, eye, Z], dim=2),
        torch.cat([-0.5 * Rah * dt3 ** 2, eye * dt3, eye], dim=2),
    ], dim=1)
    dt_safe = torch.clamp(dt, min=1e-9)
    Bg = torch.cat([Jr * dt3, Z, Z], dim=1)
    Ba = torch.cat([Z, R_prev * dt3, 0.5 * R_prev * dt3 ** 2], dim=1)
    Q = ((Bg * (g2 / dt_safe)[:, None, None]) @ Bg.transpose(1, 2)
         + (Ba * (a2 / dt_safe)[:, None, None]) @ Ba.transpose(1, 2))
    Q = Q.clone()
    Q[:, 6:, 6:] += torch.eye(3, device=dev) * (i2 * dt)[:, None, None]
    Q = Q * m[:, None, None]

    def cov_compose(x, y):
        return y[0] @ x[0], y[0] @ x[1] @ y[0].transpose(1, 2) + y[1]

    _, Q_cum = _assoc_scan(cov_compose, (A, Q))
    return Preintegrated(
        dt=torch.sum(dt), dq=q_cum[-1], dv=dv_cum[-1], dp=dp,
        J_dR_bg=JdRbg_cum[-1], J_dv_bg=Jvbg_cum[-1], J_dv_ba=Jvba_cum[-1],
        J_dp_bg=J_dp_bg, J_dp_ba=J_dp_ba, cov=Q_cum[-1],
        n_used=torch.sum(step_mask.to(torch.int32)))


def predict(state: NavState, pre: Preintegrated, bias: ImuBias,
            bias_ref: ImuBias, params: ImuParams) -> NavState:
    """Propagate a NavState through a preintegrated measurement with
    first-order bias correction (gtsam predict(), ``imuPreintegration.cpp:479``)."""
    dbg = bias.gyr - bias_ref.gyr
    dba = bias.acc - bias_ref.acc
    dq = se3.quat_mul(pre.dq, se3.so3_exp_quat(pre.J_dR_bg @ dbg))
    dv = pre.dv + pre.J_dv_bg @ dbg + pre.J_dv_ba @ dba
    dp = pre.dp + pre.J_dp_bg @ dbg + pre.J_dp_ba @ dba
    g = torch.tensor([0.0, 0.0, -params.gravity], device=state.q.device)
    R_i = se3.quat_to_matrix(state.q)
    q_j = se3.quat_normalize(se3.quat_mul(state.q, dq))
    v_j = state.v + g * pre.dt + R_i @ dv
    p_j = state.p + state.v * pre.dt + 0.5 * g * pre.dt ** 2 + R_i @ dp
    return NavState(q_j, p_j, v_j)


def failure_detected(state: NavState, bias: ImuBias,
                     vel_limit: float = 30.0, bias_limit: float = 1.0) -> Tensor:
    """The reference's divergence gates: |v| > 30 m/s or |b| > 1.0
    (``failureDetection`` :438-456) force re-initialization."""
    return ((torch.linalg.norm(state.v) > vel_limit)
            | (torch.linalg.norm(bias.acc) > bias_limit)
            | (torch.linalg.norm(bias.gyr) > bias_limit))


# ---------------------------------------------------------------------------
# Allan variance (imu_utils rebuild)
# ---------------------------------------------------------------------------
