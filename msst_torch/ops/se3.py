"""SO(3)/SE(3) geometry core (port of ``msst_tpu.ops.se3``).

Conventions as the reference (``mapOptmization.cpp:287-341``):

* Euler angles are (roll, pitch, yaw) applied X-first: ``R = Rz @ Ry @ Rx``.
* Quaternions are stored ``(w, x, y, z)`` (Hamilton, active rotation).
* ``Pose`` is a NamedTuple of a unit quaternion and a translation; ops
  broadcast over leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Euler <-> rotation matrix
# ---------------------------------------------------------------------------


def rpy_to_matrix(rpy: Tensor) -> Tensor:
    """(..., 3) (roll, pitch, yaw) -> (..., 3, 3) with R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    R = torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1)
    return R.reshape(rpy.shape[:-1] + (3, 3))


def matrix_to_rpy(R: Tensor) -> Tensor:
    """(..., 3, 3) -> (..., 3) (roll, pitch, yaw); inverse of :func:`rpy_to_matrix`."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.arcsin(sp)
    roll = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_identity(shape=(), device=None, dtype=torch.float32) -> Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=eps)
    # canonical sign (w >= 0) so log/slerp take the short path
    return torch.where(q[..., :1] < 0, -q, q)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: Tensor) -> Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    R = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: Tensor) -> Tensor:
    """Shepperd's method, branch-free: all four decodes, the one with the
    largest pivot kept (on equal pivots the first, as msst_tpu)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(w, x, y, z):
        return torch.stack([w, x, y, z], dim=-1)

    def root(a):
        return torch.sqrt(torch.clamp(a, min=1e-12)) * 2.0

    s0 = root(1.0 + tr)
    q0 = mk(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = mk((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = root(1.0 - m00 + m11 - m22)
    q2 = mk((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = root(1.0 - m00 - m11 + m22)
    q3 = mk((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)

    c0 = tr
    c1 = m00 - m11 - m22
    c2 = m11 - m00 - m22
    c3 = m22 - m00 - m11
    cmax = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
    q = torch.where((c0 == cmax)[..., None], q0,
                    torch.where((c1 == cmax)[..., None], q1,
                                torch.where((c2 == cmax)[..., None], q2, q3)))
    return quat_normalize(q)


def quat_from_rpy(rpy: Tensor) -> Tensor:
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return quat_normalize(torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1))


def quat_to_rpy(q: Tensor) -> Tensor:
    return matrix_to_rpy(quat_to_matrix(q))


# ---------------------------------------------------------------------------
# so(3) exp & log
# ---------------------------------------------------------------------------


def so3_exp_quat(w: Tensor) -> Tensor:
    """Axis-angle (..., 3) -> unit quaternion, small-angle safe."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    # sin(t/2)/t with Taylor fallback 1/2 - t^2/48
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return quat_normalize(torch.cat([torch.cos(half), k * w], dim=-1))


def so3_log(q: Tensor) -> Tensor:
    """Unit quaternion -> axis-angle (..., 3), small-angle safe."""
    q = quat_normalize(q)
    w, v = q[..., :1], q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.arctan2(vn, w)
    small = vn < 1e-9
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                    theta / torch.clamp(vn, min=1e-24))
    return k * v


def so3_exp_matrix(w: Tensor) -> Tensor:
    return quat_to_matrix(so3_exp_quat(w))


def skew(v: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    M = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return M.reshape(v.shape[:-1] + (3, 3))


def so3_left_jacobian(w: Tensor) -> Tensor:
    """Left Jacobian of SO(3) exp at w (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    W = skew(w)
    W2 = W @ W
    small = theta2 < 1e-10
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=1e-24))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


# ---------------------------------------------------------------------------
# Pose
# ---------------------------------------------------------------------------


class Pose(NamedTuple):
    """Rigid transform: x_world = R(q) @ x_local + t.  Batched over leading dims."""

    q: Tensor  # (..., 4) wxyz unit quaternion
    t: Tensor  # (..., 3)

    @staticmethod
    def identity(shape=(), device=None) -> "Pose":
        return Pose(quat_identity(shape, device),
                    torch.zeros(tuple(shape) + (3,), device=device))

    @staticmethod
    def from_rpy_xyz(rpy: Tensor, xyz: Tensor) -> "Pose":
        return Pose(quat_from_rpy(rpy), xyz)

    @staticmethod
    def from_vec6(v: Tensor) -> "Pose":
        """v = (roll, pitch, yaw, x, y, z) — the reference's transform layout
        (``mapOptmization.cpp:313-317`` trans2gtsamPose)."""
        return Pose(quat_from_rpy(v[..., :3]), v[..., 3:])

    def to_vec6(self) -> Tensor:
        return torch.cat([quat_to_rpy(self.q), self.t], dim=-1)

    def to_matrix(self) -> Tensor:
        R = quat_to_matrix(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other (apply `other` first, then `self`)."""
        return Pose(quat_normalize(quat_mul(self.q, other.q)),
                    quat_rotate(self.q, other.t) + self.t)

    def inverse(self) -> "Pose":
        qi = quat_conj(self.q)
        return Pose(qi, -quat_rotate(qi, self.t))

    def apply(self, pts: Tensor) -> Tensor:
        """Transform points (..., N, 3) (or (..., 3)) into the parent frame."""
        if pts.ndim == self.t.ndim:
            return quat_rotate(self.q, pts) + self.t
        return quat_rotate(self.q[..., None, :], pts) + self.t[..., None, :]

    def between(self, other: "Pose") -> "Pose":
        """self^-1 ∘ other — the relative pose, matching gtsam's between()."""
        return self.inverse().compose(other)


def pose_retract(p: Pose, delta: Tensor) -> Pose:
    """Right-perturbation retraction: (R, t) <- (R exp(dw), t + R dv)."""
    dq = so3_exp_quat(delta[..., :3])
    return Pose(quat_normalize(quat_mul(p.q, dq)),
                p.t + quat_rotate(p.q, delta[..., 3:]))


def slerp_angle(a: Tensor, b: Tensor, w: float) -> Tensor:
    """Interpolate between two angles on the unit circle: (1-w)*a ⊕ w*b
    (the roll/pitch slerp fusion of ``mapOptmization.cpp:1312-1342``)."""
    d = torch.arctan2(torch.sin(b - a), torch.cos(b - a))
    return a + w * d
