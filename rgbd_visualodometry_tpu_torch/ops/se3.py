"""SE(3) / SO(3) on quaternion poses, as torch tensors.

Counterpart of ``rgbd_visualodometry_tpu/ops/se3.py`` with the same
conventions: a pose is ``[..., 7] = (qw, qx, qy, qz, tx, ty, tz)`` acting as
``R(q) p + t``; the tangent is ``(rho, phi)`` with translation first; updates
are left-multiplicative, ``exp(delta) * T``.  Small-angle cases use the same
Taylor branches selected with ``torch.where``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def quat(T: torch.Tensor) -> torch.Tensor:
    return T[..., :4]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., 4:7]


def make(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(_norm(q, keepdim=True), _EPS)


def normalize(T: torch.Tensor) -> torch.Tensor:
    return make(quat_normalize(quat(T)), trans(T))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion (w, x, y, z): the
    four candidates (trace-dominant, then the largest diagonal term), each
    computed and selected with ``torch.where``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    s0 = torch.sqrt(torch.clamp_min(tr + 1.0, _EPS)) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, _EPS)) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = torch.sqrt(torch.clamp_min(1.0 + m11 - m00 - m22, _EPS)) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = torch.sqrt(torch.clamp_min(1.0 + m22 - m00 - m11, _EPS)) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)
    c1 = (m00 > m11) & (m00 > m22)
    c2 = m11 > m22
    qd = torch.where(c1[..., None], q1, torch.where(c2[..., None], q2, q3))
    return quat_normalize(torch.where((tr > 0.0)[..., None], q0, qd))


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    m = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-4
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / torch.clamp_min(theta, _EPS))
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w[..., None], k[..., None] * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:4]
    vn = _norm(v)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp_min(w, _EPS), theta / torch.clamp_min(vn, _EPS))
    return scale[..., None] * v


def _eye3(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-4
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, _EPS))
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, _EPS),
    )
    W = hat(phi)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-4
    half = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp_min(torch.sin(half), _EPS))
        / torch.clamp_min(theta2, _EPS),
    )
    W = hat(phi)
    return _eye3(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def exp(xi: torch.Tensor) -> torch.Tensor:
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    V = _so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return make(q, t)


def log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(quat(T))
    Vinv = _so3_left_jacobian_inv(phi)
    rho = (Vinv @ trans(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_mul(quat(a), quat(b))
    t = quat_rotate(quat(a), trans(b)) + trans(a)
    return make(quat_normalize(q), t)


def inverse(T: torch.Tensor) -> torch.Tensor:
    qc = quat_conj(quat(T))
    return make(qc, -quat_rotate(qc, trans(T)))


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat(T), p) + trans(T)


def to_matrix(T: torch.Tensor) -> torch.Tensor:
    """Pose -> homogeneous ``[..., 4, 4]`` matrix."""
    bottom = torch.tensor([0.0, 0, 0, 1.0], dtype=T.dtype, device=T.device).expand(T.shape[:-1] + (1, 4))
    return torch.cat([to_matrix34(T), bottom], dim=-2)


def from_matrix(M: torch.Tensor) -> torch.Tensor:
    """``[..., 3|4, 4]`` rigid matrix -> pose."""
    return make(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def to_matrix34(T: torch.Tensor) -> torch.Tensor:
    R = quat_to_matrix(quat(T))
    return torch.cat([R, trans(T)[..., :, None]], dim=-1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b^-1`` (``src/frontend.cpp:344,356``)."""
    return compose(a, inverse(b))
