# Frozen copy of cdvslam_tpu_torch/lie/quaternion.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Quaternion primitives (scalar-last layout ``[x, y, z, w]``).

Same storage and formulas as the JAX package's ``lie/quaternion.py``
(reference lietorch layout: SE3 data is ``[tx,ty,tz, qx,qy,qz,qw]``). All
functions broadcast over leading dims; the small-angle branches select
between a Taylor series and the exact form with ``torch.where`` on safe
denominators, so neither branch produces NaN at the identity.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1*q2, scalar-last."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (= inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=EPS)


def qrot(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) p by unit quaternion(s) q (uv = 2 q_v x p form)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * cross(qv, p)
    return p + qw * uv + cross(qv, uv)


def qmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) from unit quaternion(s)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    a, b, c = phi.unbind(-1)
    o = torch.zeros_like(a)
    row0 = torch.stack([o, -c, b], -1)
    row1 = torch.stack([c, o, -a], -1)
    row2 = torch.stack([-b, a, o], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """SO3 exponential map: rotation vector (...,3) -> unit quaternion (...,4)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < EPS * EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    imag_exact = torch.sin(0.5 * theta) / theta
    real_exact = torch.cos(0.5 * theta)
    imag_taylor = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_taylor = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    imag = torch.where(small, imag_taylor, imag_exact)
    real = torch.where(small, real_taylor, real_exact)
    return torch.cat([imag * phi, real], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """SO3 logarithm map (atan form): unit quaternion -> rotation vector."""
    qv = q[..., :3]
    w = q[..., 3:4]
    squared_n = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = squared_n < EPS * EPS
    one = torch.ones_like(w)
    n = torch.sqrt(torch.where(small, one, squared_n))
    w_tiny = torch.abs(w) < EPS
    w_safe = torch.where(w_tiny, one, w)
    atan_branch = 2.0 * torch.atan(n / w_safe) / n
    pi_branch = torch.where(w > 0, one * torch.pi, -one * torch.pi) / n
    exact = torch.where(w_tiny, pi_branch, atan_branch)
    taylor = 2.0 / w_safe - (2.0 / 3.0) * squared_n / (w_safe ** 3)
    return torch.where(small, taylor, exact) * qv


def _eye_like(Phi: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=Phi.dtype, device=Phi.device).expand(Phi.shape)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO3 left Jacobian J_l(phi): (...,3) -> (...,3,3)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small = theta_sq < EPS * EPS
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(torch.where(small, one, theta_sq))
    coef1 = torch.where(small, 0.5 - theta_sq / 24.0,
                        (1.0 - torch.cos(theta)) / torch.where(small, one, theta_sq))
    coef2 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                        (theta - torch.sin(theta)) / torch.where(small, one, theta_sq * theta))
    Phi = hat(phi)
    return _eye_like(Phi) + coef1 * Phi + coef2 * (Phi @ Phi)


def so3_left_jacobian_inverse(phi: torch.Tensor) -> torch.Tensor:
    """Inverse SO3 left Jacobian."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small = theta_sq < EPS * EPS
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(torch.where(small, one, theta_sq))
    half = 0.5 * theta
    coef2 = torch.where(
        small, torch.full_like(theta_sq, 1.0 / 12.0),
        (1.0 - theta * torch.cos(half) / (2.0 * torch.sin(half)))
        / torch.where(small, one, theta_sq))
    Phi = hat(phi)
    return _eye_like(Phi) - 0.5 * Phi + coef2 * (Phi @ Phi)
