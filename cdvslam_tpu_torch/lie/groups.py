"""The SE3 Lie group on plain tensors.

Storage matches the JAX package and lietorch: SE3 is ``(..., 7)``
``[tx, ty, tz, qx, qy, qz, qw]``; the tangent is ``[tau(3), phi(3)]``.
SO3, RxSO3 and Sim3 belong to the loop-closure slices and are not here.

``SE3`` is a thin wrapper over a data tensor with the reference operator
API (``G1 * G2``, ``G * point``, ``G.inv()``).
"""
from __future__ import annotations

import torch

from .quaternion import (
    cross, qconj, qmat, qmul, qrot, quat_exp, quat_log, so3_left_jacobian,
    so3_left_jacobian_inverse,
)


def se3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    ident = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                         device=device)
    return ident.expand(tuple(shape) + (7,)).clone()


def se3_exp(tau_phi: torch.Tensor) -> torch.Tensor:
    """(...,6) -> (...,7): t = J_l(phi) tau."""
    tau = tau_phi[..., :3]
    phi = tau_phi[..., 3:6]
    q = quat_exp(phi)
    t = (so3_left_jacobian(phi) @ tau[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def se3_log(data: torch.Tensor) -> torch.Tensor:
    t = data[..., :3]
    phi = quat_log(data[..., 3:7])
    tau = (so3_left_jacobian_inverse(phi) @ t[..., None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def se3_inv(data: torch.Tensor) -> torch.Tensor:
    qi = qconj(data[..., 3:7])
    return torch.cat([-qrot(qi, data[..., :3]), qi], dim=-1)


def se3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ta, qa = a[..., :3], a[..., 3:7]
    tb, qb = b[..., :3], b[..., 3:7]
    return torch.cat([ta + qrot(qa, tb), qmul(qa, qb)], dim=-1)


def se3_act(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return qrot(data[..., 3:7], p) + data[..., :3]


def se3_act4(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Homogeneous action: [R p3 + w t, w]."""
    p3, w = p[..., :3], p[..., 3:4]
    return torch.cat([qrot(data[..., 3:7], p3) + w * data[..., :3], w], dim=-1)


def se3_matrix(data: torch.Tensor) -> torch.Tensor:
    R = qmat(data[..., 3:7])
    top = torch.cat([R, data[..., :3, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=data.dtype,
                          device=data.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_adj(data: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adj(G) a with Adj = [[R, [t]x R], [0, R]]."""
    t, q = data[..., :3], data[..., 3:7]
    Raphi = qrot(q, a[..., 3:6])
    return torch.cat([qrot(q, a[..., :3]) + cross(t, Raphi), Raphi], dim=-1)


def se3_adjT(data: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adj(G)^T a = [R^T a_t ; R^T (a_phi - t x a_t)]."""
    t, q = data[..., :3], data[..., 3:7]
    at, aphi = a[..., :3], a[..., 3:6]
    qi = qconj(q)
    return torch.cat([qrot(qi, at), qrot(qi, aphi - cross(t, at))], dim=-1)


def se3_retr(data: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Retraction Exp(xi) * G."""
    return se3_mul(se3_exp(xi), data)


def se3_scale(data: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Scale the translation part by s (shape data.shape[:-1])."""
    return torch.cat([data[..., :3] * s[..., None], data[..., 3:7]], dim=-1)


class SE3:
    """Wrapper with the reference operator API over a ``(..., 7)`` tensor."""

    def __init__(self, data):
        self.data = data.data if isinstance(data, SE3) else data

    @classmethod
    def Identity(cls, *batch_shape, dtype=torch.float32, device=None):
        if batch_shape and isinstance(batch_shape[0], (tuple, list)):
            batch_shape = tuple(batch_shape[0])
        return cls(se3_identity(batch_shape, dtype, device))

    @classmethod
    def exp(cls, xi):
        return cls(se3_exp(xi))

    def inv(self):
        return SE3(se3_inv(self.data))

    def mul(self, other):
        return SE3(se3_mul(self.data, other.data))

    def act(self, p):
        if p.shape[-1] == 3:
            return se3_act(self.data, p)
        return se3_act4(self.data, p)

    def matrix(self):
        return se3_matrix(self.data)

    def __mul__(self, other):
        if isinstance(other, SE3):
            return self.mul(other)
        return self.act(other)

