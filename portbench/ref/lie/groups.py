# Frozen copy of cdvslam_tpu_torch/lie/groups.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""The SO3, RxSO3, SE3 and Sim3 Lie groups on plain tensors.

Storage matches the JAX package and lietorch (trailing dim):

  SO3   (..., 4)  [qx, qy, qz, qw]
  RxSO3 (..., 5)  [qx, qy, qz, qw, s]
  SE3   (..., 7)  [tx, ty, tz, qx, qy, qz, qw]
  Sim3  (..., 8)  [tx, ty, tz, qx, qy, qz, qw, s]

Tangents: SE3 ``[tau(3), phi(3)]``, Sim3 ``[tau(3), phi(3), sigma]``.
The small-angle and small-scale branches compute every branch on safe
denominators and select with nested ``torch.where`` in the JAX package's
order, so values and forward-mode tangents (the Sim3 PGO's Jacobians)
stay finite at the identity.

``SE3`` and ``Sim3`` are thin wrappers over a data tensor with the
reference operator API (``G1 * G2``, ``G * point``, ``G.inv()``).
"""
from __future__ import annotations

import torch

from .quaternion import (
    EPS, cross, hat, qconj, qmat, qmul, qrot, quat_exp, quat_log, so3_left_jacobian,
    so3_left_jacobian_inverse,
)

# --------------------------------------------------------------------------
# SO3
# --------------------------------------------------------------------------


def so3_adj(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return qrot(q, a)


def so3_adjT(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return qrot(qconj(q), a)


# --------------------------------------------------------------------------
# RxSO3
# --------------------------------------------------------------------------


def rxso3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], dtype=dtype, device=device)
    return ident.expand(tuple(shape) + (5,)).clone()


def rxso3_exp(phi_sigma: torch.Tensor) -> torch.Tensor:
    """(..., 4) [phi(3), sigma] -> (..., 5)."""
    return torch.cat([quat_exp(phi_sigma[..., :3]), torch.exp(phi_sigma[..., 3:4])], dim=-1)


def rxso3_log(data: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_log(data[..., :4]), torch.log(data[..., 4:5])], dim=-1)


def rxso3_inv(data: torch.Tensor) -> torch.Tensor:
    return torch.cat([qconj(data[..., :4]), 1.0 / data[..., 4:5]], dim=-1)


def rxso3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([qmul(a[..., :4], b[..., :4]), a[..., 4:5] * b[..., 4:5]], dim=-1)


def rxso3_act(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return data[..., 4:5] * qrot(data[..., :4], p)


def rxso3_matrix3(data: torch.Tensor) -> torch.Tensor:
    return data[..., 4:5, None] * qmat(data[..., :4])


def _calcW_coeffs(theta_sq, sigma):
    """A, B, C of calcW: a four-way branch on (|sigma| small) x (theta
    small), every branch on safe denominators, selected with nested where."""
    small_t = theta_sq < EPS * EPS
    small_s = torch.abs(sigma) < EPS
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(torch.where(small_t, one, theta_sq))
    theta_sq_safe = torch.where(small_t, one, theta_sq)
    sigma_safe = torch.where(small_s, torch.ones_like(sigma), sigma)
    scale = torch.exp(sigma)

    # sigma small
    C_ss = torch.ones_like(sigma)
    A_ss_t = 0.5 * torch.ones_like(sigma)                      # theta small too
    B_ss_t = torch.full_like(sigma, 1.0 / 6.0)
    A_ss = (1.0 - torch.cos(theta)) / theta_sq_safe
    B_ss = (theta - torch.sin(theta)) / (theta_sq_safe * theta)

    # sigma not small
    C_sl = (scale - 1.0) / sigma_safe
    sigma_sq = sigma_safe * sigma_safe
    A_sl_t = ((sigma_safe - 1.0) * scale + 1.0) / sigma_sq
    B_sl_t = (scale * 0.5 * sigma_sq + scale - 1.0 - sigma_safe * scale) / (sigma_sq * sigma_safe)
    a_ = scale * torch.sin(theta)
    b_ = scale * torch.cos(theta)
    c_ = theta_sq_safe + sigma * sigma
    A_sl = (a_ * sigma + (1.0 - b_) * theta) / (theta * c_)
    B_sl = (C_sl - ((b_ - 1.0) * sigma + a_ * theta) / c_) / theta_sq_safe

    A = torch.where(small_s, torch.where(small_t, A_ss_t, A_ss),
                    torch.where(small_t, A_sl_t, A_sl))
    B = torch.where(small_s, torch.where(small_t, B_ss_t, B_ss),
                    torch.where(small_t, B_sl_t, B_sl))
    C = torch.where(small_s, C_ss, C_sl)
    return A, B, C


def _phi_sigma_parts(phi_sigma):
    phi = phi_sigma[..., :3]
    sigma = phi_sigma[..., 3:4, None]
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    Phi = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return theta_sq, sigma, Phi, eye


def rxso3_calcW(phi_sigma: torch.Tensor) -> torch.Tensor:
    """W matrix of Sim3 exp: t = W(phi, sigma) tau."""
    theta_sq, sigma, Phi, eye = _phi_sigma_parts(phi_sigma)
    A, B, C = _calcW_coeffs(theta_sq, sigma)
    return A * Phi + B * (Phi @ Phi) + C * eye


def _calcWinv_coeffs(theta_sq, sigma):
    """a, b, c of calcWInv (same branch structure as ``_calcW_coeffs``)."""
    small_t = theta_sq < EPS
    small_s = (sigma * sigma) < EPS
    one = torch.ones_like(theta_sq)
    one_s = torch.ones_like(sigma)
    theta = torch.sqrt(torch.where(small_t, one, theta_sq))
    theta_sq_safe = torch.where(small_t, one, theta_sq)
    scale = torch.exp(sigma)
    scale_sq = scale * scale
    scale_cu = scale_sq * scale
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    scale_m1 = torch.where(small_s, one_s, scale - 1.0)
    both = small_s & small_t

    # sigma small
    c_ss = 1.0 - 0.5 * sigma
    a_ss = torch.full_like(sigma, -0.5)
    b_ss_t = torch.full_like(sigma, 1.0 / 12.0)
    denom_b = 2.0 * theta_sq_safe * torch.where(small_t, one, cos_t - 1.0)
    b_ss = (theta * sin_t + 2.0 * cos_t - 2.0) / denom_b

    # sigma not small
    c_sl = sigma / scale_m1
    a_sl_t = (-sigma * scale + scale - 1.0) / (scale_m1 * scale_m1)
    denom_bt = torch.where(small_s, one_s, 2.0 * scale_cu - 6.0 * scale_sq + 6.0 * scale - 2.0)
    b_sl_t = (scale_sq * sigma - 2.0 * scale_sq + scale * sigma + 2.0 * scale) / denom_bt
    s_sin, s_cos = scale * sin_t, scale * cos_t
    denom_a = theta * torch.where(both, torch.ones_like(s_cos), scale_sq - 2.0 * s_cos + 1.0)
    a_sl = (theta * s_cos - theta - sigma * s_sin) / denom_a
    denom_bl = theta_sq_safe * torch.where(
        both, torch.ones_like(s_cos),
        scale_cu - 2.0 * scale * s_cos - scale_sq + 2.0 * s_cos + scale - 1.0)
    b_sl = -scale * (theta * s_sin - theta * sin_t + sigma * s_cos - scale * sigma
                     + sigma * cos_t - sigma) / denom_bl

    a = torch.where(small_s, a_ss, torch.where(small_t, a_sl_t, a_sl))
    b = torch.where(small_s, torch.where(small_t, b_ss_t, b_ss),
                    torch.where(small_t, b_sl_t, b_sl))
    c = torch.where(small_s, c_ss, c_sl)
    return a, b, c


def rxso3_calcWinv(phi_sigma: torch.Tensor) -> torch.Tensor:
    theta_sq, sigma, Phi, eye = _phi_sigma_parts(phi_sigma)
    a, b, c = _calcWinv_coeffs(theta_sq, sigma)
    return a * Phi + b * (Phi @ Phi) + c * eye


def rxso3_adj(data: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Adj is the identity but for the rotation block."""
    return torch.cat([qrot(data[..., :4], a[..., :3]), a[..., 3:4]], dim=-1)


def rxso3_adjT(data: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.cat([qrot(qconj(data[..., :4]), a[..., :3]), a[..., 3:4]], dim=-1)


# --------------------------------------------------------------------------
# SE3
# --------------------------------------------------------------------------


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


# --------------------------------------------------------------------------
# Sim3
# --------------------------------------------------------------------------


def sim3_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    ident = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0], dtype=dtype,
                         device=device)
    return ident.expand(tuple(shape) + (8,)).clone()


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) [tau, phi, sigma] -> (..., 8): t = W(phi, sigma) tau."""
    phi_sigma = xi[..., 3:7]
    t = (rxso3_calcW(phi_sigma) @ xi[..., :3, None])[..., 0]
    return torch.cat([t, rxso3_exp(phi_sigma)], dim=-1)


def sim3_log(data: torch.Tensor) -> torch.Tensor:
    phi_sigma = rxso3_log(data[..., 3:8])
    tau = (rxso3_calcWinv(phi_sigma) @ data[..., :3, None])[..., 0]
    return torch.cat([tau, phi_sigma], dim=-1)


def sim3_inv(data: torch.Tensor) -> torch.Tensor:
    rxi = rxso3_inv(data[..., 3:8])
    return torch.cat([-rxso3_act(rxi, data[..., :3]), rxi], dim=-1)


def sim3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ta, rxa = a[..., :3], a[..., 3:8]
    tb, rxb = b[..., :3], b[..., 3:8]
    return torch.cat([ta + rxso3_act(rxa, tb), rxso3_mul(rxa, rxb)], dim=-1)


def sim3_act(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return rxso3_act(data[..., 3:8], p) + data[..., :3]


def sim3_act4(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    p3, w = p[..., :3], p[..., 3:4]
    return torch.cat([rxso3_act(data[..., 3:8], p3) + w * data[..., :3], w], dim=-1)


def sim3_matrix(data: torch.Tensor) -> torch.Tensor:
    top = torch.cat([rxso3_matrix3(data[..., 3:8]), data[..., :3, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=data.dtype,
                          device=data.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def sim3_adj(data: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    t, q, s = data[..., :3], data[..., 3:7], data[..., 7:8]
    asig = a[..., 6:7]
    Raphi = qrot(q, a[..., 3:6])
    out_t = s * qrot(q, a[..., :3]) + cross(t, Raphi) - t * asig
    return torch.cat([out_t, Raphi, asig], dim=-1)


def sim3_adjT(data: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    t, q, s = data[..., :3], data[..., 3:7], data[..., 7:8]
    at, aphi, asig = a[..., :3], a[..., 3:6], a[..., 6:7]
    qi = qconj(q)
    out_sig = asig - torch.sum(t * at, dim=-1, keepdim=True)
    return torch.cat([s * qrot(qi, at), qrot(qi, aphi - cross(t, at)), out_sig], dim=-1)


def sim3_retr(data: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return sim3_mul(sim3_exp(xi), data)


def se3_to_sim3(data: torch.Tensor) -> torch.Tensor:
    """SE3 (..., 7) -> Sim3 (..., 8) with scale 1."""
    return torch.cat([data, torch.ones_like(data[..., :1])], dim=-1)


# --------------------------------------------------------------------------
# Operator wrappers
# --------------------------------------------------------------------------


class _LieGroup:
    """Wrapper with the reference operator API over a data tensor; each
    group names its functions in ``_ops``."""

    _ops: dict

    def __init__(self, data):
        self.data = data.data if isinstance(data, _LieGroup) else data

    @classmethod
    def Identity(cls, *batch_shape, dtype=torch.float32, device=None):
        if batch_shape and isinstance(batch_shape[0], (tuple, list)):
            batch_shape = tuple(batch_shape[0])
        return cls(cls._ops["identity"](batch_shape, dtype, device))

    @classmethod
    def exp(cls, xi):
        return cls(cls._ops["exp"](xi))

    def inv(self):
        return type(self)(self._ops["inv"](self.data))

    def mul(self, other):
        return type(self)(self._ops["mul"](self.data, other.data))

    def act(self, p):
        if p.shape[-1] == 3:
            return self._ops["act"](self.data, p)
        return self._ops["act4"](self.data, p)

    def matrix(self):
        return self._ops["matrix"](self.data)

    def __mul__(self, other):
        if isinstance(other, _LieGroup):
            return self.mul(other)
        return self.act(other)


class SE3(_LieGroup):
    _ops = dict(identity=se3_identity, exp=se3_exp, inv=se3_inv, mul=se3_mul, act=se3_act,
                act4=se3_act4, matrix=se3_matrix)


class Sim3(_LieGroup):
    _ops = dict(identity=sim3_identity, exp=sim3_exp, inv=sim3_inv, mul=sim3_mul,
                act=sim3_act, act4=sim3_act4, matrix=sim3_matrix)

    @classmethod
    def from_se3(cls, data):
        return cls(se3_to_sim3(data.data if isinstance(data, SE3) else data))
