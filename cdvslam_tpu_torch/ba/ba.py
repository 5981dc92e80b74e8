"""Bundle adjustment over window poses and patch inverse depths
(port of ``cdvslam_tpu.ba.ba_solve`` with the 'scatter' assembly).

Damped Gauss-Newton: the Hessian blocks B (pose-pose), E (pose-depth), C
(depth diagonal) and gradients v, u are summed per segment with the
deterministic ``SegmentPlan`` (stable sort + ordered segment reduce), the
Schur complement S = B - E Q E^T is a dense (6N x 6N) matmul, and the
solve is a Cholesky factorization of the damped SPD system. Two runs on
the same inputs give bitwise-equal results.

Shapes:
  poses      (NP, 7)   full pose buffer (only window [t0, t0+N) is updated)
  patches    (K, 3, P, P) patch window (channel 2 = inverse depth)
  target     (E, 2), weight (E, 2)
  ii, jj     (E,) frame indices; kk (E,) patch index within the window
  mask       (E,) valid-edge mask, or None
  t0         first optimized pose (host int); poses < t0 are fixed
  N          size of the optimized pose window (ix = ii - t0)

The training rollout's numerics (``TRAINING_PARAMS``: more damping, a
wider residual gate, the depth clamp to [1e-3, 10]), its bounds gate
(``bounds``) and ``structure_only`` (depths only) are options; the
inference path is unchanged by them. The whole solve is differentiable:
the training rollout backpropagates through it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import se3_adjT, se3_retr
from ..lie.quaternion import qconj, qmul, qrot
from ..ops.scatter import SegmentPlan


class BAParams(NamedTuple):
    """Numeric knobs. Defaults = inference solver."""
    lmbda: float = 1e-4          # depth damping, Q = 1/(C + lmbda)
    ep: float = 1.0              # diagonal damping S += I*(lm*S + ep)
    lm: float = 1e-4
    res_thresh: float = 128.0    # residual magnitude gate (pixels)
    z_min: float = 0.2           # min depth for a valid residual
    bounds_margin: float = 64.0  # projection must lie in [-m, 2c+m]
    depth_clamp_mode: str = "inference"  # 'inference' | 'training'


INFERENCE_PARAMS = BAParams()
# the training rollout's numerics
TRAINING_PARAMS = BAParams(ep=10.0, res_thresh=250.0, depth_clamp_mode="training")


def _edge_terms(poses, patches, intrinsics, target, ii, jj, kk, z_min):
    """Per-edge residuals r, Jacobians (Ji, Jj, Jz) and (x1, y1, Z):
    center-pixel homogeneous reprojection, Jacobians w.r.t. the left
    retraction of poses i / j and the patch inverse depth."""
    fx, fy, cx, cy = intrinsics.unbind(0)
    gi, gj = poses[ii], poses[jj]
    ti, qi = gi[:, :3], gi[:, 3:7]
    tj, qj = gj[:, :3], gj[:, 3:7]
    qij = qmul(qj, qconj(qi))
    tij = tj - qrot(qij, ti)

    P = patches.shape[-1]
    pc = patches[:, :, P // 2, P // 2][kk]                      # (E, 3)
    xn = (pc[:, 0] - cx) / fx
    yn = (pc[:, 1] - cy) / fy
    d0 = pc[:, 2]
    Xi = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    Xj3 = qrot(qij, Xi) + d0[:, None] * tij
    X, Y, Z = Xj3.unbind(-1)
    W = d0

    Z_safe = torch.where(torch.abs(Z) > 1e-8, Z, torch.full_like(Z, 1e-8))
    d = torch.where(Z >= z_min, 1.0 / Z_safe, torch.zeros_like(Z))
    d2 = d * d
    x1 = fx * (X / Z_safe) + cx
    y1 = fy * (Y / Z_safe) + cy
    r = torch.stack([target[:, 0] - x1, target[:, 1] - y1], dim=1)

    o = torch.zeros_like(X)
    Jj_x = torch.stack([fx * W * d, o, -fx * X * W * d2,
                        -fx * X * Y * d2, fx * (1.0 + X * X * d2), -fx * Y * d], -1)
    Jj_y = torch.stack([o, fy * W * d, -fy * Y * W * d2,
                        -fy * (1.0 + Y * Y * d2), fy * X * Y * d2, fy * X * d], -1)
    Jz_x = fx * (tij[:, 0] * d - tij[:, 2] * X * d2)
    Jz_y = fy * (tij[:, 1] * d - tij[:, 2] * Y * d2)
    Jj = torch.stack([Jj_x, Jj_y], dim=1)                      # (E, 2, 6)
    Jz = torch.stack([Jz_x, Jz_y], dim=1)                      # (E, 2)
    gij = torch.cat([tij, qij], dim=-1)
    Ji = se3_adjT(gij[:, None, :], Jj)                          # (E, 2, 6)
    return r, Ji, Jj, Jz, (x1, y1, Z)


def _validity(r, x1, y1, Z, cx, cy, params: BAParams, bounds):
    """The edges whose residual enters the solve. Inference: residual below
    res_thresh, Z above z_min, projection inside the image plus the margin.
    Training (``bounds`` = (x0, y0, x1, y1)): Z, residual, and the box."""
    rn = torch.sqrt(torch.sum(r * r, dim=-1))
    if bounds is None:
        m = params.bounds_margin
        return ((rn < params.res_thresh) & (Z > params.z_min)
                & (x1 > -m) & (y1 > -m) & (x1 < 2 * cx + m) & (y1 < 2 * cy + m))
    return ((Z > params.z_min) & (rn < params.res_thresh)
            & (x1 > bounds[0]) & (y1 > bounds[1]) & (x1 < bounds[2]) & (y1 < bounds[3]))


def ba_solve(poses, patches, intrinsics, target, weight, ii, jj, kk, mask, t0,
             *, N: int, K: int, iterations: int = 2,
             params: BAParams = INFERENCE_PARAMS, structure_only: bool = False,
             bounds=None):
    """Damped Gauss-Newton; returns (poses, patches) with the window updated
    (new tensors; the inputs are not modified). ``structure_only``: solve
    the depths alone (dZ = Q u), poses fixed. ``bounds``: the training
    gate's box (x0, y0, x1, y1) in place of the inference margin."""
    cx, cy = intrinsics[2], intrinsics[3]
    dtype = poses.dtype
    dev = poses.device
    E = ii.shape[0]
    NP = poses.shape[0]
    ii, jj, kk = ii.long().clamp(0, NP - 1), jj.long().clamp(0, NP - 1), kk.long()
    if mask is None:
        mask = torch.ones(E, dtype=torch.bool, device=dev)

    # segment ids do not change between iterations: plan every sum once
    ix, jx = ii - t0, jj - t0
    vi, vj = ix >= 0, jx >= 0
    kid = kk.clamp(0, K - 1)
    bad = N * N

    def bid(a, b, va, vb):
        return torch.where(va & vb & mask, a.clamp(0, N - 1) * N + b.clamp(0, N - 1),
                           torch.full_like(a, bad))

    def eid(a, va):
        return torch.where(va & mask, a.clamp(0, N - 1) * K + kid,
                           torch.full_like(a, N * K))

    def vid(a, va):
        return torch.where(va & mask, a.clamp(0, N - 1), torch.full_like(a, N))

    plan_b = SegmentPlan(torch.cat([bid(ix, ix, vi, vi), bid(jx, jx, vj, vj),
                                    bid(ix, jx, vi, vj), bid(jx, ix, vj, vi)]), N * N)
    plan_e = SegmentPlan(torch.cat([eid(ix, vi), eid(jx, vj)]), N * K)
    plan_k = SegmentPlan(torch.where(mask, kid, torch.full_like(kid, K)), K)
    plan_v = SegmentPlan(torch.cat([vid(ix, vi), vid(jx, vj)]), N)
    touched = plan_k.sum(mask.to(torch.float32)) > 0
    win = torch.arange(t0, t0 + max(min(N, NP - t0), 0), device=dev)

    for _ in range(iterations):
        r, Ji, Jj, Jz, (x1, y1, Z) = _edge_terms(
            poses, patches, intrinsics, target, ii, jj, kid, params.z_min)
        inb = _validity(r, x1, y1, Z, cx, cy, params, bounds)
        ok = (inb & mask)[:, None]
        w = weight * ok.to(dtype)
        r = torch.where(ok, r, torch.zeros_like(r))

        def blk(Ja, Jb):
            return torch.einsum("er,eri,erj->eij", w, Ja, Jb)

        Bii, Bjj, Bij = blk(Ji, Ji), blk(Jj, Jj), -blk(Ji, Jj)
        ei = -torch.einsum("er,eri,er->ei", w, Ji, Jz)
        ej = torch.einsum("er,eri,er->ei", w, Jj, Jz)
        vi_vec = -torch.einsum("er,eri->ei", w * r, Ji)
        vj_vec = torch.einsum("er,eri->ei", w * r, Jj)

        Bflat = plan_b.sum(torch.cat([Bii, Bjj, Bij, Bij.transpose(1, 2)], 0))
        B = Bflat.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
        Emat = plan_e.sum(torch.cat([ei, ej], 0)).reshape(N, K, 6)
        C = plan_k.sum(torch.sum(w * Jz * Jz, -1))
        u = plan_k.sum(torch.sum(w * r * Jz, -1))
        v = plan_v.sum(torch.cat([vi_vec, vj_vec], 0)).reshape(6 * N)

        Q = 1.0 / (C + params.lmbda)
        if structure_only:
            dZ = Q * u
        else:
            Ef = Emat.permute(0, 2, 1).reshape(6 * N, K)
            EQ = Ef * Q[None, :]
            S = B - EQ @ Ef.T
            y = v - EQ @ u
            S = S + torch.diag(params.lm * torch.diagonal(S) + params.ep)
            L, info = torch.linalg.cholesky_ex(S)
            dX_flat = torch.cholesky_solve(y[:, None], L)[:, 0]
            # zeros when the factorization fails
            failed = (info != 0) | torch.isnan(dX_flat).any()
            dX_flat = torch.where(failed, torch.zeros_like(dX_flat), dX_flat)
            dZ = Q * (u - Ef.T @ dX_flat)
            dX = dX_flat.reshape(N, 6)

            poses = poses.clone()
            poses[win] = se3_retr(poses[win], dX[: win.shape[0]].to(dtype))

        d_old = patches[:, 2, 0, 0]
        d_new = d_old + dZ.to(dtype)
        if params.depth_clamp_mode == "training":
            d_new = torch.where(touched, d_new.clamp(1e-3, 10.0), d_old)
        else:
            # reset exploded depths, floor at 1e-4 (the inference solver's clamps)
            d_new = torch.where(d_new > 20.0, torch.ones_like(d_new), d_new)
            d_new = torch.where(touched, d_new.clamp(min=1e-4), d_old)
        patches = patches.clone()
        patches[:, 2] = d_new[:, None, None]
    return poses, patches
