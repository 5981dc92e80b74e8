"""Sim3 pose-graph optimization, the classical loop closure's solver
(port of ``cdvslam_tpu.ba.pgo``).

A Levenberg-Marquardt solve over the keyframe poses:

  state      Ginv = Log(Sim3(poses))                 (n, 7) tangent
  residual   r_c  = Log(C_c * Exp(Ginv[i_c]) * Exp(Ginv[j_c])^-1)
  constants  consecutive-frame relatives + Sim3 loop measurements

Per-edge Jacobians come from forward-mode autodiff (``torch.func.jacfwd``
under ``vmap``, as the JAX package's ``jax.jacfwd`` under ``jax.vmap``).
The normal equations are summed block by block into a dense (7n x 7n)
system (n is the keyframe count) and solved by Cholesky on the poses'
device. The block sums are ``SegmentPlan`` sums, the port's deterministic
``index_add_``: a solve on the card gives the same result on every run,
on the main stream or on the loop closure's worker stream.

The solve runs in float64 whatever the poses' type. The system's
7-dimensional gauge is damped only by lmbda (from 1e-6) and 1e-8, and in
float32 the LM rejects step after step: on a rendered 64-keyframe loop
the JAX package's float32 solve ends its 30 iterations at a mean squared
residual of 5.9e-4 (1.1e-3 at the start), where float64 reaches 2.1e-5
(ROADMAP Queue 3). In float64 the two packages agree to 1e-12.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..lie import se3_to_sim3, sim3_exp, sim3_inv, sim3_log, sim3_mul
from ..ops.scatter import SegmentPlan


def _residual_one(C, gi, gj):
    """Log(C * Exp(gi) * Exp(gj)^-1) for one constraint."""
    return sim3_log(sim3_mul(C, sim3_mul(sim3_exp(gi), sim3_inv(sim3_exp(gj)))))


def _with_aux(C, gi, gj):
    r = _residual_one(C, gi, gj)
    return r, r


# the residual and its Jacobians in gi and gj, in one forward-mode pass
_res_and_jac = vmap(jacfwd(_with_aux, argnums=(1, 2), has_aux=True))


class _Graph:
    """The constraints and the segment plans of their block sums."""

    def __init__(self, constants, iii, jjj, n):
        self.constants, self.n = constants, n
        self.iii, self.jjj = iii.clamp(0, n - 1), jjj.clamp(0, n - 1)
        i, j = self.iii, self.jjj
        self.plan_A = SegmentPlan(torch.cat([i * n + i, j * n + j, i * n + j, j * n + i]), n * n)
        self.plan_b = SegmentPlan(torch.cat([i, j]), n)

    def residuals(self, Ginv):
        return vmap(_residual_one)(self.constants, Ginv[self.iii], Ginv[self.jjj])


def _pgo_step(Ginv, g: _Graph, lmbda, ep):
    """One LM iteration: (delta (n, 7), mean squared residual)."""
    n = g.n
    (Ji, Jj), r = _res_and_jac(g.constants, Ginv[g.iii], Ginv[g.jjj])   # (R,7,7), (R,7)
    JiTJi = torch.einsum("rab,rac->rbc", Ji, Ji)
    JjTJj = torch.einsum("rab,rac->rbc", Jj, Jj)
    JiTJj = torch.einsum("rab,rac->rbc", Ji, Jj)
    A = g.plan_A.sum(torch.cat([JiTJi, JjTJj, JiTJj, JiTJj.transpose(1, 2)], 0))
    A = A.reshape(n, n, 7, 7).permute(0, 2, 1, 3).reshape(7 * n, 7 * n)
    bi = -torch.einsum("rab,ra->rb", Ji, r)
    bj = -torch.einsum("rab,ra->rb", Jj, r)
    b = g.plan_b.sum(torch.cat([bi, bj], 0)).reshape(7 * n)

    # damping: A.diag *= (1 + lmbda); A.diag += ep
    A = A + torch.diag(lmbda * torch.diagonal(A) + ep + 1e-8)
    L, _ = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(b[:, None], L)[:, 0]
    # a failed factorization leaves NaN in L: no step, as the JAX solve
    delta = torch.where(torch.isnan(delta).any(), torch.zeros_like(delta), delta)
    return delta.reshape(n, 7), torch.mean(r * r)


def perform_updates(input_poses, dSloop, ii_loop, jj_loop, iters=30, ep=0.0, lmbda=1e-6):
    """The LM loop: host-side adaptive lambda and stop rule.

    input_poses: (n, 7) SE3 world->cam tensor (the patch-graph
    convention); the solve runs on its device in float64. dSloop: (L, 8)
    Sim3 loop measurements mapping points in camera ii_loop's frame to
    camera jj_loop's frame (the RANSAC-Umeyama output). The state is the
    log of the world->cam Sim3, so a loop residual vanishes when C = G_j
    G_i^-1 with G world->cam: the physical cam_i -> cam_j measurement.

    Returns (n, 8) world->cam Sim3 corrected poses in float64.
    """
    poses = input_poses.to(torch.float64)
    n, dev = poses.shape[0], poses.device
    pred_inv = se3_to_sim3(poses)                         # world->cam
    kk = torch.arange(1, n, device=dev)
    ll = kk - 1
    dSij = sim3_mul(pred_inv[ll], sim3_inv(pred_inv[kk]))
    dSloop = torch.as_tensor(dSloop).to(device=dev, dtype=poses.dtype).reshape(-1, 8)

    def index(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    g = _Graph(torch.cat([dSij, dSloop]), torch.cat([kk, index(ii_loop)]),
               torch.cat([ll, index(jj_loop)]), n)
    Ginv = sim3_log(pred_inv)
    hist = []
    for itr in range(iters):
        delta, rsq = _pgo_step(Ginv, g, lmbda, ep)
        hist.append(float(rsq))
        G_tmp = Ginv + delta
        r = g.residuals(G_tmp)
        if float(torch.mean(r * r)) < hist[-1]:
            Ginv = G_tmp
            lmbda /= 2
        else:
            lmbda *= 2
        if hist[-1] < 1e-5 and itr >= 4 and (hist[-5] / max(hist[-1], 1e-30)) < 1.5:
            break
    return sim3_exp(Ginv)


def run_pgo(pred_poses, loop_poses, loop_ii, loop_jj, iters=30):
    """The whole PGO call with its re-anchoring.

    pred_poses: (n, 7) SE3 world->cam tensor. Returns (safe_i, corrected
    (safe_i, 8) world->cam Sim3 poses in float64). The anchor keeps pose
    safe_i at its pre-correction value; in the world->cam frame the gauge
    acts on the world side, by RIGHT multiplication.
    """
    final = perform_updates(pred_poses, loop_poses, loop_ii, loop_jj, iters)
    safe_i = int(np.max(np.asarray(loop_ii))) + 1
    aa = se3_to_sim3(pred_poses.to(torch.float64))
    ai = min(safe_i, len(aa) - 1)   # anchor row (loop at the last pose)
    anchor = sim3_mul(sim3_inv(final[ai]), aa[ai])
    return safe_i, sim3_mul(final, anchor[None])[:safe_i]
