"""Trajectory evaluation: Umeyama alignment + ATE RMSE (a copy of
``cdvslam_tpu.eval.ate``, which imports no JAX).

Replaces the reference's dependency on the ``evo`` package
(reference: evaluate_tartan.py:63-70 -- ATE RMSE of the translation part
after Sim3 alignment with scale correction).
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares similarity transform aligning x -> y.

    x, y: (3, N). Returns (R, t, c) with y ~ c R x + t.
    Umeyama, TPAMI 1991.
    """
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc = x - mx
    yc = y - my
    sigma_x = (xc ** 2).sum() / x.shape[1]
    cov = yc @ xc.T / x.shape[1]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    c = np.trace(np.diag(D) @ S) / sigma_x if with_scale else 1.0
    t = my - c * R @ mx
    return R, t, c


def ate_rmse(traj_est, traj_gt, align=True, correct_scale=True):
    """ATE RMSE between two (N, >=3) translation trajectories."""
    x = np.asarray(traj_est)[:, :3].T
    y = np.asarray(traj_gt)[:, :3].T
    if align:
        R, t, c = umeyama_alignment(x, y, with_scale=correct_scale)
        x = c * R @ x + t
    err = np.linalg.norm(x - y, axis=0)
    return float(np.sqrt(np.mean(err ** 2)))


def associate_timestamps(t_a, t_b, max_diff=0.08):
    """Greedy nearest-neighbor timestamp association (evo.sync stand-in)."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - ta)))
        if abs(t_b[j] - ta) <= max_diff:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia), np.asarray(ib)
