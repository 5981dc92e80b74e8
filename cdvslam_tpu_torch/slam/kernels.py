"""SLAM step functions on tensors (port of ``cdvslam_tpu.slam.kernels``).

``update_body`` is one update: reproject the window's patches, correlate
at two pyramid levels (the corr kernel), run the update operator, two
Gauss-Newton BA iterations, and the flow magnitude for the keyframe test.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ba import INFERENCE_PARAMS, ba_solve
from ..geom import flow_mag, transform
from ..lie import SE3, se3_exp, se3_inv, se3_log, se3_mul
from ..models.update import UpdateAux
from ..ops.corr_cuda import corr_pyramid_cl


class EdgeIndex(NamedTuple):
    """Device index arrays of one update (all (E,))."""
    ii: torch.Tensor        # source frame rows (int64)
    jj: torch.Tensor        # target frame rows (int64)
    kk_local: torch.Tensor  # patch rows within the window (int64)
    ctx_idx: torch.Tensor   # imap / gmap ring rows (int64)
    gmap_idx: torch.Tensor  # the same rows as int32, for the corr kernel
    jjm: torch.Tensor       # fmap ring slots of jj (int32)
    aux: UpdateAux          # update-operator index arrays


def corr_features(gmap_buf, fmap1, fmap2, coords, gmap_idx, jjm, radius=3):
    """Two-level correlation (one kernel launch) -> flattened features
    (1, E, 2*49*P*P). coords (E, 2, P, P) float32 at level 1; fmap1/fmap2
    channels-last."""
    E = coords.shape[0]
    return corr_pyramid_cl(gmap_buf, fmap1, fmap2, coords, gmap_idx, jjm,
                           radius).reshape(1, E, -1)


def update_body(model, poses, patches_win, intr_full, imap_buf, gmap_buf,
                fmap1, fmap2, net, idx: EdgeIndex, t0: int, ht4: float,
                wd4: float, mm_sel=None, *, NW: int, KWIN: int, iterations: int):
    """One update over the patch window ``patches_win`` (KWIN rows).

    Returns (poses, patches_win, net, target, weight, delta_norm, mm):
    target (E, 2) = center + the update's delta and weight (E, 2) are what
    the BA solved with; mm is the mean flow magnitude over the edges of each
    of mm_sel's two (E,) masks, computed on the post-BA poses, or None
    without mm_sel. With ``iterations`` 0 no BA runs.
    """
    P = patches_win.shape[-1]
    ii, jj, kk = idx.ii, idx.jj, idx.kk_local
    coords = transform(SE3(poses[None]), patches_win[None], intr_full[None],
                       ii, jj, kk)                                  # (1,E,P,P,2)
    coords_nchw = coords.permute(0, 1, 4, 2, 3)
    corrf = corr_features(gmap_buf, fmap1, fmap2, coords_nchw[0].contiguous(),
                          idx.gmap_idx, idx.jjm)
    ctx = imap_buf[idx.ctx_idx][None]

    # learnable-Fourier rotary encoding of the normalized patch centers
    pc = patches_win[:, :2, P // 2, P // 2][kk]                      # (E, 2)
    shift = torch.tensor([wd4 / 2.0, ht4 / 2.0], dtype=pc.dtype, device=pc.device)
    p_n = ((pc[None] - shift) / max(wd4 / 2.0, ht4 / 2.0)).to(imap_buf.dtype)
    posenc = model.posenc(p_n)
    net_new, d, w = model.update(net[None], ctx, corrf, idx.aux, KWIN, posenc=posenc)

    center = coords[..., P // 2, P // 2, :]
    target = center[0] + d[0].to(poses.dtype)
    weight = w[0].to(poses.dtype)
    if iterations:
        poses, patches_win = ba_solve(
            poses, patches_win, intr_full[0], target, weight, ii, jj, kk, None,
            t0, N=NW, K=KWIN, iterations=iterations, params=INFERENCE_PARAMS)

    mm = None
    if mm_sel is not None:
        fm, _ = flow_mag(SE3(poses[None]), patches_win[None], intr_full[None],
                         ii, jj, kk, beta=0.5)
        fmean = fm[0].mean(dim=(-1, -2))                             # (E,)
        sel = mm_sel.to(fmean.dtype)
        mm = (sel * fmean).sum(-1) / sel.sum(-1).clamp(min=1.0)
    delta_norm = torch.linalg.norm(d[0].float(), dim=-1)
    return poses, patches_win, net_new[0].to(net.dtype), target, weight, delta_norm, mm


def motion_extrapolate(poses, n: int, fac: float, damping: float):
    """DAMPED_LINEAR: pose[n] = Exp(damping*fac*Log(P1 P2^-1)) * P1."""
    if n == 0:
        return poses[0]
    P1 = poses[n - 1]
    if n == 1:
        return P1
    P2 = poses[n - 2]
    xi = damping * fac * se3_log(se3_mul(P1, se3_inv(P2)))
    return se3_mul(se3_exp(xi), P1)
