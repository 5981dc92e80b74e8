"""SLAM step functions on tensors (port of ``cdvslam_tpu.slam.kernels``).

``update_body`` is one update: reproject the window's patches, correlate
at two pyramid levels (the corr kernel), run the update operator, two
Gauss-Newton BA iterations, and the flow magnitude for the keyframe test.
``dynamic_class_weight`` and ``scale_adjustment`` are the seg and depth
heads' hooks into the update.
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
                wd4: float, mm_sel=None, weight_mul=None, score_win=None, *,
                NW: int, KWIN: int, iterations: int):
    """One update over the patch window ``patches_win`` (KWIN rows).

    Returns (poses, patches_win, net, target, weight, delta_norm, mm):
    target (E, 2) = center + the update's delta and weight (E, 2) are what
    the BA solved with: the network's weight times ``weight_mul`` (E, 2)
    and times the edge's patch score ``score_win[kk_local]`` (the window's
    rows), each where given. mm is the mean flow magnitude over the edges
    of each of mm_sel's two (E,) masks, computed on the post-BA poses, or
    None without mm_sel. With ``iterations`` 0 no BA runs.
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
    if weight_mul is not None:
        weight = weight * weight_mul
    if score_win is not None:
        weight = weight * score_win[kk][:, None]
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


def dynamic_class_weight(seg, filt_index, kk):
    """(E, 2) weight factors: 1e-4 where patch kk's seg class (seg (N, M)
    uint8, patch rows flattened) is in ``filt_index``, else 1."""
    hit = torch.isin(seg.reshape(-1)[kk].long(), filt_index)
    mul = torch.where(hit, 1e-4, 1.0).to(torch.float32)
    return torch.stack([mul, mul], -1)


def scale_adjustment(poses, patches, scale, t0: int, n: int, w: float, M: int):
    """Pull the window's scale toward the depth head's anchor, in place.

    Over frames [t0, n): rate = 1 + w (anchor / s - 1), with s the mean
    centre inverse depth of the window's patches and anchor the mean of
    ``scale`` over the window's frames; rate is 1 when the rotation between
    poses n-2 and n-1 is under 0.04 rad. The window's inverse depths are
    multiplied by rate and its camera centres move toward frame t0-1's by
    (1 - 1/rate). The window's poses are rebuilt from their inverses even
    when the gate is shut, as the JAX package does. Returns (poses,
    patches, rate) with rate a 0-d tensor, never read on the host here.
    """
    P = patches.shape[-1]
    angle = torch.linalg.norm(se3_log(se3_mul(poses[max(n - 2, 0)],
                                              se3_inv(poses[max(n - 1, 0)])))[3:])
    win = patches[t0 * M:n * M]
    s = win[:, 2, P // 2, P // 2].sum() / max(win.shape[0], 1)
    anchor = scale[t0:n].sum() / max(n - t0, 1)
    rate = 1.0 + w * (anchor / s.clamp(min=1e-8) - 1.0)
    rate = torch.where(angle < 0.04, torch.ones_like(rate), rate)
    win[:, 2] *= rate
    inv = se3_inv(poses[t0:n])
    c_anchor = se3_inv(poses[max(t0 - 1, 0)])[:3]
    xyz = inv[:, :3] + (1.0 - 1.0 / rate) * (c_anchor - inv[:, :3])
    poses[t0:n] = se3_inv(torch.cat([xyz, inv[:, 3:]], -1))
    return poses, patches, rate
