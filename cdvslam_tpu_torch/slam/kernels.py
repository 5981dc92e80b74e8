"""SLAM step functions on tensors (port of ``cdvslam_tpu.slam.kernels``).

``update_body`` is one update: reproject the window's patches, correlate
at two pyramid levels (the corr kernel), run the update operator (CDV's or
DPVO's), two Gauss-Newton BA iterations, and the flow magnitude for the
keyframe test. Its edges may be padded (``EdgeIndex.aux.mask``): padded
edges read in-range rows and are left out of every sum and of the flow
magnitude. Frame rows and window bases may be 0-d device tensors, so that
a step reads nothing back to the host and can run inside a CUDA graph.
``edge_index`` unpacks the one int32 block an update uploads.
``shift_rows`` deletes a keyframe row (JAX's ``shift_span_body``).
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
from ..models.vonet import VONet
from ..ops.corr_cuda import corr_pyramid_cl

# rows of the packed index block of one update, each E_pad long, then the
# step's scalars (see ``SLAM._prepare_update``)
BLOCK_ROWS = ("ii", "jj", "kk_local", "ctx", "jjm", "ix", "jx", "kseg", "gseg", "perm",
              "inv_perm", "mask", "net_src")
SCALARS = ("n", "fs", "ps", "t0", "k0", "mi", "mj", "shift_k")


class EdgeIndex(NamedTuple):
    """Device index arrays of one update (all (E_pad,))."""
    ii: torch.Tensor        # source frame rows (int64)
    jj: torch.Tensor        # target frame rows (int64)
    kk_local: torch.Tensor  # patch rows within the window (int64)
    ctx_idx: torch.Tensor   # imap / gmap ring rows (int64)
    gmap_idx: torch.Tensor  # the same rows as int32, for the corr kernel
    jjm: torch.Tensor       # fmap ring slots of jj (int32)
    aux: UpdateAux          # update-operator index arrays (mask: the real edges)
    net_src: torch.Tensor   # hidden-state row of each edge, -1 for a new edge (int64)


def edge_index(block, E_pad: int, M=None):
    """(EdgeIndex, scalars) from a flat int32 block: ``BLOCK_ROWS`` rows of
    E_pad, then ``SCALARS`` (a dict of 0-d int64 tensors). ``M``: CDV's
    group size (the rows of ``perm``); None under DPVO (no permutation)."""
    rows = block[: len(BLOCK_ROWS) * E_pad].view(len(BLOCK_ROWS), E_pad)
    r = dict(zip(BLOCK_ROWS, rows.long().unbind(0)))
    tail = block[len(BLOCK_ROWS) * E_pad:].long()
    scal = {name: tail[i] for i, name in enumerate(SCALARS)}
    aux = UpdateAux(r["ix"], r["jx"], r["kseg"], r["gseg"],
                    r["perm"][: E_pad // M * M].view(-1, M) if M else None,
                    r["inv_perm"] if M else None,
                    r["mask"] != 0)
    idx = EdgeIndex(ii=r["ii"], jj=r["jj"], kk_local=r["kk_local"], ctx_idx=r["ctx"],
                    gmap_idx=rows[BLOCK_ROWS.index("ctx")], jjm=rows[BLOCK_ROWS.index("jjm")],
                    aux=aux, net_src=r["net_src"])
    return idx, scal


def corr_features(gmap_buf, fmap1, fmap2, coords, gmap_idx, jjm, radius=3):
    """Two-level correlation (one kernel launch) -> flattened features
    (1, E, 2*49*P*P). coords (E, 2, P, P) float32 at level 1; fmap1/fmap2
    channels-last."""
    E = coords.shape[0]
    return corr_pyramid_cl(gmap_buf, fmap1, fmap2, coords, gmap_idx, jjm,
                           radius).reshape(1, E, -1)


def update_body(model, poses, patches_win, intr_full, imap_buf, gmap_buf,
                fmap1, fmap2, net, idx: EdgeIndex, t0, ht4: float,
                wd4: float, mm_ij=None, weight_mul=None, score_win=None, *,
                NW: int, KWIN: int, iterations: int, stamp=None):
    """One update over the patch window ``patches_win`` (KWIN rows) and the
    E edges of ``idx`` (real where ``idx.aux.mask``).

    Returns (poses, patches_win, net, target, weight, delta_norm, mm):
    target (E, 2) = center + the update's delta and weight (E, 2) are what
    the BA solved with: the network's weight times ``weight_mul`` (E, 2)
    and times the edge's patch score ``score_win[kk_local]`` (the window's
    rows), each where given. mm is the mean flow magnitude over the real
    edges from frame mi to mj and over those from mj to mi (``mm_ij`` =
    (mi, mj), ints or 0-d tensors), computed on the post-BA poses, or None
    without mm_ij. ``t0``: the BA's first pose (int or 0-d tensor). With
    ``iterations`` 0 no BA runs. ``stamp(4)`` (the tracer's device stamp,
    when given) marks the end of the correlation and the update operator.
    """
    P = patches_win.shape[-1]
    ii, jj, kk = idx.ii, idx.jj, idx.kk_local
    coords = transform(SE3(poses[None]), patches_win[None], intr_full[None],
                       ii, jj, kk)                                  # (1,E,P,P,2)
    coords_nchw = coords.permute(0, 1, 4, 2, 3)
    corrf = corr_features(gmap_buf, fmap1, fmap2, coords_nchw[0].contiguous(),
                          idx.gmap_idx, idx.jjm)
    ctx = imap_buf[idx.ctx_idx][None]

    if isinstance(model, VONet):
        # DPVO: SoftAgg over the (i, j) groups, as many segments as edges
        net_new, d, w = model.update(net[None], ctx, corrf, idx.aux, KWIN, ii.shape[0])
    else:
        # learnable-Fourier rotary encoding of the normalized patch centers
        pc = patches_win[:, :2, P // 2, P // 2][kk]                  # (E, 2)
        centred = torch.stack([pc[:, 0] - wd4 / 2.0, pc[:, 1] - ht4 / 2.0], -1)
        p_n = (centred[None] / max(wd4 / 2.0, ht4 / 2.0)).to(imap_buf.dtype)
        posenc = model.posenc(p_n)
        net_new, d, w = model.update(net[None], ctx, corrf, idx.aux, KWIN, posenc=posenc)

    if stamp is not None:
        stamp(4)
    center = coords[..., P // 2, P // 2, :]
    target = center[0] + d[0].to(poses.dtype)
    weight = w[0].to(poses.dtype)
    if weight_mul is not None:
        weight = weight * weight_mul
    if score_win is not None:
        weight = weight * score_win[kk][:, None]
    if iterations:
        poses, patches_win = ba_solve(
            poses, patches_win, intr_full[0], target, weight, ii, jj, kk, idx.aux.mask,
            t0, N=NW, K=KWIN, iterations=iterations, params=INFERENCE_PARAMS)

    mm = None
    if mm_ij is not None:
        mi, mj = mm_ij
        fm, _ = flow_mag(SE3(poses[None]), patches_win[None], intr_full[None],
                         ii, jj, kk, beta=0.5)
        fmean = fm[0].mean(dim=(-1, -2))                             # (E,)
        sel = torch.stack([(ii == mi) & (jj == mj), (ii == mj) & (jj == mi)]) & idx.aux.mask
        mm = (torch.where(sel, fmean, torch.zeros_like(fmean)).sum(-1)
              / sel.to(fmean.dtype).sum(-1).clamp(min=1.0))
    delta_norm = torch.linalg.norm(d[0].float(), dim=-1)
    return poses, patches_win, net_new[0].to(net.dtype), target, weight, delta_norm, mm


def motion_extrapolate(poses, n, dfac):
    """DAMPED_LINEAR: pose[n] = Exp(dfac Log(P1 P2^-1)) P1 with P1, P2 the
    poses of rows n - 1 and n - 2 (row 0 below 0), n a 0-d integer tensor
    and dfac = MOTION_DAMPING * fac a 0-d tensor of the poses' type. The
    runtime's fac is 0 for n < 2, which gives P1 (pose 0 for n = 0)."""
    rows = torch.stack([n - 1, n - 2]).clamp(min=0)
    P1, P2 = poses.index_select(0, rows).unbind(0)
    xi = dfac * se3_log(se3_mul(P1, se3_inv(P2)))
    return se3_mul(se3_exp(xi), P1)


def median(x):
    """The median of a 1-D tensor as ``torch.quantile(x, 0.5)`` computes it
    (sort, then the linear interpolation of the two middle values), with
    no host constant: the same value, and nothing to copy up inside a
    CUDA graph."""
    L = x.shape[0]
    lo = (L - 1) // 2
    s = torch.sort(x).values
    return torch.lerp(s[lo], s[min(lo + 1, L - 1)], 0.5 * (L - 1) - lo)


def shift_rows(st, k, span: int, M: int):
    """Delete keyframe row k of the state dict ``st`` (``PatchGraph.state``):
    frame rows [k+1, k+1+span) move to [k, k+span), with their patch and
    score rows; k an int or a 0-d integer tensor, ``span`` static. The
    feature rings stay put (the runtime's slot tables follow the rows).
    Returns dP = pose_k pose_{k-1}^-1 (the delta chain's entry), taken
    before the shift. Port of ``cdvslam_tpu.slam.kernels.shift_span_body``."""
    poses = st["poses_"]
    dev = poses.device
    k = torch.as_tensor(k, device=dev).reshape(1)
    pair = poses.index_select(0, torch.cat([k, (k - 1).clamp(min=0)]))
    dP = se3_mul(pair[0], se3_inv(pair[1]))
    dst = k + torch.arange(span, device=dev)
    pdst = (dst[:, None] * M + torch.arange(M, device=dev)).reshape(-1)
    for name in ("poses_", "intrinsics_", "seg_", "colors_dev", "scale_"):
        buf = st[name]
        buf.index_copy_(0, dst, buf.index_select(0, dst + 1))
    for name in ("patches_", "score_"):
        buf = st[name]
        buf.index_copy_(0, pdst, buf.index_select(0, pdst + M))
    return dP


def dynamic_class_weight(seg, filt_index, kk):
    """(E, 2) weight factors: 1e-4 where patch kk's seg class (seg (N, M)
    uint8, patch rows flattened) is in ``filt_index``, else 1."""
    hit = (seg.reshape(-1)[kk].long()[:, None] == filt_index).any(-1)
    mul = torch.where(hit, 1e-4, 1.0).to(torch.float32)
    return torch.stack([mul, mul], -1)


def scale_adjustment(poses, patches, scale, t0, n, w: float, M: int, window=None):
    """Pull the window's scale toward the depth head's anchor, in place.

    Over frames [t0, n): rate = 1 + w (anchor / s - 1), with s the mean
    centre inverse depth of the window's patches and anchor the mean of
    ``scale`` over the window's frames; rate is 1 when the rotation between
    poses n-2 and n-1 is under 0.04 rad. The window's inverse depths are
    multiplied by rate and its camera centres move toward frame t0-1's by
    (1 - 1/rate). The window's poses are rebuilt from their inverses even
    when the gate is shut, as the JAX package does. Returns (poses,
    patches, rate) with rate a 0-d tensor, never read on the host here.

    ``t0`` and ``n`` are ints or 0-d integer tensors on the device (inside
    a CUDA graph). The frames are read and written through a static window
    of ``window`` rows ending at n (n - t0 at most ``window``; None: n - t0,
    ints only), rows before t0 masked, so that nothing is read back.
    """
    P, dev = patches.shape[-1], poses.device
    W = window if window is not None else n - t0
    t0, n = (torch.as_tensor(v, device=dev) for v in (t0, n))
    rows = (n - W).clamp(min=0) + torch.arange(W, device=dev)
    live = (rows >= t0) & (rows < n)
    pair = poses.index_select(0, torch.stack([n - 2, n - 1, t0 - 1]).clamp(min=0))
    angle = torch.linalg.norm(se3_log(se3_mul(pair[0], se3_inv(pair[1])))[3:])
    prows = (rows[:, None] * M + torch.arange(M, device=dev)).reshape(-1)
    plive = live[:, None].expand(W, M).reshape(-1)
    win = patches.index_select(0, prows)
    d = torch.where(plive, win[:, 2, P // 2, P // 2], torch.zeros_like(win[:, 0, 0, 0]))
    s = d.sum() / ((n - t0) * M).clamp(min=1)
    a = torch.where(live, scale.index_select(0, rows), torch.zeros_like(rows, dtype=scale.dtype))
    anchor = a.sum() / (n - t0).clamp(min=1)
    rate = 1.0 + w * (anchor / s.clamp(min=1e-8) - 1.0)
    rate = torch.where(angle < 0.04, torch.ones_like(rate), rate)
    win[:, 2] = torch.where(plive[:, None, None], win[:, 2] * rate, win[:, 2])
    patches.index_copy_(0, prows, win)
    old = poses.index_select(0, rows)
    inv = se3_inv(old)
    c_anchor = se3_inv(pair[2])[:3]
    xyz = inv[:, :3] + (1.0 - 1.0 / rate) * (c_anchor - inv[:, :3])
    new = se3_inv(torch.cat([xyz, inv[:, 3:]], -1))
    poses.index_copy_(0, rows, torch.where(live[:, None], new, old))
    return poses, patches, rate
