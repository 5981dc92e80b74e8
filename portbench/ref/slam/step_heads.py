"""The reference of one steady-state CDVO++ step, plain PyTorch.

It follows the program's steady-state frame with its heads
(``cdvslam_tpu_torch/slam/runtime.py`` ``_patches_cdv``, ``_insert_frame``,
``_update_step`` and ``slam/fused.py`` ``fused_body``): the deferred
keyframe shift, CDVNet's features with SCORE selection (the seg head's
dynamic-class mask, ``seg_binary_score``, a Gumbel top-k over the token
grid), the chosen patches' seg classes, the linear depth head's map,
antialiased to the matching features' grid, as the new patches' inverse
depths and the frame's scale anchor, the frame's writes, one update whose
weights take the dynamic-class factors and the patch scores, and, after
the BA (``ba_scale_stage``), the depth-anchored scale adjustment. It is
built from ``step.py``'s pieces and the frozen modules beside it.

Where a discrete choice sits between two stages, the step is fed the
program's own output past it (``Staged``): the program's chosen cells
(the reference still makes its own selection from its own tokens with the
same uniforms, for comparison), its seg classes and its score row. So a
near tie moves one number, not every one after it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geom import transform
from ..lie import SE3, se3_inv, se3_log, se3_mul
from ..models.heads import DepthHeadFlatten, SegHeadFlatten, resize
from ..models.patchifier import coords_grid_with_index, pyramidify, seg_binary_score, select_score
from ..ops.patchify import patchify
from .kernels import (
    SCALARS, dynamic_class_weight, edge_index, motion_extrapolate, shift_rows, update_body,
)
from .step import Settings, StepKey, _put, ba_stage

# ADE20K classes the dynamic-class filter treats as dynamic (0-based), as
# cdvslam_tpu_torch/models/datamaps.py lists them
ADE20K_INDEX_FILT = (3, 13, 21, 22, 27, 44, 61, 81, 84, 91, 103, 104, 110, 114, 117, 127, 128,
                     129)
SCALE_F2I = 4.0 / 14.0      # fine (1/4 resolution) to DINO token coordinates
SCALE_RATE = 0.2            # the scale adjustment's pull toward the anchor


class Heads(NamedTuple):
    """The two heads and the dynamic class ids, on one device."""
    seg: SegHeadFlatten
    depth: DepthHeadFlatten
    filt: torch.Tensor


class Staged(NamedTuple):
    """A step's discrete outputs that the reference is fed past its own:
    the chosen cells (M,) as token indices, the new frame's seg classes
    (M,) uint8 and its score row (M,)."""
    cells: torch.Tensor
    seg: torch.Tensor
    score: torch.Tensor


def cell_coords(cells, wi, upperleft):
    """Fine-resolution centres (1, M, 2) of token cells, as SCORE maps
    them (the float32 reciprocal of SCALE_F2I, 3.4999998)."""
    y = cells // wi
    x = cells - y * wi
    off = 0.0 if upperleft else 0.5
    inv = float(np.float32(1.0) / np.float32(SCALE_F2I))
    return torch.stack([(x + off) * inv, (y + off) * inv], -1).to(torch.float32)[None]


def coords_cells(coords, wi, upperleft):
    """The token cells (M,) of fine-resolution centres (M, 2) made by
    ``cell_coords`` (a patch row's centre, the bilinear grid's value there,
    is within rounding of its centre)."""
    off = 0.0 if upperleft else 0.5
    xy = torch.round(coords.double() * SCALE_F2I - off).long()
    return xy[:, 1] * wi + xy[:, 0]


def staged_from(post, n, M, wi, upperleft):
    """The ``Staged`` outputs a step left in the state dict ``post`` for
    its new frame row ``n``."""
    rows = slice(n * M, (n + 1) * M)
    centre = post["patches_"][rows][:, :2, 1, 1]
    return Staged(coords_cells(centre, wi, upperleft), post["seg_"][n].clone(),
                  post["score_"][rows].clone())


def features_heads(model, heads: Heads, img, noise, s: Settings, staged: Optional[Staged]):
    """CDVNet's features of one frame with the heads (img (H, W, 3) float,
    noise SCORE's uniforms): a dict of the fmap (1, 24, h, w), the context
    rows (1, M, 384), gmap (1, M, 24, 3, 3), the patch row (M, 3, 3, 3) with
    the depth head's inverse depths, the colours (1, M, 3), the cells and
    the seg and score rows used, the frame's scale anchor, and its own:
    the cells it selects (``own_cells``), the dynamic-class score map at
    the cells used (``own_score``), the seg logits and classes there
    (``seg_logits``, ``own_seg``) and each token's dynamic margin
    (``dyn_margin``: its best dynamic class's logit less its best other
    class's, over the logits' spread; positive where it is dynamic). With
    ``staged`` the cells, seg and score rows used are those; else its own."""
    M, P = s.M, model.P
    image = (img / 255.0)[None]
    fmap = model.features_f(image)
    tmap, tokens, raw, cls, _, _ = model.features_i_taps(image)
    _, _, hf, wf = fmap.shape
    hi, wi = tmap.shape[2:]
    logits = heads.seg(tokens[0])
    dyn = heads.seg.filt_mask(tokens[0], heads.filt)
    is_dyn = torch.zeros(logits.shape[1], dtype=torch.bool, device=logits.device)
    is_dyn[heads.filt] = True
    dyn_margin = ((logits[:, is_dyn].amax(1) - logits[:, ~is_dyn].amax(1))
                  / logits.std(1).clamp(min=1e-30))
    score_map = seg_binary_score(dyn, 1, hi, wi).reshape(-1)
    coords, _ = select_score(noise.reshape(1, hi * wi), score_map.reshape(1, hi, wi), M,
                             SCALE_F2I, s.upperleft)
    own_cells = coords_cells(coords[0], wi, s.upperleft)
    cells = own_cells if staged is None else staged.cells
    coords = cell_coords(cells, wi, s.upperleft)
    ictx = patchify(tmap, SCALE_F2I * coords, 0,
                    mode="upperleft" if s.upperleft else "bilinear")[..., 0, 0]
    ictx = model.adapt(ictx)
    seg_logits = heads.seg(ictx[0] * 4.0)
    own_seg = heads.seg.seg_class(ictx[0] * 4.0)
    gmap = patchify(fmap, coords, P // 2, mode="bilinear")
    clr = patchify(image.permute(0, 3, 1, 2), 4 * (coords + 0.5), 0, mode="bilinear")[..., 0, 0]
    tok = torch.cat([raw[0], cls.expand(hi * wi, -1)], -1)
    dm = heads.depth(tok)[:, 0].reshape(1, hi, wi)
    dm = (dm / (heads.depth.max_depth / 4.0)).clamp(min=1e-3)
    disps = resize((1.0 / dm)[None], (hf, wf))[0]
    grid = coords_grid_with_index(disps[None])[0]
    patch_row = patchify(grid, coords, P // 2, mode="bilinear")[0]
    own_score = score_map[cells]
    return {"fmap": fmap, "ictx": ictx, "gmap": gmap, "patch_row": patch_row, "clr": clr,
            "cells": cells, "seg": own_seg if staged is None else staged.seg,
            "score": own_score if staged is None else staged.score,
            "scale": patch_row[:, 2, P // 2, P // 2].mean(), "own_cells": own_cells,
            "own_score": own_score, "own_seg": own_seg, "seg_logits": seg_logits,
            "dyn_margin": dyn_margin, "hi": hi, "wi": wi}


def step(model, heads: Heads, st, image, ints, floats, key: StepKey, s: Settings,
         staged: Optional[Staged] = None):
    """One steady-state CDVO++ step on the state dict ``st`` (float32 copies
    of the program's buffers, written in place), as ``step.step`` for
    CDVNet, with the heads (``features_heads``; ``staged``: see there).
    Returns step.step's dict with ``feats`` (``features_heads``' dict)."""
    M = s.M
    dev = st["poses_"].device
    dP = None
    if key.shift_span:
        k = ints[len(ints) - len(SCALARS) + SCALARS.index("shift_k")].long()
        dP = shift_rows(st, k, key.shift_span, M)
    tail = ints[-len(SCALARS):].long()
    n, fs, ps = (tail[SCALARS.index(name)] for name in ("n", "fs", "ps"))
    n1 = n.reshape(1)
    intr, dfac = floats[:4].float(), floats[4].float()
    noise = floats[5 + 3 * M:].float()
    f = features_heads(model, heads, image.float(), noise, s, staged)
    arange_m = torch.arange(M, device=dev)
    _put(st["score_"], n * M + arange_m, f["score"])
    _put(st["seg_"], n1, f["seg"][None])
    _put(st["colors_dev"], n1, f["clr"])
    _put(st["intrinsics_"], n1, intr[None])
    _put(st["poses_"], n1, motion_extrapolate(st["poses_"], n, dfac)[None])
    _put(st["scale_"], n1, f["scale"][None])
    _put(st["patches_"], n * M + arange_m, f["patch_row"])
    _put(st["imap_"], ps * M + arange_m, f["ictx"][0])
    _put(st["gmap_"], ps * M + arange_m, f["gmap"][0])
    _put(st["fmap1_"], fs.reshape(1), f["fmap"].permute(0, 2, 3, 1))
    _put(st["fmap2_"], fs.reshape(1), pyramidify(f["fmap"], (4,))[0].permute(0, 2, 3, 1))
    # the update, its weights times the dynamic-class factors and the scores
    E_pad, KWIN = key.E_pad, key.KWIN
    idx, sc = edge_index(ints, E_pad, M)
    win = sc["k0"] + torch.arange(KWIN, device=dev)
    src = idx.net_src
    net = st["net"].index_select(0, src.clamp(min=0))
    net = torch.where((src >= 0)[:, None], net, torch.zeros_like(net))
    weight_mul = dynamic_class_weight(st["seg_"], heads.filt, idx.kk_local + sc["k0"])
    score_win = st["score_"].index_select(0, win)
    patches_win = st["patches_"].index_select(0, win)
    P = patches_win.shape[-1]
    poses_before = st["poses_"].clone()
    coords = transform(SE3(poses_before[None]), patches_win[None], st["intrinsics_"][None],
                       idx.ii, idx.jj, idx.kk_local)
    center = coords[0, :, P // 2, P // 2, :]
    poses, patches_new, net, target, weight, _, mm = update_body(
        model, st["poses_"], patches_win, st["intrinsics_"], st["imap_"], st["gmap_"],
        st["fmap1_"], st["fmap2_"], net, idx, sc["t0"], float(s.ht // 4), float(s.wd // 4),
        (sc["mi"], sc["mj"]), weight_mul, score_win, NW=s.pose_window, KWIN=KWIN,
        iterations=key.iterations)
    st["poses_"].copy_(poses)
    _put(st["patches_"], win, patches_new)
    st["net"][:E_pad] = net
    st["tw_buf"][:E_pad] = torch.cat([target, weight], 1)
    return {"mm": mm, "dP": dP, "center": center, "target": target, "weight": weight,
            "poses_before": poses_before, "patches_win_before": patches_win,
            "intrinsics": st["intrinsics_"][0], "ii": idx.ii, "jj": idx.jj, "kk": idx.kk_local,
            "win": win, "mask": idx.aux.mask, "n": n, "fs": fs, "ps": ps, "t0": sc["t0"],
            "feats": f}


def scale_adjustment(poses, patches, scale, t0: int, n: int, w: float, M: int, window: int):
    """Pull the window's scale toward the depth head's anchor, in place, as
    the program's steady step computes it (``cdvslam_tpu_torch/slam/
    kernels.py``): over frames [t0, n), read and written through a static
    window of ``window`` frame rows ending at n, rows before t0 masked.
    rate = 1 + w (anchor / s - 1), s the mean centre inverse depth of the
    window's patches, anchor the mean of ``scale`` over its frames; rate is
    1 when the rotation between poses n-2 and n-1 is under 0.04 rad. The
    window's inverse depths are multiplied by rate and its camera centres
    move toward frame t0-1's by (1 - 1/rate); its poses are rebuilt from
    their inverses even when the gate is shut. Returns rate."""
    P, dev = patches.shape[-1], poses.device
    t0, n = (torch.as_tensor(v, device=dev) for v in (t0, n))
    W = window
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
    return rate


def ba_scale_stage(out, tw, key: StepKey, s: Settings, st, window: int, row=None, anchor=None):
    """The step's BA (``step.ba_stage`` on the target and weight ``tw``),
    then the scale adjustment over frames [t0, n + 1) (``window`` frames at
    most) with the anchors of ``st["scale_"]`` and the patch rows of
    ``st["patches_"]`` outside the BA's window. ``row`` (M, 3, P, P) and ``anchor``: the new frame's initial
    patch row and scale anchor to start from in place of the step's own
    (another step's: the BA is then checked as a stage of its own).
    Returns (poses, patch window)."""
    n = int(out["n"])
    if row is not None:
        out = dict(out, patches_win_before=out["patches_win_before"].clone())
        new = (out["win"] >= n * s.M) & (out["win"] < (n + 1) * s.M)
        out["patches_win_before"][new] = row.to(out["patches_win_before"].dtype)
    if anchor is not None:
        st = dict(st, scale_=st["scale_"].clone())
        st["scale_"][n] = anchor
    poses, patches_win = ba_stage(out, tw, key, s)
    full = st["patches_"].clone()
    full[out["win"]] = patches_win
    poses = poses.clone()
    scale_adjustment(poses, full, st["scale_"], out["t0"], n + 1, SCALE_RATE, s.M, window)
    return poses, full[out["win"]]
