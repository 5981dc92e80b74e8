"""The reference of one steady-state SLAM step, plain PyTorch.

It follows the program's steady-state frame (the deferred keyframe shift,
the frame insert and one update) as ``cdvslam_tpu_torch/slam/runtime.py``
and ``slam/fused.py`` define it at commit 8ea54d8, through the frozen
plain modules beside this file: the networks (XFeat and DINOv2, or VONet's
encoders), the patch gathers, the plain correlation, the update operator
and the BA. It starts from a copy of the program's state taken just
before the step and from the step's host inputs (the packed edge indices
and scalars, the intrinsics, the motion factor and the patch draws), and
returns the state after the step. The networks run in float32 with TF32
off, or, for the control, with every linear and convolution fed through
float8 (e4m3) and TF32 allowed.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

from ..ba import INFERENCE_PARAMS, ba_solve
from ..geom import transform
from ..lie import SE3
from ..models import VONet
from ..models.patchifier import coords_grid_with_index, extract_patches, pyramidify
from ..ops.patchify import patchify
from .kernels import SCALARS, edge_index, median, motion_extrapolate, shift_rows, update_body


class StepKey(NamedTuple):
    """The static part of a step, as the program's ``FusedKey`` gives it."""
    E_pad: int
    KWIN: int
    iterations: int
    shift_span: int


class Settings(NamedTuple):
    """What the step needs of the SLAM's set-up."""
    network: str        # "cdv" or "dpv"
    M: int              # patches per frame
    ht: int
    wd: int
    upperleft: bool     # CENTROID_SAMPLE_STRAT == "UPPERLEFT"
    pose_window: int    # POSE_WINDOW


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for float32 products and convolutions, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x):
    """x rounded through float8 e4m3 with one scale per tensor (its max at
    448, the format's largest), back in x's type."""
    amax = x.detach().abs().max().float().clamp(min=1e-12)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def to_fp8_control(model: nn.Module):
    """Round every linear and convolution weight through float8 once, and
    the input of each on every call (forward pre-hooks); returns the hooks."""
    hooks = []
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.copy_(fp8_round(mod.weight))
                hooks.append(mod.register_forward_pre_hook(
                    lambda _m, args: (fp8_round(args[0]), *args[1:])))
    return hooks


def _put(buf, rows, src):
    buf.index_copy_(0, rows, src.to(buf.dtype))


def _features_cdv(model, img, cand, s: Settings):
    """CDVNet's fmap (1, 24, h, w), context rows (1, M, 384), gmap
    (1, M, 24, 3, 3), patch row (M, 3, 3, 3) and colours (1, M, 3)."""
    M, P = s.M, model.P
    image = (img / 255.0)[None]
    fmap = model.features_f(image)
    tmap = model.features_i_taps(image)[0]
    _, _, hf, wf = fmap.shape
    coords = cand.reshape(1, M, 2)
    ictx = patchify(tmap, (4.0 / 14.0) * coords, 0,
                    mode="upperleft" if s.upperleft else "bilinear")[..., 0, 0]
    ictx = model.adapt(ictx)
    gmap = patchify(fmap, coords, P // 2, mode="bilinear")
    clr = patchify(image.permute(0, 3, 1, 2), 4 * (coords + 0.5), 0, mode="bilinear")[..., 0, 0]
    disps = torch.ones((1, hf, wf), dtype=image.dtype, device=image.device)
    grid = coords_grid_with_index(disps[None])[0]
    patch_row = patchify(grid, coords, P // 2, mode="bilinear")[0]
    return fmap, ictx, gmap, patch_row, clr


def _features_dpv(model, img, cand, s: Settings):
    """VONet's outputs, as ``_features_cdv`` (128 matching channels)."""
    image = VONet.preprocess(img)[None]
    fmap, imap = model.features(image)
    coords = cand.reshape(1, s.M, 2)
    disps = torch.ones((1, *fmap.shape[2:]), dtype=fmap.dtype, device=fmap.device)
    gmap, ictx, clr, patches = extract_patches(fmap, imap, image, disps, coords, model.P)
    return fmap, ictx, gmap, patches[0], clr


def step(model, st, image, ints, floats, key: StepKey, s: Settings):
    """One steady-state step on the state dict ``st`` (float32 copies of the
    program's buffers, written in place). ``image`` (H, W, 3) uint8, ``ints``
    the int32 block (edge rows, then ``SCALARS``), ``floats`` the float64
    block (intrinsics / 4, motion factor, centres, depth draws), all on one
    device. Returns a dict: mm, dP, and the update's centre, target and
    weight (E_pad rows), the poses and patch window before the BA."""
    M = s.M
    dev = st["poses_"].device
    dP = None
    if key.shift_span:
        k = ints[len(ints) - len(SCALARS) + SCALARS.index("shift_k")].long()
        dP = shift_rows(st, k, key.shift_span, M)
    # the frame insert
    tail = ints[-len(SCALARS):].long()
    n, fs, ps = (tail[SCALARS.index(name)] for name in ("n", "fs", "ps"))
    n1 = n.reshape(1)
    fl = floats
    intr, dfac = fl[:4].float(), fl[4].float()
    cand = fl[5:5 + 2 * M].float().view(M, 2)
    feats = _features_dpv if s.network == "dpv" else _features_cdv
    fmap, ictx, gmap, patch_row, clr = feats(model, image.float(), cand, s)
    _put(st["colors_dev"], n1, clr)
    _put(st["intrinsics_"], n1, intr[None])
    _put(st["poses_"], n1, motion_extrapolate(st["poses_"], n, dfac)[None])
    three = torch.minimum((n - 3).clamp(min=0) + torch.arange(3, device=dev),
                          (n - 1).clamp(min=0))
    rows = (three[:, None] * M + torch.arange(M, device=dev)).reshape(-1)
    patch_row = patch_row.clone()
    patch_row[:, 2] = median(st["patches_"].index_select(0, rows)[:, 2].reshape(-1))
    arange_m = torch.arange(M, device=dev)
    _put(st["patches_"], n * M + arange_m, patch_row)
    _put(st["imap_"], ps * M + arange_m, ictx[0])
    _put(st["gmap_"], ps * M + arange_m, gmap[0])
    _put(st["fmap1_"], fs.reshape(1), fmap.permute(0, 2, 3, 1))
    _put(st["fmap2_"], fs.reshape(1), pyramidify(fmap, (4,))[0].permute(0, 2, 3, 1))
    # the update
    E_pad, KWIN = key.E_pad, key.KWIN
    idx, sc = edge_index(ints, E_pad, M if s.network == "cdv" else None)
    win = sc["k0"] + torch.arange(KWIN, device=dev)
    src = idx.net_src
    net = st["net"].index_select(0, src.clamp(min=0))
    net = torch.where((src >= 0)[:, None], net, torch.zeros_like(net))
    patches_win = st["patches_"].index_select(0, win)
    P = patches_win.shape[-1]
    poses_before = st["poses_"].clone()
    coords = transform(SE3(poses_before[None]), patches_win[None], st["intrinsics_"][None],
                       idx.ii, idx.jj, idx.kk_local)
    center = coords[0, :, P // 2, P // 2, :]
    ht4, wd4 = s.ht // 4, s.wd // 4
    poses, patches_new, net, target, weight, _, mm = update_body(
        model, st["poses_"], patches_win, st["intrinsics_"], st["imap_"], st["gmap_"],
        st["fmap1_"], st["fmap2_"], net, idx, sc["t0"], float(ht4), float(wd4),
        (sc["mi"], sc["mj"]), None, None, NW=s.pose_window, KWIN=KWIN,
        iterations=key.iterations)
    st["poses_"].copy_(poses)
    _put(st["patches_"], win, patches_new)
    st["net"][:E_pad] = net
    st["tw_buf"][:E_pad] = torch.cat([target, weight], 1)
    return {"mm": mm, "dP": dP, "center": center, "target": target, "weight": weight,
            "poses_before": poses_before, "patches_win_before": patches_win,
            "intrinsics": st["intrinsics_"][0], "ii": idx.ii, "jj": idx.jj, "kk": idx.kk_local,
            "win": win, "mask": idx.aux.mask, "n": n, "fs": fs, "ps": ps, "t0": sc["t0"]}


def ba_stage(out, tw, key: StepKey, s: Settings):
    """The step's BA alone: from the poses and patch window the step had
    before its BA (``out``, the reference's) and the target and weight
    ``tw`` (E_pad, 4) of an update (the program's), as the step runs it.
    Returns (poses, patch window)."""
    return ba_solve(out["poses_before"], out["patches_win_before"], out["intrinsics"],
                    tw[:, :2], tw[:, 2:], out["ii"], out["jj"], out["kk"], out["mask"],
                    out["t0"], N=s.pose_window, K=key.KWIN, iterations=key.iterations,
                    params=INFERENCE_PARAMS)
