"""Training rollout (port of ``cdvslam_tpu.train.rollout``).

The full edge lattice over the clip's F frames -- edge (i, j, m) for every
frame pair and patch slot, ordered e = (i F + j) M + m -- is laid out once,
and each rollout step activates a subset by masks: an edge is active when
both frames are visible at step s (one frame is revealed per step after
MIN_FRAME) and no dropout has removed it (with probability 0.1 per reveal
step, the edges touching frame n - 4, permanently). The (i, j) groups of
the CDV update are then the identity reshape and the temporal neighbours a
+-M index shift.

Each step: reproject, correlate at two levels (the plain ``ops.corr``, as
the JAX rollout uses its XLA corr), run the update operator, two
Gauss-Newton iterations of the training BA, and the supervision: the
flow loss over edges with 0 < |i - j| <= 2 and, from step 2, the scaled
relative-pose loss. Poses and patches are detached at the start of each
step. ``torch.utils.checkpoint`` (non-reentrant) recomputes the feature
extractors and each step in the backward pass, as ``jax.checkpoint`` does.

Randomness: the patch centres, the initial depths d0 and the dropout
rolls are drawn by ``draw`` from a ``torch.Generator``, or passed in as
``draws`` (a test feeds the JAX package's own draws).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ba import TRAINING_PARAMS, ba_solve
from ..geom import transform
from ..lie import SE3, se3_identity, se3_inv, se3_log, se3_mul, se3_scale
from ..models.patchifier import (
    coords_grid_with_index, extract_patches, random_candidates, select_random,
    select_random_grid,
)
from ..models.update import UpdateAux
from ..ops.corr import corr
from ..ops.patchify import patchify


def _safe_norm(x, dim=-1, eps=1e-12):
    """Norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


class RolloutConfig(NamedTuple):
    F: int              # frames in the clip
    M: int              # patches per image
    P: int = 3
    STEPS: int = 12
    MIN_FRAME: int = 8
    structure_only: bool = False
    is_cdv: bool = True
    flow_weight: float = 0.1
    pose_weight: float = 10.0
    # recompute the extractors and each step in the backward pass
    remat: bool = True
    # network compute type: 'bfloat16' runs the extractors, corr and the
    # update operator in bf16 on bf16 copies of the float32 parameters
    # (the gradient lands on the float32 leaves); geometry, BA and the loss
    # stay in the ground truth's type (float32, or float64 for a
    # high-precision run on the CPU with a float64 model)
    compute_dtype: str = "float32"


class Draws(NamedTuple):
    """The rollout's random numbers: patch centres (F, M, 2) float32 at the
    feature resolution, initial inverse depths d0 (F M,) and the dropout
    rolls (STEPS,) in [0, 1)."""
    coords: torch.Tensor
    d0: torch.Tensor
    drop_roll: np.ndarray


def n_visible(cfg: RolloutConfig, s: int) -> int:
    if s < cfg.MIN_FRAME:
        return cfg.MIN_FRAME
    return min(cfg.MIN_FRAME + (s - cfg.MIN_FRAME + 1), cfg.F)


def build_static_edges(cfg: RolloutConfig):
    """The full lattice, host numpy: (ii, jj, kk, ix, jx, perm, inv_perm)."""
    F_, M = cfg.F, cfg.M
    i = np.repeat(np.arange(F_), F_ * M)
    j = np.tile(np.repeat(np.arange(F_), M), F_)
    m = np.tile(np.arange(M), F_ * F_)
    kk = i * M + m
    E = F_ * F_ * M
    e = np.arange(E)
    ix = np.where(j >= 1, e - M, -1)
    jx = np.where(j + 1 < F_, e + M, -1)
    perm = e.reshape(F_ * F_, M)
    inv_perm = e
    return i, j, kk, ix, jx, perm, inv_perm


def draw(cfg: RolloutConfig, H: int, W: int, generator: torch.Generator) -> Draws:
    """Seeded draws for one clip of H x W images, on the generator's device:
    RANDOM_GRID centres shared by the frames (CDV) or RANDOM integer centres
    (DPVO), uniform initial depths, uniform dropout rolls."""
    F_, M = cfg.F, cfg.M
    if cfg.is_cdv:   # the DINO token grid
        coords = select_random_grid(generator, F_, M, -(-H // 14), -(-W // 14), cfg.P,
                                    4.0 / 14.0, True)
    else:            # the 1/4-resolution feature map
        coords = select_random(*random_candidates(generator, F_, M, H // 4, W // 4))
    d0 = torch.rand((F_ * M,), generator=generator, device=generator.device)
    roll = torch.rand((cfg.STEPS,), generator=generator, device=generator.device)
    return Draws(coords.contiguous(), d0, roll.cpu().numpy())


def _call(model, cparams, method, *args, **kwargs):
    """model.<method>(...) on its own weights, or on ``cparams`` (the bf16 copies)."""
    if cparams is None:
        return getattr(model, method)(*args, **kwargs)
    return torch.func.functional_call(model, cparams, (method,) + args, kwargs)


def _compute_params(model, cdt):
    """None unless bf16; else bf16 copies of every float32 parameter and
    buffer (differentiable casts: the gradient reaches the float32 leaves)."""
    if cdt != torch.bfloat16:
        return None
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    return {k: v.to(cdt) if v.dtype == torch.float32 else v for k, v in tensors.items()}


def rollout_loss(model, cfg: RolloutConfig, images, gt_poses, gt_disps, intrinsics,
                 generator: torch.Generator | None = None, draws: Draws | None = None):
    """One clip's training rollout -> (scalar loss, metrics dict).

    images (F, H, W, 3) float in [0, 255]; gt_poses (F, 7) world to camera;
    gt_disps (F, H/4, W/4) normalized inverse depth; intrinsics (4,) at full
    resolution; all on one device, in one float type (the geometry's).
    ``draws`` (see ``Draws``) or a ``generator`` to draw them from.
    """
    F_, M, P = cfg.F, cfg.M, cfg.P
    E = F_ * F_ * M
    dev, gdt = images.device, gt_poses.dtype
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else gdt
    cparams = _compute_params(model, cdt)
    if draws is None:
        draws = draw(cfg, images.shape[1], images.shape[2], generator)

    images = images / 255.0 if cfg.is_cdv else 2.0 * (images / 255.0) - 0.5
    images = images.to(cdt)
    intr4 = intrinsics / 4.0
    intr_full = intr4.expand(F_, 4)

    def ck(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if cfg.remat else fn(*args)

    coords = draws.coords.to(dev)
    if cfg.is_cdv:
        fmap = ck(lambda im: _call(model, cparams, "features_f", im), images)
        tmap = ck(lambda im: _call(model, cparams, "features_i", im)[0], images)
        ictx = patchify(tmap, (4.0 / 14.0) * coords, 0, mode="upperleft")[..., 0, 0]
        ictx = _call(model, cparams, "adapt", ictx)
        gmap = patchify(fmap, coords, P // 2, mode="bilinear")
        grid = coords_grid_with_index(gt_disps[None])[0]
        patches_gt = patchify(grid, coords, P // 2, mode="bilinear")
    else:
        fmap, imap = ck(lambda im: _call(model, cparams, "features", im), images)
        gmap, ictx, _, patches_gt = extract_patches(fmap, imap, images, gt_disps.to(fmap.dtype),
                                                    coords, P)
    hf, wf = fmap.shape[2], fmap.shape[3]
    fmap2 = F.avg_pool2d(fmap.to(torch.promote_types(fmap.dtype, torch.float32)), 4, 4)
    fmap2 = fmap2.to(fmap.dtype)

    patches_gt = patches_gt.reshape(F_ * M, 3, P, P).to(gdt)
    gmap = gmap.reshape(F_ * M, -1, P, P)
    ictx = ictx.reshape(F_ * M, model.DIM)
    patches = patches_gt.clone()
    patches[:, 2] = draws.d0.to(dev, gdt)[:, None, None]

    ii_np, jj_np, kk_np, ix_np, jx_np, perm_np, inv_np = build_static_edges(cfg)
    ii, jj, kk, ix, jx, perm, inv_perm = (torch.as_tensor(a, device=dev) for a in (
        ii_np, jj_np, kk_np, ix_np, jx_np, perm_np, inv_np))

    posenc_edges = None
    if cfg.is_cdv:
        p_shift = torch.tensor([wf / 2, hf / 2], dtype=gdt, device=dev)
        p_n = (patches[None, :, :2, P // 2, P // 2] - p_shift) / max(wf / 2, hf / 2)
        posenc_edges = _call(model, cparams, "posenc", p_n.to(cdt))[:, :, :, kk]

    Gs = gt_poses.clone() if cfg.structure_only else se3_identity((F_,), gdt, dev)
    net = torch.zeros((E, model.DIM), dtype=cdt, device=dev)
    bounds = torch.tensor([-64.0, -64.0, wf + 64.0, hf + 64.0], dtype=gdt, device=dev)
    drop_mask = torch.ones(E, dtype=torch.bool, device=dev)
    dij = (ii - jj).abs()
    fi, fj = torch.meshgrid(torch.arange(F_, device=dev), torch.arange(F_, device=dev),
                            indexing="ij")
    fi, fj = fi.reshape(-1), fj.reshape(-1)

    def make_step(s):
        nv = n_visible(cfg, s)
        nv_prev = n_visible(cfg, s - 1) if s > 0 else cfg.MIN_FRAME
        drop = nv > nv_prev and draws.drop_roll[s] < 0.1

        def step(Gs, patches, net, drop_mask):
            Gs, patches = Gs.detach(), patches.detach()
            if nv > nv_prev:
                # new frame: the previous pose, and the median depth of the
                # previous two frames' patch centres (the mean of the two
                # middle values, as jnp.median takes it)
                if not cfg.structure_only:
                    Gs = Gs.clone()
                    Gs[nv - 1] = Gs[nv - 2]
                vals = patches[(nv - 3) * M:(nv - 1) * M, 2, P // 2, P // 2].sort().values
                med = 0.5 * vals[M - 1] + 0.5 * vals[M]
                patches = patches.clone()
                patches[(nv - 1) * M:nv * M, 2] = med
                if drop:
                    drop_mask = drop_mask & ~((ii == nv - 4) | (jj == nv - 4))
            active = (ii < nv) & (jj < nv) & drop_mask
            act_ix = active[ix.clamp(min=0)] & (ix >= 0)
            act_jx = active[jx.clamp(min=0)] & (jx >= 0)
            aux = UpdateAux(
                ix=torch.where(act_ix, ix, -1), jx=torch.where(act_jx, jx, -1),
                kseg=torch.where(active, kk, F_ * M), gseg=torch.where(active, ii * F_ + jj, F_ * F_),
                perm=perm, inv_perm=inv_perm, mask=active)

            coords = transform(SE3(Gs[None]), patches[None], intr_full[None], ii, jj, kk)
            coords_nchw = coords.permute(0, 1, 4, 2, 3)
            c1 = corr(gmap[None], fmap[None], coords_nchw, kk, jj, radius=3)
            c2 = corr(gmap[None], fmap2[None], coords_nchw / 4.0, kk, jj, radius=3)
            corrf = torch.stack([c1, c2], -1).reshape(1, E, -1)
            inp = ictx[kk][None]
            if cfg.is_cdv:
                net_b, d, w = _call(model, cparams, "update", net[None], inp, corrf, aux, F_ * M,
                                    posenc=posenc_edges)
            else:
                net_b, d, w = _call(model, cparams, "update", net[None], inp, corrf, aux, F_ * M,
                                    F_ * F_)
            net = net_b[0]

            target = coords[0, :, P // 2, P // 2, :] + d[0].to(gdt)
            wgt = w[0].to(gdt) * active[:, None]
            Gs, patches = ba_solve(Gs, patches, intr4, target, wgt, ii, jj, kk, active, 1,
                                   N=F_, K=F_ * M, iterations=2, params=TRAINING_PARAMS,
                                   structure_only=cfg.structure_only, bounds=bounds)

            # supervision
            sup = active & (dij > 0) & (dij <= 2)
            coords_est = transform(SE3(Gs[None]), patches[None], intr_full[None], ii, jj, kk)
            coords_gt, valid, _ = transform(SE3(gt_poses[None]), patches_gt[None],
                                            intr_full[None], ii, jj, kk, jacobian=True)
            err = _safe_norm(coords_est - coords_gt, dim=-1)[0]
            # amin shares the gradient among ties, as jnp.min does
            err_min = torch.amin(err.reshape(E, P * P), dim=-1)
            vmask = sup & (valid[0] > 0.5)
            n_sup = vmask.sum().clamp(min=1)
            zero = torch.zeros((), dtype=gdt, device=dev)
            flow_loss = torch.where(vmask, err_min, zero).sum() / n_sup
            loss_s = cfg.flow_weight * flow_loss
            px1 = (vmask & (err_min < 0.25)).sum() / n_sup

            tr_m = ro_m = zero
            if not cfg.structure_only and s >= 2:
                # scaled relative pose loss over the visible frames
                P1, P2 = se3_inv(Gs), se3_inv(gt_poses)
                fr_mask = torch.arange(F_, device=dev) < nv
                t1, t2 = P1[:, :3], P2[:, :3]
                num = torch.where(fr_mask, (t2 * t1).sum(-1), zero).sum()
                den = torch.where(fr_mask, (t1 * t1).sum(-1), zero).sum()
                s_scale = (num / den.clamp(min=1e-8)).clamp(max=10.0).detach()
                P1s = se3_scale(P1, s_scale.expand(F_))
                pair_mask = (fi != fj) & (fi < nv) & (fj < nv)
                dP = se3_mul(se3_inv(P1s[fi]), P1s[fj])
                dG = se3_mul(se3_inv(P2[fi]), P2[fj])
                e1 = se3_log(se3_mul(dP, se3_inv(dG)))
                tr = _safe_norm(e1[:, :3], dim=-1)
                ro = _safe_norm(e1[:, 3:6], dim=-1)
                cnt = pair_mask.sum().clamp(min=1)
                tr_m = torch.where(pair_mask, tr, zero).sum() / cnt
                ro_m = torch.where(pair_mask, ro, zero).sum() / cnt
                loss_s = loss_s + cfg.pose_weight * (tr_m + ro_m)
            return Gs, patches, net, drop_mask, loss_s, px1, tr_m, ro_m

        return step

    total = torch.zeros((), dtype=gdt, device=dev)
    metrics = {}
    for s in range(cfg.STEPS):
        Gs, patches, net, drop_mask, loss_s, px1, tr_m, ro_m = ck(
            make_step(s), Gs, patches, net, drop_mask)
        total = total + loss_s
        metrics["px1"] = px1
        if not cfg.structure_only and s >= 2:
            metrics["tr"], metrics["ro"] = tr_m, ro_m
    metrics.setdefault("tr", torch.zeros((), dtype=gdt, device=dev))
    metrics.setdefault("ro", torch.zeros((), dtype=gdt, device=dev))
    return total, metrics
