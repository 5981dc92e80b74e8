"""Patch selection and coordinate grids (port of the RANDOM_GRID and SCORE
paths of ``cdvslam_tpu.models.patchifier``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def select_random_grid(generator: torch.Generator, n, M, hi, wi, P, scale_f2i,
                       upperleft=True):
    """RANDOM_GRID: a random subset of the coarse (DINO-resolution) grid
    cells, mapped to fine coordinates and shared by the n frames: the last
    M entries of a random permutation of the cells (tiled when M exceeds
    them). Returns (n, M, 2) float32 (x, y) on the generator's device."""
    r = P // 2
    dev = generator.device
    yy, xx = torch.meshgrid(torch.arange(r, hi - r, device=dev),
                            torch.arange(r, wi - r, device=dev), indexing="ij")
    off = 0.0 if upperleft else 0.5
    y = ((yy + off) / scale_f2i).reshape(-1)
    x = ((xx + off) / scale_f2i).reshape(-1)
    perm = torch.randperm(y.shape[0], generator=generator, device=dev)
    inds = perm.repeat(-(-M // y.shape[0]))[-M:]
    return torch.stack([x[inds], y[inds]], -1).float()[None].expand(n, M, 2)


def select_score(uniforms, score_map, M, scale_f2i, upperleft=True):
    """SCORE: M grid cells drawn without replacement by score (Gumbel
    top-k over log(clip(score, 1e-12)) plus -log(-log(u))).

    uniforms (n, hi*wi) in [1e-12, 1); score_map (n, hi, wi). Returns
    coords (n, M, 2) float32 (x, y) at fine resolution and the chosen
    scores (n*M,), both in top-k order. A cell maps to fine coordinates by
    multiplying with the float32 reciprocal of float32(scale_f2i): the JAX
    package divides, and under ``jax.jit`` XLA multiplies by that
    reciprocal, which decides the context token the upper-left gather
    reads (floor(scale_f2i * x) falls one short for most cells).
    """
    n, hi, wi = score_map.shape
    flat = score_map.reshape(n, hi * wi)
    logits = torch.log(flat.clamp(min=1e-12))
    gumbel = -torch.log(-torch.log(uniforms.to(logits.dtype)))
    hw_inds = torch.topk(logits + gumbel, M, dim=1).indices
    scores = torch.gather(flat, 1, hw_inds).reshape(-1)
    y = hw_inds // wi
    x = hw_inds - y * wi
    off = 0.0 if upperleft else 0.5
    inv = (1.0 / torch.tensor(scale_f2i, dtype=torch.float32)).item()   # 3.4999998
    coords = torch.stack([(x + off) * inv, (y + off) * inv], -1)
    return coords.to(torch.float32), scores


def seg_binary_score(filt_mask, n, hi, wi):
    """Selection scores from a per-token dynamic-class mask: 1 on static
    tokens, 0 on dynamic tokens and on the border rows and columns.
    filt_mask (n*hi*wi,) bool, True = dynamic -> (n, hi, wi) float32."""
    s = (~filt_mask).to(torch.float32).reshape(n, hi, wi)
    s[:, [0, -1], :] = 0.0
    s[:, :, [0, -1]] = 0.0
    return s


def coords_grid_with_index(d):
    """(x, y, disp) grid. d: (B, N, H, W) -> (B, N, 3, H, W)."""
    B, N, H, W = d.shape
    y = torch.arange(H, dtype=d.dtype, device=d.device)
    x = torch.arange(W, dtype=d.dtype, device=d.device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx.expand(B, N, H, W), yy.expand(B, N, H, W), d], dim=2)


def pyramidify(fmap, lvls=(1, 4)):
    """Average-pool pyramid. fmap (N, C, H, W)."""
    return [fmap if lvl == 1 else F.avg_pool2d(fmap, lvl, stride=lvl)
            for lvl in lvls]
