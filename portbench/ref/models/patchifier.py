# Frozen copy of cdvslam_tpu_torch/models/patchifier.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Patch selection, the DPVO patch gathers and coordinate grids (port of
``cdvslam_tpu.models.patchifier``: the RANDOM, GRADIENT_BIAS, RANDOM_GRID
and SCORE strategies, ``image_gradient`` and ``extract_patches``).

RANDOM and GRADIENT_BIAS take their random candidates as input (drawn by
``random_candidates``), so that a caller can feed another generator's
draws."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.patchify import patchify


def image_gradient(images):
    """Pooled gray gradient magnitude. images (B, N, H, W, 3) in DPVO's
    input range (``VONet.preprocess``) -> (B, N, (H-1)//4, (W-1)//4) in
    images' dtype.

    As the JAX package computes it under ``jax.jit``: the gray value is the
    channel sum of (x + 0.5) * 127.5 in at least float32 (``jnp.sum``),
    with the scale fused into the sum as three fused multiply-adds (XLA's
    fusion; a rounded product then a sum differs in the last bit for about
    1% of the pixels), rounded to images' dtype; the forward differences
    and their norm in images' dtype (the root correctly rounded); then the
    sum of each 4x4 cell, left to right and top to bottom, over 16."""
    a = (images + 0.5).to(torch.float64)
    acc_t = torch.promote_types(images.dtype, torch.float32)
    gray = (a[..., 0] * 127.5).to(acc_t)
    for c in (1, 2):   # fma(a_c, 127.5, gray): exact in float64, one rounding
        gray = (a[..., c] * 127.5 + gray.to(torch.float64)).to(acc_t)
    gray = gray.to(images.dtype)
    dx = gray[..., :-1, 1:] - gray[..., :-1, :-1]
    dy = gray[..., 1:, :-1] - gray[..., :-1, :-1]
    # correctly rounded: torch's vectorised float32 sqrt on the CPU is off
    # in the last bit for about 1% of the values
    g = torch.sqrt((dx ** 2 + dy ** 2).to(torch.float64)).to(images.dtype)
    B, N, H1, W1 = g.shape
    h, w_ = H1 // 4, W1 // 4
    cells = g[..., :4 * h, :4 * w_].reshape(B, N, h, 4, w_, 4)
    acc = torch.zeros((B, N, h, w_), dtype=g.dtype, device=g.device)
    for i in range(4):
        for j in range(4):
            acc = acc + cells[:, :, :, i, :, j]
    return acc / 16.0


def random_candidates(generator: torch.Generator, n, K, h, w):
    """K random integer patch centres per frame: (x, y), each (n, K) int64,
    x in [1, w - 1) and y in [1, h - 1), on the generator's device."""
    dev = generator.device
    x = torch.randint(1, w - 1, (n, K), generator=generator, device=dev)
    y = torch.randint(1, h - 1, (n, K), generator=generator, device=dev)
    return x, y


def select_random(x, y):
    """RANDOM: the candidates are the centres. x, y (n, M) -> (n, M, 2)
    float32 (x, y)."""
    return torch.stack([x, y], -1).to(torch.float32)


def select_gradient_bias(x, y, images, M):
    """GRADIENT_BIAS: of the candidates x, y (n, 3M), the M with the
    highest pooled gradient (``image_gradient`` of images (1, n, H, W, 3))
    at their cell. The last M of a stable ascending sort, as the JAX
    package's ``argsort``: candidates in one cell tie exactly. Returns
    (n, M, 2) float32 (x, y)."""
    g = image_gradient(images)[0]                                  # (n, h, w)
    n = g.shape[0]
    vals = g[torch.arange(n, device=g.device)[:, None], y, x]
    idx = torch.argsort(vals, dim=1, stable=True)[:, -M:]
    return select_random(torch.gather(x, 1, idx), torch.gather(y, 1, idx))


def extract_patches(fmap, imap, images, disps, coords, P=3):
    """The DPVO patch gathers at integer-valued centres coords (N, M, 2):
    gmap (N, M, Cf, P, P) bilinear from fmap (N, Cf, Hf, Wf), the context
    vector (N, M, Ci) at the upper-left tap of imap (N, Ci, Hf, Wf), the
    patch colours (N, M, 3) bilinear from images (N, H, W, 3) at
    4 (coords + 0.5), and the (x, y, inverse depth) patches
    (N, M, 3, P, P) from disps (N, Hf, Wf), all in the inputs' dtype."""
    ictx = patchify(imap, coords, 0, mode="upperleft")[..., 0, 0]
    gmap = patchify(fmap, coords, P // 2, mode="bilinear")
    clr = patchify(images.permute(0, 3, 1, 2), 4 * (coords + 0.5), 0, mode="bilinear")[..., 0, 0]
    grid = coords_grid_with_index(disps[None])[0]
    patches = patchify(grid, coords, P // 2, mode="bilinear")
    return gmap, ictx, clr, patches


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
    inv = float(np.float32(1.0) / np.float32(scale_f2i))   # 3.4999998
    coords = torch.stack([(x + off) * inv, (y + off) * inv], -1)
    return coords.to(torch.float32), scores


def seg_binary_score(filt_mask, n, hi, wi):
    """Selection scores from a per-token dynamic-class mask: 1 on static
    tokens, 0 on dynamic tokens and on the border rows and columns.
    filt_mask (n*hi*wi,) bool, True = dynamic -> (n, hi, wi) float32."""
    s = (~filt_mask).to(torch.float32).reshape(n, hi, wi)
    for border in (0, -1):
        s[:, border, :].fill_(0.0)
        s[:, :, border].fill_(0.0)
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
