# Frozen copy of cdvslam_tpu_torch/ops/patchify.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Patch gather ("patchify"), port of ``cdvslam_tpu.ops.patchify``.

Gathers C x D x D patches at float coordinates from a feature map, with
zero padding out of bounds, then either a 4-tap bilinear blend
(``mode='bilinear'``), the integer upper-left sample (``'upperleft'``), or
the raw window (``'raw'``). Forward only.
"""
from __future__ import annotations

import torch


def patchify(net: torch.Tensor, coords: torch.Tensor, radius: int,
             mode: str = "bilinear") -> torch.Tensor:
    """net (N, C, H, W), coords (N, M, 2) float (x, y) patch centers.

    Returns (N, M, C, 2R+1, 2R+1) for 'bilinear', (N, M, C, 1, 1) for
    'upperleft' and (N, M, C, D, D) with D = 2R+2 for 'raw'. Row index
    i = floor(y) + (di - R), column j = floor(x) + (dj - R).
    """
    N, C, H, W = net.shape
    M = coords.shape[1]
    D = 2 * radius + 2
    x, y = coords[..., 0], coords[..., 1]
    ix0 = torch.floor(x).long()
    iy0 = torch.floor(y).long()
    di = torch.arange(D, device=net.device) - radius
    iy = (iy0[..., None, None] + di[:, None]).expand(N, M, D, D)
    ix = (ix0[..., None, None] + di[None, :]).expand(N, M, D, D)
    inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat_idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)        # (N,M,D,D)
    flat = net.reshape(N, C, H * W)
    g = torch.gather(flat, 2, flat_idx.reshape(N, 1, M * D * D).expand(N, C, -1))
    patches = g.reshape(N, C, M, D, D).permute(0, 2, 1, 3, 4)
    patches = torch.where(inb[:, :, None], patches, torch.zeros((), dtype=net.dtype,
                                                                device=net.device))
    if mode == "raw":
        return patches
    if mode == "upperleft":
        return patches[..., radius:radius + 1, radius:radius + 1]
    if mode != "bilinear":
        raise ValueError(f"unknown patchify mode {mode!r}")
    d = 2 * radius + 1
    dx = (x - torch.floor(x))[..., None, None, None].to(net.dtype)
    dy = (y - torch.floor(y))[..., None, None, None].to(net.dtype)
    x00 = (1 - dy) * (1 - dx) * patches[..., :d, :d]
    x01 = (1 - dy) * dx * patches[..., :d, 1:]
    x10 = dy * (1 - dx) * patches[..., 1:, :d]
    x11 = dy * dx * patches[..., 1:, 1:]
    return x00 + x01 + x10 + x11
