"""DINOv2 ViT-S/14 backbone (port of ``cdvslam_tpu.models.dinov2``).

Patch 14, dim 384, 12 blocks, 6 heads, MLP ratio 4, LayerScale, LayerNorm
eps 1e-6, cls token, and the bicubic pos-embed resize with the +0.1
trick, applied through host-built sampling matrices (bit-matching
``F.interpolate(mode="bicubic")`` with an explicit scale factor). The
attention of every block goes through the flash-attention kernels: the
forward kernel alone when no gradient is taken, and the autograd Function
(forward with the softmax statistics saved, two backward kernels) when
one is.
Module names follow the reference's state dict (``blocks.0.attn.qkv``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attn import flash_attention_qkv, flash_attention_qkv_grad
from .blocks import wide


def _torch_bicubic_matrix(n_in: int, n_out: int, scale: float, A=-0.75):
    """Row matrix reproducing F.interpolate(mode="bicubic",
    align_corners=False) with an explicit scale_factor: source coordinate
    src = (dst + 0.5) / scale - 0.5, cubic kernel with A = -0.75,
    replicate-clamped borders. Copy of the JAX package's helper."""
    W = np.zeros((n_out, n_in), np.float64)

    def cub(x):
        x = abs(x)
        if x <= 1:
            return ((A + 2) * x - (A + 3)) * x * x + 1
        if x < 2:
            return A * (((x - 5) * x + 8) * x - 4)
        return 0.0

    for o in range(n_out):
        s = (o + 0.5) / scale - 0.5
        i0 = int(np.floor(s))
        for idx in range(i0 - 1, i0 + 3):
            W[o, min(max(idx, 0), n_in - 1)] += cub(s - idx)
    return W.astype(np.float32)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        # the kernels read q, k, v from the packed projection and write (B, L, C)
        qkv = self.qkv(x)
        if torch.is_grad_enabled() and qkv.requires_grad:
            return self.proj(flash_attention_qkv_grad(qkv, self.num_heads))
        return self.proj(flash_attention_qkv(qkv, self.num_heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)              # (B, hw, C)


class DinoVisionTransformer(nn.Module):
    """ViT with resizable pos-embeds and intermediate-layer taps."""

    def __init__(self, patch_size=14, embed_dim=384, depth=12, num_heads=6,
                 mlp_ratio=4.0, pos_grid=37):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_grid = pos_grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interp_pos(self, h0: int, w0: int, dtype):
        N = self.pos_grid
        if h0 == N and w0 == N:
            return self.pos_embed.to(dtype)
        pe = wide(self.pos_embed)
        patch_pe = pe[:, 1:].reshape(1, N, N, self.embed_dim)
        dev = pe.device
        Wh = torch.from_numpy(_torch_bicubic_matrix(N, h0, (h0 + 0.1) / N)).to(dev, pe.dtype)
        Ww = torch.from_numpy(_torch_bicubic_matrix(N, w0, (w0 + 0.1) / N)).to(dev, pe.dtype)
        patch_pe = torch.einsum("hH,bHWd,wW->bhwd", Wh, patch_pe, Ww)
        patch_pe = patch_pe.reshape(1, h0 * w0, self.embed_dim)
        return torch.cat([pe[:, :1], patch_pe], dim=1).to(dtype)

    def prepare_tokens(self, x):
        """x: (B, 3, H, W) NCHW, H and W multiples of the patch size."""
        B, _, H, W = x.shape
        h0, w0 = H // self.patch_size, W // self.patch_size
        t = self.patch_embed(x)
        t = torch.cat([self.cls_token.to(t.dtype).expand(B, 1, -1), t], dim=1)
        return t + self.interp_pos(h0, w0, t.dtype)

    def forward(self, x, taps: Sequence[int] = (2, 5, 8, 11)):
        """Pre-norm token tensors (B, 1 + h*w, C) at the tapped blocks."""
        t = self.prepare_tokens(x)
        outs = []
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in taps:
                outs.append(t)
        return outs


def pad_to_multiple(img, multiple: int = 14):
    """Zero-pad H and W of an NHWC image up to a multiple, on the right."""
    H, W = img.shape[-3], img.shape[-2]
    ph, pw = (-H) % multiple, (-W) % multiple
    if ph == 0 and pw == 0:
        return img
    return F.pad(img, (0, 0, 0, pw, 0, ph))
