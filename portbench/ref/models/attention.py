# Frozen copy of cdvslam_tpu_torch/models/attention.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Gated linear attention with learnable-Fourier rotary encodings
(port of ``cdvslam_tpu.models.attention``). Groups are dense (G, M, D)
batches; linear attention is two small matmuls per group."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def elu_feature_map(x):
    return F.elu(x) + 1.0


def rotate_half(x):
    x = x.reshape(x.shape[:-1] + (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape[:-2] + (-1,))


def apply_rotary(freqs, t):
    """t * cos + rotate_half(t) * sin; freqs: (2, ..., D) stacked (cos, sin)."""
    return t * freqs[0] + rotate_half(t) * freqs[1]


class LearnableFourierPositionalEncoding(nn.Module):
    """x (..., M_in) -> (2, ..., 1, L, F_dim): stacked (cos, sin), each
    frequency repeated twice (interleaved)."""

    def __init__(self, m_in: int = 2, f_dim: int = 48, gamma: float = 1.0):
        super().__init__()
        self.Wr = nn.Linear(m_in, f_dim // 2, bias=False)
        nn.init.normal_(self.Wr.weight, 0.0, gamma ** -2)

    def forward(self, x):
        projected = self.Wr(x)
        emb = torch.stack([torch.cos(projected), torch.sin(projected)], 0)
        return emb[..., None, :, :].repeat_interleave(2, dim=-1)


def linear_attention(q, k, v, encoding=None, eps: float = 1e-6):
    """ELU+1 linear attention with the rotary hook after the feature map.
    q, k, v: (N, L, H, D); encoding (2, N, 1, L, D) or None."""
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    # Z uses the unrotated features
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    if encoding is not None:
        Q = apply_rotary(encoding, Q.transpose(1, 2)).transpose(1, 2)
        K = apply_rotary(encoding, K.transpose(1, 2)).transpose(1, 2)
    L = v.shape[1]
    v = v / L
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * L


class EncoderLayer(nn.Module):
    """LoFTR-style encoder layer with linear attention."""

    def __init__(self, d_model: int, nhead: int = 8):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d_model, 2 * d_model, bias=False),
                                 nn.ReLU(),
                                 nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, encoding=None, only_residual=False):
        bs, L, C = x.shape
        h = self.nhead
        q = self.q_proj(x).reshape(bs, L, h, C // h)
        k = self.k_proj(x).reshape(bs, L, h, C // h)
        v = self.v_proj(x).reshape(bs, L, h, C // h)
        msg = linear_attention(q, k, v, encoding=encoding)
        msg = self.norm1(self.merge(msg.reshape(bs, L, C)))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return msg if only_residual else x + msg


class GatedAttention(nn.Module):
    """x + sigmoid(gate(x)) * encoder(x)."""

    def __init__(self, d_model: int, nhead: int = 8):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(d_model, d_model), nn.Sigmoid())
        self.encoder = EncoderLayer(d_model, nhead)

    def forward(self, x, encoding=None):
        return x + self.gate(x) * self.encoder(x, encoding=encoding,
                                               only_residual=True)
