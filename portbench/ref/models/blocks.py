# Frozen copy of cdvslam_tpu_torch/models/blocks.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Building blocks of the update operator (port of ``cdvslam_tpu.models.blocks``).

Module attribute names follow the reference's torch state dict.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.scatter import SegmentPlan


def wide(x):
    """x in at least float32: bf16 goes up to float32, float64 stays."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def MLP2(dim: int) -> nn.Sequential:
    """Linear -> ReLU -> Linear (state-dict names ``0`` and ``2``)."""
    return nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim))


class GatedResidual(nn.Module):
    """x + sigmoid(gate(x)) * res(x), with res Linear -> ReLU -> Linear
    (state-dict names ``gate.0``, ``res.0`` and ``res.2``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim), nn.Sigmoid())
        self.res = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim))

    def forward(self, x):
        return x + self.gate(x) * self.res(x)


class SoftAgg(nn.Module):
    """Softmax-weighted pooling of edge features over index groups.

    Returns the pooled feature of each edge's segment. ``ids`` are
    segment ids in ``[0, num_segments)``; edges with
    ``mask == False`` take no part. The softmax is stabilized by one global
    max over the valid rows (softmax is shift-invariant per segment); the
    segment sums run in f32 through ``SegmentPlan`` (deterministic).
    """

    def __init__(self, dim: int):
        super().__init__()
        self.f = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, dim)
        self.h = nn.Linear(dim, dim)

    def forward(self, x, ids, num_segments: int, mask=None):
        # x: (1, E, D)
        f = self.f(x)[0]
        g = self.g(x)[0]
        ids = ids.long()
        if mask is None:
            z = g - g.max()
            ids_m = ids
        else:
            gm = torch.where(mask[:, None], g, torch.full_like(g, -torch.inf)).max()
            gm = torch.where(torch.isfinite(gm), gm, torch.zeros_like(gm))
            z = torch.where(mask[:, None], g - gm, torch.full_like(g, -1e9))
            ids_m = torch.where(mask, ids, torch.full_like(ids, num_segments))
        ex = torch.exp(wide(z)).to(f.dtype)
        if mask is not None:
            ex = torch.where(mask[:, None], ex, torch.zeros_like(ex))
        plan = SegmentPlan(ids_m, num_segments)
        denom = plan.sum(wide(ex))                                     # (S, D)
        idx = ids_m.clamp(0, num_segments - 1)
        w = ex / denom[idx].clamp(min=1e-12).to(f.dtype)
        y = plan.sum(wide(f * w)).to(f.dtype)
        return self.h(y)[ids.clamp(0, num_segments - 1)][None]


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return g.clamp(-0.01, 0.01)


def gradient_clip(x):
    """Identity forward; backward zeroes NaNs and clamps to +-0.01."""
    return _GradClip.apply(x)


def LayerNorm(dim: int, eps: float = 1e-3) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps)
