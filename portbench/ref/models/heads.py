# Frozen copy of cdvslam_tpu_torch/models/heads.py and of models/dpt.py's resize at
# commit 8f691db, part of the benchmark's plain reference: it stays as it is when the
# program changes.
"""Semantic and depth heads on DINOv2 tokens (port of
``cdvslam_tpu.models.heads``). Module names follow the reference's torch
state dicts (``bn.*``, ``linear.*``), so a reference checkpoint loads with
``load_state_dict``. ``resize`` is the depth map's antialiased bilinear
resize to the matching features' grid."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class SegHeadFlatten(nn.Module):
    """BatchNorm1d (eval statistics) + Linear token classifier, 150 ADE20K
    classes."""

    def __init__(self, num_classes: int = 150, in_channels: int = 384):
        super().__init__()
        self.bn = nn.BatchNorm1d(in_channels)
        self.linear = nn.Linear(in_channels, num_classes)
        self.eval()

    def forward(self, x):
        """x (L, C) -> class logits (L, num_classes)."""
        return self.linear(self.bn(x))

    def seg_class(self, x):
        """The argmax class of each token, uint8."""
        return self(x).argmax(-1).to(torch.uint8)

    def filt_mask(self, x, filt_index):
        """True where the token's argmax class is in ``filt_index`` (a 1-D
        tensor of dynamic class ids on x's device)."""
        return (self(x).argmax(-1)[:, None] == filt_index).any(-1)


class DepthHeadFlatten(nn.Module):
    """AdaBins-style 256-bin linear depth head on [patch; cls] tokens:
    relu(logits) + 0.1, normalized, dotted with the bin centres."""

    def __init__(self, in_channels: int = 768, n_bins: int = 256,
                 min_depth: float = 0.001, max_depth: float = 80.0):
        super().__init__()
        self.linear = nn.Linear(in_channels, n_bins)
        self.min_depth, self.max_depth, self.n_bins = min_depth, max_depth, n_bins

    def forward(self, x):
        """x (L, 768) -> metric depth (L, 1)."""
        logit = torch.relu(self.linear(x)) + 0.1
        logit = logit / logit.sum(-1, keepdim=True)
        bins = torch.linspace(self.min_depth, self.max_depth, self.n_bins,
                              dtype=x.dtype, device=x.device)
        return logit @ bins[:, None]


def resize(x, size):
    """Bilinear resize of NCHW x to ``size``: ``jax.image.resize``'s bilinear
    (half-pixel centres, antialiased when it shrinks)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
