"""XFeat matching-feature trunk, blocks 1-2 (port of ``cdvslam_tpu.models.xfeat``).

A 24-channel, 1/4-resolution matching feature map. Module names follow the
public XFeat state dict (``block1.0.layer.0.weight``, ``skip1.1.weight``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d without affine parameters, NCHW."""
    return F.instance_norm(x, eps=eps)


class BasicLayer(nn.Module):
    """Conv3x3 (no bias) + BatchNorm (running stats, affine=False) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.layer = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False),
            nn.BatchNorm2d(out_ch, affine=False),
            nn.ReLU())

    def forward(self, x):
        conv, bn, _ = self.layer
        if bn.running_mean.requires_grad:
            # the JAX trainer keeps the running statistics among its flax
            # params, differentiates and trains them: flax's formula, which
            # (unlike the batch_norm op) carries their gradient
            y = conv(x)
            y = (y - bn.running_mean[:, None, None]) * torch.rsqrt(
                bn.running_var[:, None, None] + bn.eps)
            return torch.relu(y)
        return self.layer(x)


class XFeat(nn.Module):
    """norm -> block1 (1/4 res, 24ch) -> skip1 -> block2. NCHW."""

    def __init__(self):
        super().__init__()
        self.block1 = nn.Sequential(
            BasicLayer(1, 4, 1), BasicLayer(4, 8, 2), BasicLayer(8, 8, 1),
            BasicLayer(8, 24, 2))
        self.skip1 = nn.Sequential(nn.AvgPool2d(4, stride=4),
                                   nn.Conv2d(1, 24, 1, stride=1))
        self.block2 = nn.Sequential(BasicLayer(24, 24, 1), BasicLayer(24, 24, 1))

    def forward(self, gray):
        """gray: (B, 1, H, W)."""
        x = instance_norm(gray)
        return self.block2(self.block1(x) + self.skip1(x))


def xfeat_f(trunk: XFeat, images):
    """The reference's get_f: images (B, H, W, 3) in [0, 1] -> grayscale ->
    trunk -> instance norm; returns (B, 24, H/4, W/4)."""
    img = images * 2.0 - 0.5
    gray = img.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2)
    return instance_norm(trunk(gray))
