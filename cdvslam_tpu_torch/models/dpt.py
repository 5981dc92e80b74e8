"""DPT depth head on four DINOv2 taps (port of ``cdvslam_tpu.models.dpt``).

The reference's mmseg DPT head (DINO_modules/hub/dpt/depth_head_mm.py):
ReassembleBlocks with the 'project' readout (cls token concatenated,
Linear + GELU), per-stage resize (4x and 2x transposed convolutions,
identity, a stride-2 convolution), FeatureFusion blocks with
pre-activation residual units, and the depth regression tail. NCHW.
Module names are the reference state dict's with ``decode_head.``
stripped, so a reference checkpoint loads with ``load_state_dict``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def resize(x, size, align_corners=False):
    """Bilinear resize of NCHW x to ``size``. ``align_corners=False`` is
    ``jax.image.resize``'s bilinear (half-pixel centres, antialiased when it
    shrinks); True is corner-aligned sampling."""
    if align_corners:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


class ConvModule(nn.Module):
    """mmcv's ConvModule without norm: the convolution is ``.conv``."""

    def __init__(self, cin, cout, k, padding=0, bias=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=padding, bias=bias)

    def forward(self, x):
        return self.conv(x)


class PreActResidualConvUnit(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvModule(channels, channels, 3, padding=1, bias=False)
        self.conv2 = ConvModule(channels, channels, 3, padding=1, bias=False)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, channels: int, first: bool = False):
        super().__init__()
        self.res_conv_unit1 = None if first else PreActResidualConvUnit(channels)
        self.res_conv_unit2 = PreActResidualConvUnit(channels)
        self.project = ConvModule(channels, channels, 1)

    def forward(self, x, res=None):
        if res is not None:
            if res.shape[2:] != x.shape[2:]:
                res = resize(res, x.shape[2:])
            x = x + self.res_conv_unit1(res)
        x = self.res_conv_unit2(x)
        x = resize(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)
        return self.project(x)


class ReassembleBlocks(nn.Module):
    def __init__(self, embed_dims: int = 384, out_channels: Sequence[int] = (48, 96, 192, 384)):
        super().__init__()
        self.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * embed_dims, embed_dims), nn.GELU())
            for _ in out_channels)
        self.projects = nn.ModuleList(ConvModule(embed_dims, c, 1) for c in out_channels)
        c = out_channels
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4),
            nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(c[3], c[3], 3, stride=2, padding=1)])

    def forward(self, inputs):
        """inputs: four (token map (B, h, w, C), cls (B, C)) pairs ->
        four NCHW maps at 4x, 2x, 1x and 1/2x the token grid."""
        outs = []
        for i, (x, cls) in enumerate(inputs):
            x = torch.cat([x, cls[:, None, None, :].expand_as(x)], -1)
            x = self.readout_projects[i](x).permute(0, 3, 1, 2)
            outs.append(self.resize_layers[i](self.projects[i](x)))
        return outs


class DPTHead(nn.Module):
    """Depth from four DINOv2 taps (tap order 2, 5, 8, 11): a list of
    (token map (B, h, w, 384), cls (B, 384)) pairs -> (B, 1, 16h', 16w')
    metric depth, with h' = h rounded up to even (the stride-2 stage)."""

    def __init__(self, embed_dims: int = 384, post_process_channels=(48, 96, 192, 384),
                 channels: int = 256, min_depth: float = 0.001, max_depth: float = 80.0):
        super().__init__()
        self.min_depth, self.max_depth = min_depth, max_depth
        self.reassemble_blocks = ReassembleBlocks(embed_dims, post_process_channels)
        self.convs = nn.ModuleList(ConvModule(c, channels, 3, padding=1, bias=False)
                                   for c in post_process_channels)
        self.fusion_blocks = nn.ModuleList(FeatureFusionBlock(channels, first=i == 0)
                                           for i in range(len(post_process_channels)))
        self.project = ConvModule(channels, channels, 3, padding=1)
        self.conv_depth = HeadDepth(channels)

    def forward(self, inputs):
        x = [conv(f) for conv, f in zip(self.convs, self.reassemble_blocks(inputs))]
        out = self.fusion_blocks[0](x[-1])
        for i in range(1, len(x)):
            out = self.fusion_blocks[i](out, x[-(i + 1)])
        out = self.conv_depth(torch.relu(self.project(out)))
        return torch.relu(out) + self.min_depth


class HeadDepth(nn.Module):
    """conv 3x3, 2x corner-aligned upsample, conv 3x3, ReLU, conv 1x1
    (state-dict names ``head.0``, ``head.2``, ``head.4``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.head = nn.Sequential(
            nn.Conv2d(channels, channels // 2, 3, padding=1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(channels // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1))

    def forward(self, x):
        return self.head(x)
