# Frozen copy of cdvslam_tpu_torch/models/encoder.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""RAFT-style residual CNN encoder of the DPVO network (port of
``cdvslam_tpu.models.encoder``: ``ResidualBlock`` and ``BasicEncoder4``).

NCHW throughout. Module names follow the reference's torch state dict
(``conv1``, ``layer1.0``, ``layer2.0.downsample.0``, ``conv2``).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .blocks import wide

DIM = 32


def instance_norm(x):
    """The JAX package's "instance" norm: flax ``GroupNorm`` with one group
    per channel and no scale or bias, epsilon 1e-6 (the reference's
    ``InstanceNorm2d`` takes 1e-5), statistics in at least float32, the
    result in x's dtype."""
    return F.instance_norm(wide(x), eps=1e-6).to(x.dtype)


def no_norm(x):
    return x


def _norm(norm_fn: str):
    if norm_fn not in ("instance", "none"):
        raise ValueError(f"norm_fn {norm_fn!r}: the port builds 'instance' and 'none'")
    return instance_norm if norm_fn == "instance" else no_norm


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions with a norm and ReLU after each, plus a 1x1
    ``downsample`` of the input where the stride or the width changes."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm = _norm(norm_fn)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder4(nn.Module):
    """Stride-4 encoder: 7x7 / 2 convolution, two residual layers (the
    second at stride 2), 1x1 output convolution. (N, 3, H, W) ->
    (N, output_dim, H/4, W/4). ``norm_fn``: "instance" or "none"."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        self.norm = _norm(norm_fn)
        self.conv1 = nn.Conv2d(3, DIM, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(DIM, DIM, norm_fn, 1),
                                    ResidualBlock(DIM, DIM, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(DIM, 2 * DIM, norm_fn, 2),
                                    ResidualBlock(2 * DIM, 2 * DIM, norm_fn, 1))
        self.conv2 = nn.Conv2d(2 * DIM, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm(self.conv1(x)))
        return self.conv2(self.layer2(self.layer1(x)))
