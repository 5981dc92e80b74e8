# Frozen copy of cdvslam_tpu_torch/geom/projective.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Projective geometry for patch SLAM (port of ``cdvslam_tpu.geom``).

Conventions, as in the JAX package:
  patches     (B, K, 3, P, P)   channels = (x, y, d) at 1/RES resolution
  intrinsics  (B, N, 4)         (fx, fy, cx, cy)
  poses       SE3 with data (B, N, 7)
  ii, jj, kk  (E,) integer tensors: source frame, target frame, patch index

Clamps: ``proj`` clamps Z >= 0.1; Jacobians and validity use Z > 0.2.
Indices are clamped into range, as JAX's ``mode="clip"`` gathers are.
"""
from __future__ import annotations

import torch

from ..lie import SE3, se3_adjT, se3_inv, se3_mul


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    idx = idx.to(device=x.device, dtype=torch.long).clamp(0, x.shape[dim] - 1)
    return x.index_select(dim, idx)


def iproj(patches: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Inverse projection: (B,E,3,P,P) patches -> (B,E,P,P,4) homogeneous."""
    x, y, d = patches[:, :, 0], patches[:, :, 1], patches[:, :, 2]
    fx, fy, cx, cy = [intrinsics[..., i, None, None] for i in range(4)]
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                       dim=-1)


def proj(X: torch.Tensor, intrinsics: torch.Tensor, depth: bool = False):
    """Pinhole projection with the Z >= 0.1 clamp."""
    fx, fy, cx, cy = [intrinsics[..., i, None, None] for i in range(4)]
    d = 1.0 / X[..., 2].clamp(min=0.1)
    x = fx * (d * X[..., 0]) + cx
    y = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([x, y, d], dim=-1)
    return torch.stack([x, y], dim=-1)


def _rel_pose(poses: SE3, ii, jj, tonly=False) -> SE3:
    """G_ij = G_j * G_i^-1, gathered per edge."""
    gi = _take(poses.data, ii, 1)
    gj = _take(poses.data, jj, 1)
    gij = se3_mul(gj, se3_inv(gi))
    if tonly:
        # the identity rotation, made on the device (no host constant)
        gij = torch.cat([gij[..., :3], torch.zeros_like(gij[..., :3]),
                         torch.ones_like(gij[..., :1])], dim=-1)
    return SE3(gij)


def transform(poses: SE3, patches, intrinsics, ii, jj, kk,
              depth=False, valid=False, jacobian=False, tonly=False):
    """Projective transform of patches kk from frame ii into frame jj.

    With ``jacobian=True`` also returns the center-pixel validity mask and
    the analytic Jacobians (Ji, Jj, Jz): 2x6 pose Jacobians, 2x1 depth.
    """
    X0 = iproj(_take(patches, kk, 1), _take(intrinsics, ii, 1))
    Gij = _rel_pose(poses, ii, jj, tonly=tonly)
    X1 = SE3(Gij.data[:, :, None, None]).act(X0)          # (B,E,P,P,4)
    intr_j = _take(intrinsics, jj, 1)
    x1 = proj(X1, intr_j, depth=depth)

    if jacobian:
        p = X1.shape[2]
        Xc = X1[..., p // 2, p // 2, :]
        X, Y, Z, H = Xc.unbind(-1)
        o = torch.zeros_like(H)
        fx, fy = intr_j[..., 0], intr_j[..., 1]
        big = torch.abs(Z) > 0.2
        d = torch.where(big, 1.0 / torch.where(big, Z, torch.ones_like(Z)), o)
        Ja = torch.stack([
            H, o, o, o, Z, -Y,
            o, H, o, -Z, o, X,
            o, o, H, Y, -X, o,
            o, o, o, o, o, o,
        ], dim=-1).reshape(*H.shape, 4, 6)
        Jp = torch.stack([
            fx * d, o, -fx * X * d * d, o,
            o, fy * d, -fy * Y * d * d, o,
        ], dim=-1).reshape(*H.shape, 2, 4)
        Jj = Jp @ Ja
        Ji = -se3_adjT(Gij.data[:, :, None], Jj)
        Jz = Jp @ Gij.matrix()[..., :, 3:]
        return x1, (Z > 0.2).to(x1.dtype), (Ji, Jj, Jz)

    if valid:
        return x1, (X1[..., 2] > 0.2).to(x1.dtype)
    return x1


def point_cloud(poses: SE3, patches, intrinsics, ix):
    """Backproject patches into the world frame."""
    X = iproj(patches, _take(intrinsics, ix, 1))
    g = _take(poses.inv().data, ix, 1)[:, :, None, None]
    return SE3(g).act(X)


def flow_mag(poses: SE3, patches, intrinsics, ii, jj, kk, beta=0.3):
    """Blended full / translation-only flow magnitude."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1, val = transform(poses, patches, intrinsics, ii, jj, kk, valid=True)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1 - beta) * flow2, val > 0.5
