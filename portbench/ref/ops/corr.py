# Frozen copy of cdvslam_tpu_torch/ops/corr.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Local patch correlation, plain PyTorch version.

For every edge e (patch ii[e] -> frame jj[e]) it takes the C-channel dot
product of the patch's source features with a (2R+2)^2 window of the
target feature map at the reprojected coordinates (taps outside the image
read zero), then blends the four integer-shifted volumes bilinearly down
to (2R+1)^2. The output is (E, Dx, Dy, P, P): x offset first, the layout
the update operator's weights expect.

``corr`` keeps the JAX package's signature and layout; ``corr_cl_plain``
takes the port's internal layout, with the frame pyramids channels-last
``(NF, H, W, C)`` so that the C channels of one tap are contiguous.
``corr_pyramid_plain`` runs it at both levels of the update; the CUDA
kernel in ``corr_cuda`` computes ``corr_pyramid_plain``.
"""
from __future__ import annotations

import torch

# edges per chunk at 24 channels: bounds the gathered (chunk, P, P, D, D, C)
# windows; wider features take proportionally fewer edges per chunk
_CHUNK = 4096


def corr_cl_plain(gmap, fmap_cl, coords, ii, jj, radius: int = 3):
    """gmap (K, C, P, P), fmap_cl (NF, H, W, C), coords (E, 2, P, P) float32
    (or float64), ii/jj (E,) integer -> (E, 2R+1, 2R+1, P, P) in gmap's dtype."""
    K, C, P, _ = gmap.shape
    NF, H, W, _ = fmap_cl.shape
    E = coords.shape[0]
    D = 2 * radius + 2
    dev = gmap.device
    fflat = fmap_cl.reshape(NF * H * W, C)
    di = torch.arange(D, device=dev) - radius
    chunk = max(_CHUNK * 24 // max(C, 24), 1)
    parts = []
    for s in range(0, E, chunk):
        c = coords[s:s + chunk]
        g = gmap[ii[s:s + chunk].long().clamp(0, K - 1)]            # (e,C,P,P)
        fj = jj[s:s + chunk].long().clamp(0, NF - 1)
        x, y = c[:, 0], c[:, 1]
        ix0 = torch.floor(x).long()
        iy0 = torch.floor(y).long()
        iy = (iy0[..., None, None] + di[:, None]).expand(*iy0.shape, D, D)
        ix = (ix0[..., None, None] + di[None, :]).expand(*ix0.shape, D, D)
        inb = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        base = (fj * H * W)[:, None, None, None, None]
        idx = base + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)     # (e,P,P,D,D)
        f = torch.index_select(fflat, 0, idx.reshape(-1)).reshape(*idx.shape, C)
        vol = torch.einsum("ecpq,epqijc->eijpq", g, f)              # (e,Dy,Dx,P,P)
        # a tap outside the image reads zero: its dot is zero (masking the
        # dots, not the C-wide taps)
        vol = torch.where(inb.permute(0, 3, 4, 1, 2), vol,
                          torch.zeros((), dtype=vol.dtype, device=dev))
        dxf = (x - torch.floor(x)).to(vol.dtype)[:, None, None]
        dyf = (y - torch.floor(y)).to(vol.dtype)[:, None, None]
        out = (1 - dxf) * (1 - dyf) * vol[:, :D - 1, :D - 1]
        out = out + dxf * (1 - dyf) * vol[:, :D - 1, 1:]
        out = out + (1 - dxf) * dyf * vol[:, 1:, :D - 1]
        out = out + dxf * dyf * vol[:, 1:, 1:]
        parts.append(out.transpose(1, 2))                            # x first
    if not parts:
        return torch.zeros((0, D - 1, D - 1, P, P), dtype=gmap.dtype, device=dev)
    return torch.cat(parts, 0)


def corr_pyramid_plain(gmap, fmap1_cl, fmap2_cl, coords, ii, jj, radius: int = 3):
    """Both pyramid levels, level 2 at coords / 4, stacked with the level
    innermost: (E, 2R+1, 2R+1, P, P, 2)."""
    c1 = corr_cl_plain(gmap, fmap1_cl, coords, ii, jj, radius)
    c2 = corr_cl_plain(gmap, fmap2_cl, coords / 4.0, ii, jj, radius)
    return torch.stack([c1, c2], -1)


def corr(gmap, fmap, coords, ii, jj, radius: int = 3):
    """The JAX package's signature: gmap (B, K, C, P, P), fmap (B, NF, C, H, W),
    coords (B, E, 2, P, P) -> (B, E, 2R+1, 2R+1, P, P). Batch 1 only."""
    if gmap.shape[0] != 1:
        raise ValueError("corr supports batch 1 only")
    fmap_cl = fmap[0].permute(0, 2, 3, 1).contiguous()
    return corr_cl_plain(gmap[0], fmap_cl, coords[0], ii, jj, radius)[None]
