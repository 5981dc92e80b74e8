"""Patch correlation at both pyramid levels: the CUDA kernel ``csrc/corr.cu``
and its wrapper.

``corr_pyramid_cl`` takes the port's internal layout (see ``ops.corr``). On
CPU tensors it returns ``corr_pyramid_plain``; on CUDA tensors it launches
the kernel or raises. ``LAUNCHES.count`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import native
from .corr import corr_pyramid_plain

LAUNCHES = native.LaunchCounter("corr")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the channel counts the kernel is built for: CDV's XFeat (24) and DPVO's
# BasicEncoder4 (128) matching features
KERNEL_CS = (24, 128)


def corr_pyramid_cl(gmap, fmap1_cl, fmap2_cl, coords, ii, jj, radius: int = 3):
    """gmap (K, C, 3, 3), fmap1_cl / fmap2_cl (NF, H, W, C) in gmap's dtype
    (float32 or bfloat16), coords (E, 2, 3, 3) float32 at level 1, ii/jj
    (E,) int32 -> (E, 2R+1, 2R+1, 3, 3, 2) in gmap's dtype, x offset first,
    level innermost; level 2 correlates coords / 4 against fmap2_cl."""
    tensors = (gmap, fmap1_cl, fmap2_cl, coords, ii, jj)
    if all(t.device.type == "cpu" for t in tensors):
        return corr_pyramid_plain(gmap, fmap1_cl, fmap2_cl, coords, ii, jj, radius)
    if not all(t.is_cuda and t.device == gmap.device for t in tensors):
        raise ValueError("corr_pyramid_cl: all inputs must be on one CUDA device")
    K, C, P, P2 = gmap.shape
    NF, H1, W1, C1 = fmap1_cl.shape
    NF2, H2, W2, C2 = fmap2_cl.shape
    E = coords.shape[0]
    if radius != 3 or P != 3 or P2 != 3:
        raise ValueError("corr kernel is built for radius 3 and 3x3 patches")
    if C not in KERNEL_CS or C1 != C or C2 != C or NF2 != NF:
        raise ValueError(f"corr_pyramid_cl: the kernel takes C in {KERNEL_CS} channels, the "
                         "same in gmap and both fmaps, and fmaps with one frame count")
    if gmap.dtype not in _DTYPES or fmap1_cl.dtype != gmap.dtype \
            or fmap2_cl.dtype != gmap.dtype:
        raise ValueError("corr_pyramid_cl: gmap and fmaps must share one dtype (f32 or bf16)")
    if coords.shape != (E, 2, P, P) or coords.dtype != torch.float32:
        raise ValueError("corr_pyramid_cl: coords must be (E, 2, 3, 3) float32")
    if ii.shape != (E,) or jj.shape != (E,) or ii.dtype != torch.int32 \
            or jj.dtype != torch.int32:
        raise ValueError("corr_pyramid_cl: ii/jj must be (E,) int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("corr_pyramid_cl: inputs must be contiguous")
    if gmap.data_ptr() % 16 or fmap1_cl.data_ptr() % 16 or fmap2_cl.data_ptr() % 16:
        raise ValueError("corr_pyramid_cl: the kernel reads in 16-byte loads: "
                         "gmap and the fmaps must be 16-byte aligned")
    out = torch.empty((E, 7, 7, P, P, 2), dtype=gmap.dtype, device=gmap.device)
    if E == 0:
        return out
    lib = native.load("corr")
    err = lib.corr_pyramid_forward(
        gmap.data_ptr(), fmap1_cl.data_ptr(), fmap2_cl.data_ptr(), coords.data_ptr(),
        ii.data_ptr(), jj.data_ptr(), out.data_ptr(), E, K, NF, C, H1, W1, H2, W2,
        _DTYPES[gmap.dtype], torch.cuda.current_stream(gmap.device).cuda_stream)
    native.check(err, "corr_pyramid_forward")
    LAUNCHES.count += 1
    return out
