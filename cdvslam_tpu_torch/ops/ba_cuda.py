"""The bundle adjustment's Gauss-Newton iteration on the card: the CUDA
kernels of ``csrc/ba_edges.cu`` and their wrappers.

``linearize`` computes, in one launch, every row an iteration of
``ba.ba_solve`` sums: what ``ba._linearize`` computes with about 200 torch
operations. ``update`` applies the solve's step (the poses' retraction and
the depth step with the inference clamps) in one launch: what the end of
an iteration of ``ba_solve`` computes with about 110. Both give the plain
chain's bits on the same inputs (the kernels round as its torch kernels
round, operation by operation); ``ba_solve`` runs them on CUDA float32
inputs with the inference numerics and no gradient, and the plain chain
everywhere else. Both take CUDA float32 tensors only and raise a
ValueError otherwise. ``LAUNCHES.count`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import native

LAUNCHES = native.LaunchCounter("ba_edges")


def _require(what, floats, ints, bools):
    """Raise a ValueError unless floats (poses, patches, ...) are CUDA
    float32 of the kernels' shapes, ints int64 and bools bool, on one device."""
    poses, patches = floats[:2]
    if poses.dim() != 2 or poses.shape[1] != 7 or patches.dim() != 4 or patches.shape[1] != 3:
        raise ValueError(f"{what}: poses (NP, 7) and patches (K, 3, P, P), not "
                         f"{tuple(poses.shape)} and {tuple(patches.shape)}")
    dev = poses.device
    for t in floats:
        if not (t.is_cuda and t.dtype == torch.float32):
            raise ValueError(f"{what}: the kernel takes CUDA float32 tensors, not "
                             f"{t.dtype} on {t.device}")
    for t, dtype in [(t, torch.int64) for t in ints] + [(t, torch.bool) for t in bools]:
        if t.dtype != dtype:
            raise ValueError(f"{what}: an index or mask tensor must be {dtype}, not {t.dtype}")
    if any(t.device != dev for t in (*floats, *ints, *bools)):
        raise ValueError(f"{what}: all tensors must be on one CUDA device")


def linearize(poses, patches, intrinsics, target, weight, ii, jj, kk, mask, params):
    """The rows of one iteration's sums, as ``ba._linearize`` returns them:
    (4E, 6, 6) [Bii, Bjj, -Bij, -Bij^T], (2E, 6) [ei, ej], (2E, 6) [vi, vj],
    (E,) C and (E,) u. ii, jj (E,) int64 rows of ``poses``, kk (E,) int64
    patches, all in range; mask (E,) bool; ``params`` a ``BAParams`` with
    the inference gate (its z_min, res_thresh and bounds_margin)."""
    _require("ba_linearize", (poses, patches, intrinsics, target, weight), (ii, jj, kk), (mask,))
    E, P = ii.shape[0], patches.shape[-1]
    if intrinsics.numel() != 4:
        raise ValueError("ba_linearize: intrinsics must have 4 elements")
    for name, t, shape in (("jj", jj, (E,)), ("kk", kk, (E,)), ("mask", mask, (E,)),
                           ("target", target, (E, 2)), ("weight", weight, (E, 2))):
        if t.shape != shape:
            raise ValueError(f"ba_linearize: {name} must be {shape}, not {tuple(t.shape)}")
    new = poses.new_empty
    rows_b, rows_e, rows_v = new((4 * E, 6, 6)), new((2 * E, 6)), new((2 * E, 6))
    row_c, row_u = new((E,)), new((E,))
    if E == 0:
        return rows_b, rows_e, rows_v, row_c, row_u
    args = [t.contiguous() for t in (poses, patches, intrinsics, target, weight, ii, jj, kk,
                                     mask)]
    err = native.load("ba_edges").ba_linearize_forward(
        *(t.data_ptr() for t in args), E, P, params.z_min, params.res_thresh,
        params.bounds_margin, rows_b.data_ptr(), rows_e.data_ptr(), rows_v.data_ptr(),
        row_c.data_ptr(), row_u.data_ptr(),
        torch.cuda.current_stream(poses.device).cuda_stream)
    native.check(err, "ba_linearize_forward")
    LAUNCHES.count += 1
    return rows_b, rows_e, rows_v, row_c, row_u


def update(poses, patches, dX, dZ, touched, win_rows):
    """(poses, patches) after one iteration's step, new tensors: the window
    rows ``win_rows`` (N,) int64 of ``poses`` (NP, 7) retracted by ``dX``
    (6N,) (rows NP and past dropped), or ``poses`` itself for ``dX`` None
    (depths alone); every patch's inverse depth plus ``dZ`` (K,), reset to 1
    above 20 and floored at 1e-4 where ``touched`` (K,) bool, else kept."""
    floats = (poses, patches, dZ) if dX is None else (poses, patches, dZ, dX)
    _require("ba_update", floats, (win_rows,), (touched,))
    NP, K, P, N = poses.shape[0], patches.shape[0], patches.shape[-1], win_rows.shape[0]
    if dX is not None and dX.shape != (6 * N,):
        raise ValueError(f"ba_update: dX must be ({6 * N},), not {tuple(dX.shape)}")
    if dZ.shape != (K,) or touched.shape != (K,):
        raise ValueError(f"ba_update: dZ and touched must be ({K},)")
    # held until the launch: a freed temporary's memory could be handed on first
    args = [t.contiguous() for t in (poses, patches, dZ, touched, win_rows)]
    dX = None if dX is None else dX.contiguous()
    patches_out = torch.empty((K, 3, P, P), dtype=patches.dtype, device=patches.device)
    poses_out = poses if dX is None else torch.empty((NP, 7), dtype=poses.dtype,
                                                     device=poses.device)
    err = native.load("ba_edges").ba_update_forward(
        args[0].data_ptr(), args[1].data_ptr(), None if dX is None else dX.data_ptr(),
        *(t.data_ptr() for t in args[2:]), NP, N, K, P, poses_out.data_ptr(),
        patches_out.data_ptr(), torch.cuda.current_stream(poses.device).cuda_stream)
    native.check(err, "ba_update_forward")
    LAUNCHES.count += 1
    return poses_out, patches_out
