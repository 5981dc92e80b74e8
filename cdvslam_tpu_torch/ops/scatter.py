"""Deterministic segment sums and host-side edge neighbours.

``index_add_`` and ``atomicAdd`` sum in an order that changes from run to
run on the card. The bundle adjustment's 12-iteration solves are sensitive
to that reassociation, so every segment sum here follows a stable sort of
the segment ids and adds each segment's rows in sorted order, from 0: on
CPU tensors ``torch.segment_reduce`` over the sorted runs, on CUDA tensors
the kernel of ``csrc/segsum.cu`` (``ops/segsum_cuda.py``), which reads the
rows through the sort order and gives ``segment_reduce``'s bits. Sums of
1-D rows stay with ``segment_reduce`` on the card: there it is CUB's
segmented reduce, a tree in another order than the serial one, and the
BA's solves carry that difference far: the kernel's serial order on the
BA's 1-D sums moved its poses by up to 1.2e-2 from the tree's. The same
inputs always sum in the same order.

Nothing here reads the device from the host: the run lengths are counted
by an integer ``scatter_add_`` (exact in any order), the run offsets are
their running sum, the kernel's grid follows from the shapes alone, and
``segment_reduce`` skips its host-side checks of the lengths, so a
``SegmentPlan`` can be built and summed inside a CUDA graph capture.
"""
from __future__ import annotations

import numpy as np
import torch

from . import segsum_cuda


class SegmentPlan:
    """Sort order, run lengths and run offsets for summing rows by segment id.

    Build it once for ids that several sums share (the BA's index arrays
    do not change between Gauss-Newton iterations). Ids outside
    ``[0, num_segments)`` are dropped: they go to a last segment,
    ``num_segments``, that no sum returns. ``offsets`` (num_segments + 1,)
    is the first sorted row of each segment and of the dropped rows.
    """

    def __init__(self, ids: torch.Tensor, num_segments: int):
        ids = ids.long()
        keep = (ids >= 0) & (ids < num_segments)
        self.ids = torch.where(keep, ids, torch.full_like(ids, num_segments))
        self.order = torch.argsort(self.ids, stable=True)
        self.lengths = torch.zeros(num_segments + 1, dtype=torch.long,
                                   device=ids.device).scatter_add_(0, self.ids,
                                                                   torch.ones_like(ids))
        self.offsets = torch.cumsum(self.lengths, 0) - self.lengths
        self.num_segments = num_segments

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """(n, ...) rows -> (num_segments, ...) per-segment sums."""
        if vals.device.type == "cpu" or vals.dim() == 1:
            return segsum_cuda.segment_sum_plain(vals, self)
        return _KernelSum.apply(vals, self)


class _KernelSum(torch.autograd.Function):
    """``segsum_cuda.segment_sum``; the gradient of a row is the upstream
    gradient of its segment, zero for a dropped row."""

    @staticmethod
    def forward(ctx, vals, plan):
        ctx.plan = plan
        return segsum_cuda.segment_sum(vals, plan)

    @staticmethod
    def backward(ctx, grad):
        ids = ctx.plan.ids
        grad = torch.cat([grad, grad.new_zeros((1, *grad.shape[1:]))])
        return grad[ids], None


def neighbors_np(kk, jj):
    """Temporal predecessor/successor edge indices, host-side numpy.

    Copy of ``cdvslam_tpu.ops.scatter.neighbors_np`` (the reference's C++
    ``fastba.neighbors``): for every edge, the edge with the same patch kk
    and the previous / next jj (stable order). Returns (ix, jx) with -1
    where absent.
    """
    kk = np.asarray(kk)
    jj = np.asarray(jj)
    n = len(kk)
    ix = np.full(n, -1, dtype=np.int64)
    jx = np.full(n, -1, dtype=np.int64)
    order = np.lexsort((np.arange(n), jj, kk))  # group by kk, sort by jj (stable)
    ks = kk[order]
    same = np.zeros(n, dtype=bool)
    if n > 1:
        same[1:] = ks[1:] == ks[:-1]
    prev_edge = np.full(n, -1, dtype=np.int64)
    if n > 1:
        prev_edge[1:] = np.where(same[1:], order[:-1], -1)
    next_edge = np.full(n, -1, dtype=np.int64)
    if n > 1:
        next_edge[:-1] = np.where(same[1:], order[1:], -1)
    ix[order] = prev_edge
    jx[order] = next_edge
    return ix, jx
