# Frozen copy of cdvslam_tpu_torch/ops/scatter.py at commit 8ea54d8, part of the
# benchmark's plain reference: it stays as it is when the program changes.
"""Deterministic segment sums and host-side edge neighbours.

``index_add_`` and ``atomicAdd`` sum in an order that changes from run to
run on the card. The bundle adjustment's 12-iteration solves are sensitive
to that reassociation, so every segment sum here is a stable sort of the
segment ids followed by ``torch.segment_reduce`` over the sorted runs: the
same inputs always sum in the same order.

Nothing here reads the device from the host: the run lengths are counted
by an integer ``scatter_add_`` (exact in any order) and ``segment_reduce``
skips its host-side checks of them, so a ``SegmentPlan`` can be built and
summed inside a CUDA graph capture.
"""
from __future__ import annotations

import numpy as np
import torch


class SegmentPlan:
    """Sort order and run lengths for summing rows by segment id.

    Build it once for ids that several sums share (the BA's index arrays
    do not change between Gauss-Newton iterations). Ids outside
    ``[0, num_segments)`` are dropped.
    """

    def __init__(self, ids: torch.Tensor, num_segments: int):
        ids = ids.long()
        keep = (ids >= 0) & (ids < num_segments)
        ids = torch.where(keep, ids, torch.full_like(ids, num_segments))
        self.order = torch.argsort(ids, stable=True)
        self.lengths = torch.zeros(num_segments + 1, dtype=torch.long,
                                   device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))
        self.num_segments = num_segments

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """(n, ...) rows -> (num_segments, ...) per-segment sums."""
        # unsafe: the lengths are non-negative and sum to n by construction
        out = torch.segment_reduce(vals[self.order], "sum",
                                   lengths=self.lengths, axis=0, unsafe=True)
        return out[: self.num_segments]


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
