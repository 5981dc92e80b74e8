"""Deterministic segment sums on the card: the CUDA kernel ``csrc/segsum.cu``
and its wrapper.

``segment_sum(vals, plan)`` sums the rows of CUDA ``vals`` (n, ...) by the
segments of a ``SegmentPlan`` (``ops/scatter.py``) into (num_segments, ...),
each column of a segment from 0, row after row in the plan's sorted order,
in one launch, or raises. ``segment_sum_plain`` is the plain version
``SegmentPlan.sum`` runs on CPU tensors, in the same order.
``LAUNCHES.count`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import native

LAUNCHES = native.LaunchCounter("segsum")
_DTYPES = {torch.float32: 0, torch.float64: 1}


def segment_sum_plain(vals, plan):
    """The plain version: the rows gathered into sorted order and
    ``torch.segment_reduce`` over the runs."""
    # unsafe: the lengths are non-negative and sum to n by construction
    out = torch.segment_reduce(vals[plan.order], "sum", lengths=plan.lengths, axis=0,
                               unsafe=True)
    return out[: plan.num_segments]


def segment_sum(vals, plan):
    """vals (n, ...) float32 or float64 on the card -> (num_segments, ...)
    in its dtype."""
    if not all(t.is_cuda and t.device == vals.device for t in (vals, plan.order, plan.offsets)):
        raise ValueError("segment_sum: vals and the plan must be on one CUDA device")
    if vals.dtype not in _DTYPES:
        raise ValueError(f"segment_sum: the kernel sums float32 or float64, not {vals.dtype}")
    n, S = vals.shape[0], plan.num_segments
    for name, t, size in (("order", plan.order, n), ("offsets", plan.offsets, S + 1)):
        if t.shape != (size,) or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"segment_sum: the plan's {name} must be ({size},) contiguous int64")
    vals = vals.contiguous()
    if vals.data_ptr() % 16:    # a view into the middle of a storage
        vals = vals.clone()
    D = math.prod(vals.shape[1:])
    out = torch.empty((S, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    if S == 0 or D == 0:
        return out
    err = native.load("segsum").segment_sum_forward(
        vals.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(), out.data_ptr(), S, D,
        _DTYPES[vals.dtype], torch.cuda.current_stream(vals.device).cuda_stream)
    native.check(err, "segment_sum_forward")
    LAUNCHES.count += 1
    return out
