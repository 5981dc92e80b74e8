"""Device time stamps: the one-thread kernels of ``csrc/trace.cu`` and their
wrappers (the tracer's device side, ``utils.trace``).

``Stamper(ring, cursor)`` checks a ring once; calling it with ``(slot,
advance)`` writes the device's global timer (nanoseconds) into
``ring[cursor % rows, slot]`` on the current stream and, with ``advance``,
writes the cursor (the row's sequence number) into the row's last slot and
moves the cursor on. Inside a CUDA graph capture the launch becomes a node
of the graph. ``ticks(n, device)`` returns the sizes of ``n`` successive
changes of the timer (its resolution). Both take CUDA tensors only and
raise otherwise. ``LAUNCHES.count`` counts stamp launches: its own
counter, which the corr and attention counts do not include.
"""
from __future__ import annotations

import torch

from . import native

LAUNCHES = native.LaunchCounter("trace_stamp")


class Stamper:
    """Stamps into ring (rows, slots) int64 at row ``cursor % rows``, cursor
    (1,) int64, both contiguous on one card."""

    def __init__(self, ring, cursor):
        if not (ring.is_cuda and cursor.is_cuda and ring.device == cursor.device):
            raise ValueError("Stamper: the ring and the cursor must be on one CUDA device")
        if ring.dtype != torch.int64 or cursor.dtype != torch.int64 or ring.dim() != 2 \
                or not ring.is_contiguous() or cursor.numel() != 1:
            raise ValueError("Stamper: ring (rows, slots) and cursor (1,) must be "
                             "contiguous int64")
        self.ring, self.cursor = ring, cursor      # held while graphs use them
        self.rows, self.slots = ring.shape
        self.device = ring.device
        self._fn = native.load("trace").trace_stamp

    def __call__(self, slot: int, advance: bool = False):
        if not 0 <= slot < self.slots - 1:
            raise ValueError(f"Stamper: slot {slot} outside 0..{self.slots - 2}")
        err = self._fn(self.ring.data_ptr(), self.cursor.data_ptr(), self.rows, self.slots,
                       slot, int(advance), torch.cuda.current_stream(self.device).cuda_stream)
        native.check(err, "trace_stamp")
        LAUNCHES.count += 1


def ticks(n: int, device) -> torch.Tensor:
    """(n,) int64 on the host: successive changes of the device's global
    timer in nanoseconds (waits for the device)."""
    out = torch.zeros(n, dtype=torch.int64, device=device)
    err = native.load("trace").trace_ticks(out.data_ptr(), n,
                                           torch.cuda.current_stream(out.device).cuda_stream)
    native.check(err, "trace_ticks")
    return out.cpu()
