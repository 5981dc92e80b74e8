"""Section timer (port of ``cdvslam_tpu.utils.timer``; reference
cdvslam/utils.py:8-29).

On a CUDA device a section is timed by a pair of ``torch.cuda.Event``s
recorded on the current stream; its time is read after synchronizing on
the end event, so it is the device time between the two points of the
stream. On the CPU it is ``time.perf_counter``. Times go to
``ALL_TIMES[name]`` in seconds.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import ContextDecorator

import torch

ALL_TIMES = defaultdict(list)


class Timer(ContextDecorator):
    def __init__(self, name, enabled=True, device=None):
        self.name = name
        self.enabled = enabled
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        if self.enabled:
            if self.cuda:
                self.start = torch.cuda.Event(enable_timing=True)
                self.end = torch.cuda.Event(enable_timing=True)
                self.start.record()
            else:
                self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if self.cuda:
                self.end.record()
                self.end.synchronize()
                ALL_TIMES[self.name].append(self.start.elapsed_time(self.end) / 1e3)
            else:
                ALL_TIMES[self.name].append(time.perf_counter() - self.start)
        return False
