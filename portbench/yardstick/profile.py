"""What a torch.profiler trace of a span of frames says about the device.

The idle arithmetic follows ``chip_smoke.py``'s ``_profile_window``
(commit 8ea54d8): one less the device's busy time over the wall time of
an untraced span of as many frames (the profiler's own host cost inflates
the traced span). Busy time here is the union of the device events'
intervals (kernels inside CUDA graph replays included), where
``_profile_window`` summed their self times: the prefetched uploads run on
a stream of their own beside the replay, and a sum counts that overlap
twice (it read a busy time above the wall time). The breakdown of idle
gaps is the benchmark's own.
"""
from __future__ import annotations

import numpy as np

# the host's CUDA API calls that start work on the device
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync", "cudaStreamSynchronize", "cudaEventSynchronize")
GAP_MIN_US = 10.0
# the benchmark's own host ranges: the profiler shows them on the device's
# timeline too, where they are no device work
RANGE_PREFIX = "portbench."


def _on_device(e):
    """A device event (of ``prof.events()`` or ``key_averages()``) that is
    device work."""
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith(RANGE_PREFIX)


def _device_events(prof):
    return [e for e in prof.events() if _on_device(e)]


def busy_and_gaps(prof):
    """(busy seconds, gaps): the union of the device events' intervals, and
    the (start, end) in microseconds of each gap between them."""
    dev = sorted((e.time_range.start, e.time_range.end) for e in _device_events(prof))
    if not dev:
        return 0.0, []
    busy, gaps = 0.0, []
    start, end = dev[0]
    for s, e in dev[1:]:
        if s > end:
            busy += end - start
            gaps.append((end, s))
            start = s
        end = max(end, e)
    return (busy + end - start) * 1e-6, gaps


def idle_gaps(prof, gaps, top=10):
    """[name, seconds]: the device's idle ``gaps`` of at least GAP_MIN_US,
    summed by the innermost host span or operation under each gap's
    midpoint ("no host op" where none is), the largest ``top``; shorter
    gaps are summed under one entry."""
    import torch
    short = sum(g1 - g0 for g0, g1 in gaps if g1 - g0 < GAP_MIN_US)
    gaps = [(g0, g1) for g0, g1 in gaps if g1 - g0 >= GAP_MIN_US]
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    starts = np.array([e.time_range.start for e in host], np.float64)
    ends = np.array([e.time_range.end for e in host], np.float64)
    names = [e.name for e in host]
    by_name = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = names[hit[np.argmin(ends[hit] - starts[hit])]] if len(hit) else "no host op"
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) * 1e-6
    if short:
        by_name[f"gaps under {GAP_MIN_US:g} us"] = short * 1e-6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def summarize(prof, frames, untraced_wall_s, traced_wall_s):
    """The traced span's device numbers: busy seconds, the idle share
    against the untraced span's wall time, each device event's total self
    seconds and count by name, the host's launch calls per frame, and the
    breakdown lists (the top device operations, the idle gaps)."""
    events = prof.key_averages()
    dev = [e for e in events if _on_device(e)]
    busy_s, gaps = busy_and_gaps(prof)
    kernels = {e.key: (e.self_device_time_total * 1e-6, e.count) for e in dev}
    host_calls = {name: sum(e.count for e in events if e.key == name) / frames
                  for name in HOST_LAUNCH_CALLS}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"frames": frames, "busy_s": busy_s, "untraced_wall_s": untraced_wall_s,
            "traced_wall_s": traced_wall_s,
            "idle_share": 1.0 - busy_s / untraced_wall_s,
            "kernels": kernels,
            "host_launch_calls_per_frame": {k: v for k, v in host_calls.items() if v},
            "device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": idle_gaps(prof, gaps)}


def kernel_time(summary, fragment):
    """(total seconds, calls) of the device events whose name holds
    ``fragment``."""
    hits = [v for k, v in summary["kernels"].items() if fragment in k]
    return sum(t for t, _ in hits), sum(n for _, n in hits)


def traced_span(advance, frames, cuda):
    """``advance(frames)`` untraced (its wall time), then again under
    ``torch.profiler`` (the device too where ``cuda``); the trace's
    ``summarize``."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    marks, prof = [], None
    for span in range(2):
        if span:
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.start()
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        advance(frames)
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
    prof.stop()
    return summarize(prof, frames, marks[1] - marks[0], marks[3] - marks[2])
