"""Milliseconds per steady frame the host was blocked on the device, by the
program's ``wait`` span (the keyframe decision's wait for the motion of
the frame two back). The twin of ``sync_wait_ms_per_frame``."""
from portbench.yardstick.program_trace import steady_ms


def read(ctx):
    return steady_ms(ctx, "wait")
