"""Host milliseconds per steady frame by the program's own spans: its
``frame`` span less the ``wait`` inside it (the host blocked on an earlier
frame's motion), over the window's steady frames (an initialised SLAM that
captured no graph). The twin of ``host_ms_per_frame``, without the
caller's ``prefetch``."""
from portbench.yardstick.program_trace import steady_ms


def read(ctx):
    return steady_ms(ctx, "frame", less="wait")
