"""Host milliseconds per steady frame in the program's ``keyframe`` span
(the lagged keyframe decision, the edge compaction, the new edges) less
its ``wait``."""
from portbench.yardstick.program_trace import steady_ms


def read(ctx):
    return steady_ms(ctx, "keyframe", less="wait")
