"""Host milliseconds per steady frame in the program's ``launch`` span (the
frame's upload, the copies into the graph's inputs, the graph replay's
launch)."""
from portbench.yardstick.program_trace import steady_ms


def read(ctx):
    return steady_ms(ctx, "launch")
