"""Device milliseconds per steady replay from the stamp after the frame's
writes to the stamp after the update operator (reprojection, K1, the
operator): the program's ``update`` stage."""
from portbench.yardstick.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "update")
