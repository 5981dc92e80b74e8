"""Host milliseconds per steady frame in the program's ``prepare`` span
(feature slots, ``_prepare_update``'s index rows, the int and float
blocks)."""
from portbench.yardstick.program_trace import steady_ms


def read(ctx):
    return steady_ms(ctx, "prepare")
