"""Device milliseconds per steady replay in the depth-anchored scale
adjustment inside the step, from the BA's end to the step's last stamp:
the program's ``scale`` stage (None where the program does not stamp it)."""
from portbench.yardstick.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "scale")
