"""Device milliseconds per steady replay from the stamp after the update
operator to the step's last stamp (two BA iterations, the flow magnitude,
the write-back): the program's ``ba`` stage."""
from portbench.yardstick.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "ba")
