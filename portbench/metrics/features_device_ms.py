"""Device milliseconds per steady replay from the stamp after the keyframe
shift to the stamp after the networks (CDV: XFeat and DINOv2 through K2;
DPVO: the two encoders): the program's ``features`` stage."""
from portbench.yardstick.program_trace import stage_ms


def read(ctx):
    return stage_ms(ctx, "features")
