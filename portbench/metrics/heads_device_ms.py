"""Device milliseconds per steady replay in the heads: SCORE's selection
(the seg head's dynamic-class mask, the binary score map, the top-k) and
the chosen patches' seg classes (stage ``select``), and the depth head,
its resize to the matching features' grid and the new patches' inverse
depths (stage ``depth``), from the program's stamps; None where the
program stamps neither."""
from portbench.yardstick.program_trace import stage_ms


def read(ctx):
    select, depth = stage_ms(ctx, "select"), stage_ms(ctx, "depth")
    return None if select is None or depth is None else select + depth
