"""Seconds per sequence in the program's ``terminate`` span (the keyframe
queue drained, 12 eager updates, the trajectory built), the mean over the
window's sequences."""
from portbench.yardstick.program_trace import window_records


def read(ctx):
    recs = window_records(ctx)
    s = [r.totals["terminate"][1] / 1e9 for r in recs or () if "terminate" in r.totals]
    return sum(s) / len(s) if s else None
