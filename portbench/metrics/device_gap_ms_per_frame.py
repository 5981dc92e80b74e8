"""Device milliseconds per steady frame between the previous replay's last
stamp and this replay's first (the idle time between two frames' graphs,
the frame's input copies included), from the program's stamps."""
from portbench.yardstick.program_trace import window_records


def read(ctx):
    recs = window_records(ctx)
    if recs is None:
        return None
    count = sum(r.gap[0] for r in recs)
    return sum(r.gap[1] for r in recs) / count / 1e6 if count else None
