"""The program's own trace records (``cdvslam_tpu_torch.utils.trace``), as
the per-layer readers of the program's spans, stamps and counters take
them: the window's sequences, each the record of a SLAM that reached
``terminate()``.

``window_records(ctx)`` is None in an untraced run (``ctx["profile"]`` is
None), where the program has no tracer (an older program), or where it
kept no record of the window's sequences; else the records of the
``len(ctx["sequences"])`` newest SLAMs that reached ``terminate()``, oldest
first (the traced span's SLAM never terminates, so it is not among them).
The helpers sum over those records and return None where the sum has
nothing to divide by.
"""
from __future__ import annotations


def window_records(ctx):
    if ctx.get("profile") is None or not ctx.get("sequences"):
        return None
    try:
        from cdvslam_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.ended(len(ctx["sequences"]))
    return recs or None


def steady_ms(ctx, name, less=None):
    """Milliseconds per steady frame in span ``name`` (less span ``less``)."""
    recs = window_records(ctx)
    if recs is None:
        return None
    frames = sum(r.steady_frames for r in recs)
    if not frames or not any(name in r.steady for r in recs):
        return None
    ns = sum(r.steady.get(name, (0, 0))[1] - (r.steady.get(less, (0, 0))[1] if less else 0)
             for r in recs)
    return ns / frames / 1e6


def counter_share(ctx, part, other):
    """stats[part] / (stats[part] + stats[other]) over the records."""
    recs = window_records(ctx)
    if recs is None or not all(part in r.stats and other in r.stats for r in recs):
        return None
    a = sum(r.stats[part] for r in recs)
    b = sum(r.stats[other] for r in recs)
    return a / (a + b) if a + b else None


def stage_ms(ctx, stage):
    """Device milliseconds of ``stage`` per steady replay (its stamps)."""
    recs = window_records(ctx)
    if recs is None:
        return None
    count = sum(r.stages.get(stage, (0, 0))[0] for r in recs)
    ns = sum(r.stages.get(stage, (0, 0))[1] for r in recs)
    return ns / count / 1e6 if count else None
