"""Share of keyframe shifts run eagerly (``_apply_pending_shift``: extra
launches outside the graph) rather than folded into the next replay
(``stats`` counters ``shifts_eager`` and ``shifts_deferred``), over the
window's sequences."""
from portbench.yardstick.program_trace import counter_share


def read(ctx):
    return counter_share(ctx, "shifts_eager", "shifts_deferred")
