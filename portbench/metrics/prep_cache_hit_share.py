"""Share of ``_prepare_update``'s calls that found their aux rows in its
cache of shift-invariant edge patterns (``stats`` counters
``prep_cache_hits`` and ``prep_cache_misses``), over the window's
sequences."""
from portbench.yardstick.program_trace import counter_share


def read(ctx):
    return counter_share(ctx, "prep_cache_hits", "prep_cache_misses")
