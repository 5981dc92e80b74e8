"""The device's idle share over the traced span: one less the busy seconds
(the union of the profiler's device events, kernels inside graph replays
included) over the wall time of the untraced span of as many frames just
before it."""


def read(ctx):
    p = ctx["profile"]
    return None if p is None else p["idle_share"]
