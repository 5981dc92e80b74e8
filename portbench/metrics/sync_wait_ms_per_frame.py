"""Milliseconds per frame that the host was blocked on the device inside a
frame's hand-over (CUDA event and stream synchronisations: the keyframe
decision's wait for an earlier frame's motion), averaged over the window's
steady frames. Near 0 where the host sets the pace; with
``host_ms_per_frame`` it makes up the frame's wall time."""


def read(ctx):
    s = [wait for _, wait, steady in ctx["frame_log"] if steady]
    return 1e3 * sum(s) / len(s) if s else None
