"""Host milliseconds of work per frame: the benchmark's host-clock span
around each frame's hand-over (``SLAM.prefetch`` and ``SLAM.__call__``)
less the time the host was blocked inside it on the device (CUDA event and
stream synchronisations), averaged over the window's steady frames (an
initialised SLAM, no graph captured)."""


def read(ctx):
    s = [span - wait for span, wait, steady in ctx["frame_log"] if steady]
    return 1e3 * sum(s) / len(s) if s else None
