"""CUDA graph captures in the window: the change of ``SLAM.fused.captures``
over it, summed over every SLAM that ran (a new sequence's SLAM captures
its keys anew)."""


def read(ctx):
    return float(ctx["captures"])
