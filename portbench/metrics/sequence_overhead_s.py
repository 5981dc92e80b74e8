"""Seconds per sequence outside its steady frames: the SLAM's
construction, the initialisation's frames, the frames that captured a
CUDA graph, ``terminate()`` and freeing the SLAM, averaged over the
window's sequences (each run whole)."""


def read(ctx):
    s = [q["seconds"] - q["steady_s"] for q in ctx["sequences"]]
    return sum(s) / len(s) if s else None
