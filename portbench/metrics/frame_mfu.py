"""The whole frame's share of the card's bf16 peak, in %: the operations a
steady-state frame needs (``yardstick.counts.frame_flops``: the networks
over the new image and one update over the real edges of the traced SLAM's last
update), times the window's frames, over its seconds and the peak."""
import numpy as np

from portbench.yardstick.counts import frame_flops


def read(ctx):
    c, u = ctx["cell"], ctx["last_update"]
    if u is None or not len(u["ii"]):
        return None
    E = len(u["ii"])
    groups = len(np.unique(u["ii"] * 1_000_003 + u["jj"]))
    flops = frame_flops(c["network"], c["ht"], c["wd"], E, len(np.unique(u["kk"])), groups,
                        c["M"], c["C"])
    rate = flops * ctx["frames"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["flops"]["bf16"]
