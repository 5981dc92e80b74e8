"""The whole frame's share of the card's bf16 peak, in %: the operations a
steady-state frame needs (``yardstick.counts.frame_flops``: the networks
over the new image and one update over the real edges of the traced SLAM's last
update; with the configuration's linear heads ``counts.heads_flops`` too),
times the window's frames, over its seconds and the peak. None with a DPT
depth head, whose operations are not counted."""
import numpy as np

from portbench.yardstick.counts import frame_flops, heads_flops


def read(ctx):
    c, u = ctx["cell"], ctx["last_update"]
    h = c.get("heads", {})
    if u is None or not len(u["ii"]) or "dpt" in (h.get("depth") or ""):
        return None
    E = len(u["ii"])
    groups = len(np.unique(u["ii"] * 1_000_003 + u["jj"]))
    flops = frame_flops(c["network"], c["ht"], c["wd"], E, len(np.unique(u["kk"])), groups,
                        c["M"], c["C"])
    flops += heads_flops(c["ht"], c["wd"], c["M"], h.get("score", False), h.get("seg", False),
                         bool(h.get("depth")))
    rate = flops * ctx["frames"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["flops"]["bf16"]
