"""K1's share of its roofline, in %: the least time the correlation of the
window's last update needs (the larger of its bytes, ``yardstick.counts.
corr_bytes`` over the real edges at the coordinates the state holds after
the window, over the memory bandwidth, and its operations over the bf16
peak) over K1's mean device time per call in the traced span."""
import torch

from portbench.ref.geom import transform
from portbench.ref.lie import SE3
from portbench.yardstick.counts import bound_s, corr_bytes, corr_flops
from portbench.yardstick.profile import kernel_time

KERNEL = "corr_pyramid_kernel"


def read(ctx):
    p, u = ctx["profile"], ctx["last_update"]
    if p is None or u is None or not len(u["ii"]):
        return None
    total, calls = kernel_time(p, KERNEL)
    if not calls or not total:
        return None
    ii, jj, kk = (torch.as_tensor(u[k]) for k in ("ii", "jj", "kk"))
    coords = transform(SE3(u["poses"][None]), u["patches"][None], u["intrinsics"][None],
                       ii, jj, kk)[0].permute(0, 3, 1, 2).contiguous()   # (E, 2, 3, 3)
    meta = {k: torch.empty(u[k + "_shape"], dtype=u["dtype"], device="meta")
            for k in ("gmap", "fmap1", "fmap2")}
    nbytes = corr_bytes(meta["gmap"], meta["fmap1"], meta["fmap2"], coords, kk, jj)
    flops = corr_flops(len(kk), u["gmap_shape"][1])
    return 100.0 * bound_s(flops, nbytes, ctx["peaks"]) / (total / calls)
