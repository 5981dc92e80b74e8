"""K2's share of its roofline, in %: 4 L^2 d h operations of DINOv2's
attention over one frame (L = tokens with the cls token, d = 64, h = 6)
over the bf16 peak, against K2's mean device time per call in the traced
span."""
from portbench.yardstick.counts import DINO, attn_flops, dino_tokens
from portbench.yardstick.profile import kernel_time

KERNEL = "flash_qkv_kernel"


def read(ctx):
    p, c = ctx["profile"], ctx["cell"]
    if p is None or c["network"] != "cdv":
        return None
    total, calls = kernel_time(p, KERNEL)
    if not calls or not total:
        return None
    h = DINO["heads"]
    flops = attn_flops(1, dino_tokens(c["ht"], c["wd"]), h, DINO["dim"] // h)
    return 100.0 * flops / ctx["peaks"]["flops"]["bf16"] / (total / calls)
