"""The operation and byte counts against hand counts and torch's own
FLOP counter at small shapes."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.ref.models.dinov2 import Block, PatchEmbed
from portbench.ref.models.encoder import BasicEncoder4
from portbench.ref.models.heads import DepthHeadFlatten, SegHeadFlatten
from portbench.ref.models.update import UpdateCDV, UpdateDPV, build_update_aux
from portbench.ref.models.xfeat import XFeat
from portbench.ref.models.attention import LearnableFourierPositionalEncoding
from portbench.yardstick import counts


def flops_of(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_hand_counts():
    assert counts.linear_flops(3, 4, 5) == 120
    assert counts.conv_flops(2, 3, 4, 5, 3) == 2 * 6 * 20 * 9
    assert counts.attn_flops(1, 1891, 6, 64) == 5_492_553_216
    assert counts.attn_flops(2, 10, 6, 64) == 4 * 100 * 64 * 6 * 2
    assert counts.dino_tokens(480, 752) == 35 * 54 + 1
    assert counts.corr_flops(1, 24) == 2 * 2 * 9 * 64 * 24


def test_dino_against_the_flop_counter():
    L, D = 13, 384
    blk, emb = Block(D, 6).eval(), PatchEmbed(14, D).eval()
    x = torch.randn(1, L, D)
    img = torch.randn(1, 3, 42, 56)      # 3 x 4 = 12 patches, 13 tokens with cls
    with torch.no_grad():
        got = flops_of(lambda: emb(img)) + 12 * flops_of(lambda: blk(x))
    assert counts.dino_flops(42, 56) == got


def test_xfeat_and_encoders_against_the_flop_counter():
    with torch.no_grad():
        x = flops_of(lambda: XFeat()(torch.randn(1, 1, 32, 48)))
        e = flops_of(lambda: BasicEncoder4(128)(torch.randn(1, 3, 32, 48)))
    assert counts.xfeat_flops(32, 48) == x
    assert counts.encoder_flops(32, 48, 128) == e


def test_heads_against_the_flop_counter():
    ht, wd, M = 42, 56, 5                  # 3 x 4 = 12 patch tokens
    L = counts.dino_tokens(ht, wd) - 1
    with torch.no_grad():
        seg = SegHeadFlatten()
        every = flops_of(lambda: seg(torch.randn(L, 384)))
        chosen = flops_of(lambda: seg(torch.randn(M, 384)))
        depth = flops_of(lambda: DepthHeadFlatten()(torch.randn(L, 768)))
    assert counts.heads_flops(ht, wd, M, True, True, True) == every + chosen + depth
    assert counts.heads_flops(ht, wd, M, False, True, False) == chosen
    assert counts.heads_flops(ht, wd, M, False, False, False) == 0


def _edges(M=4):
    # frames 0..3, M patches each; every patch of frames 0-1 to frames 0-3
    kk = torch.arange(2 * M).repeat_interleave(4).numpy()
    jj = torch.arange(4).repeat(2 * M).numpy()
    ii = kk // M
    return ii, jj, kk


def test_update_against_the_flop_counter():
    M, D = 4, 384
    ii, jj, kk = _edges(M)
    E = len(ii)
    n_patches, n_groups = len(set(kk.tolist())), len(set(zip(ii.tolist(), jj.tolist())))
    net, inp = torch.randn(1, E, D), torch.randn(1, E, D)
    corr = torch.randn(1, E, 882)
    with torch.no_grad():
        aux = build_update_aux(ii, jj, kk, 0, n_patches, M=M).to_torch("cpu")
        pe = LearnableFourierPositionalEncoding(2, D // 8)
        cdv = flops_of(lambda: UpdateCDV()(net, inp, corr, aux, n_patches,
                                           posenc=pe(torch.randn(1, E, 2))))
        aux = build_update_aux(ii, jj, kk, 0, n_patches).to_torch("cpu")
        dpv = flops_of(lambda: UpdateDPV()(net, inp, corr, aux, n_patches, n_groups))
    assert counts.update_flops("cdv", E, n_patches, n_groups, M) == cdv
    assert counts.update_flops("dpv", E, n_patches, n_groups, M) == dpv


def test_corr_bytes_hand_count():
    # one edge, patch centre deep inside a 32 x 32 map: level 1 reads an
    # 8 x 8 window per pixel of the 3 x 3 patch, 10 x 10 distinct taps;
    # level 2 (coords / 4) the same 10 x 10 where the map is big enough
    C, es = 24, 2
    gmap = torch.empty(5, C, 3, 3, dtype=torch.bfloat16, device="meta")
    f1 = torch.empty(2, 32, 32, C, dtype=torch.bfloat16, device="meta")
    f2 = torch.empty(2, 32, 32, C, dtype=torch.bfloat16, device="meta")
    x, y = torch.meshgrid(torch.arange(3.0) + 60.5, torch.arange(3.0) + 60.5, indexing="xy")
    coords = torch.stack([x, y])[None]            # (1, 2, 3, 3), level 1 at 60-63
    got = counts.corr_bytes(gmap, f1, f2, coords, torch.tensor([1]), torch.tensor([0]))
    # level 1: x0 in 60..62, taps x0-3..x0+4 -> 57..66, all outside a 32-wide
    # map; level 2: x0 = 15, taps 12..19 (8 x 8 = 64, one x0 and y0 for all pixels)
    taps = 0 * C * es + 64 * C * es
    assert got == 1 * 49 * 9 * 2 * es + coords.numel() * 4 + 2 * 4 + 1 * C * 9 * es + taps


def test_busy_time_is_the_union_of_device_intervals():
    from types import SimpleNamespace as NS

    from portbench.yardstick.profile import busy_and_gaps
    cuda = torch.autograd.DeviceType.CUDA

    def ev(a, b, key="k"):
        return NS(device_type=cuda, key=key, time_range=NS(start=a, end=b))
    # a copy on another stream overlapping a kernel counts once; the
    # benchmark's own range on the device timeline not at all
    prof = NS(events=lambda: [ev(0, 10), ev(5, 12), ev(20, 30), ev(0, 100, "portbench.frame")])
    busy, gaps = busy_and_gaps(prof)
    assert abs(busy - 22e-6) < 1e-12 and gaps == [(12, 20)]
