"""The hand-written kernels against their plain versions on the card.

Marked ``cuda``: they skip on a host without a CUDA card (run them on the
card with ``python -m pytest tests/test_torch_cuda.py -q``; chip_smoke.py
runs the same comparisons at the main-path shapes). Tolerances: corr f32
1e-4 absolute (f32 dots of 24 or 128 products summed in another order); corr
bf16 5e-3 of max |plain| against the plain version evaluated in f32 on the
same bf16 values; flash attention bf16 max abs 2e-2 and relative Frobenius
1e-2 (bf16 probabilities against bf16 softmax then matmul); global BA on
the card against the CPU port on the same float32 inputs 1e-4 on poses and
1e-3 on inverse depths (cuBLAS and the CPU sum in other orders), and two
solves on the card bitwise equal; the heads on the card against the CPU
port in float32 with TF32 off: seg logits 1e-4 with equal classes, linear
depth 1e-4 relative, DPT and its resize 1e-4 of max |CPU| (cuDNN and the
CPU sum the convolutions in other orders); the DPVO SLAM on the card in
float32 (TF32 off) against the CPU port on the same seeded weights and
frames: the same patch centres, one corr launch per update at C = 128, and
poses within 1e-3 per component (the encoders, the update operator and 16
BAs summed in other orders).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from cdvslam_tpu_torch.ba.global_ba import build_global_indices, global_ba_solve
from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.geom import transform
from cdvslam_tpu_torch.lie import SE3, se3_exp, se3_mul
from cdvslam_tpu_torch.models.dpt import DPTHead, resize
from cdvslam_tpu_torch.models.heads import DepthHeadFlatten, SegHeadFlatten
from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
from cdvslam_tpu_torch.ops.corr import corr_pyramid_plain
from cdvslam_tpu_torch.slam import SLAM

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _corr_case(dev, dtype, E=777, K=90, NF=7, C=24, H=60, W=94, layout="border"):
    """Level-1 fmap (H, W) and level-2 (H/4, W/4). layout: "border" (centers
    spread past every border, pixels jittered by +-1.5 px), "rigid" (3x3
    patches of 1 px spacing plus +-0.2 px jitter) or "scattered" (+-20 px
    jitter: the union box does not fit, the kernel reads global memory)."""
    g = torch.Generator(device=dev).manual_seed(0)
    gmap = torch.randn((K, C, 3, 3), generator=g, device=dev).to(dtype)
    fmap1 = torch.randn((NF, H, W, C), generator=g, device=dev).to(dtype)
    fmap2 = torch.randn((NF, H // 4, W // 4, C), generator=g, device=dev).to(dtype)
    cx = torch.rand((E, 1, 1), generator=g, device=dev) * (W + 24) - 12
    cy = torch.rand((E, 1, 1), generator=g, device=dev) * (H + 24) - 12
    jit = {"border": 1.5, "rigid": 0.2, "scattered": 20.0}[layout]
    noise = (torch.rand((E, 2, 3, 3), generator=g, device=dev) * 2 - 1) * jit
    if layout == "rigid":
        d = torch.arange(3, device=dev, dtype=torch.float32) - 1
        noise = noise + torch.stack([d[None, :].expand(3, 3), d[:, None].expand(3, 3)])
    coords = (torch.stack([cx.expand(E, 3, 3), cy.expand(E, 3, 3)], 1) + noise).contiguous()
    ii = torch.randint(0, K, (E,), generator=g, device=dev, dtype=torch.int32)
    jj = torch.randint(0, NF, (E,), generator=g, device=dev, dtype=torch.int32)
    return gmap, fmap1, fmap2, coords, ii, jj


def _check_corr(args, dtype):
    before = corr_cuda.LAUNCHES.count
    got = corr_cuda.corr_pyramid_cl(*args).float()
    assert corr_cuda.LAUNCHES.count == before + (1 if args[3].shape[0] else 0)
    g, f1, f2, c, ii, jj = args
    want = corr_pyramid_plain(g.float(), f1.float(), f2.float(), c, ii, jj)
    assert got.shape == want.shape == (c.shape[0], 7, 7, 3, 3, 2)
    if c.shape[0] == 0:
        return
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4
    else:
        assert err <= 5e-3 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corr_kernel_matches_plain(card, dtype):
    _check_corr(_corr_case(card, dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,layout", [(0, "border"), (1, "border"), (777, "rigid"),
                                      (777, "scattered"), (1203, "border")])
def test_corr_kernel_cases(card, dtype, E, layout):
    _check_corr(_corr_case(card, dtype, E=E, layout=layout), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,layout", [(0, "border"), (1, "border"), (777, "rigid"),
                                      (777, "scattered"), (1203, "border")])
def test_corr_kernel_c128_cases(card, dtype, E, layout):
    """DPVO's 128 channels: the chunked box (bf16) and the global branch."""
    _check_corr(_corr_case(card, dtype, E=E, C=128, layout=layout), dtype)


@pytest.mark.parametrize("L", [1, 64, 65, 301, 1891])
def test_flash_attention_matches_plain(card, L):
    g = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn((1, L, 3 * 384), generator=g, device=card).to(torch.bfloat16)
    before = flash_attn.LAUNCHES.count
    got = flash_attn.flash_attention_qkv(qkv, 6).float()
    assert flash_attn.LAUNCHES.count == before + 1
    want = flash_attn.attention_qkv_plain(qkv, 6).float()
    assert got.shape == want.shape == (1, L, 384)
    assert (got - want).abs().max().item() <= 2e-2
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_flash_attention_batches_and_heads(card):
    g = torch.Generator(device=card).manual_seed(2)
    qkv = torch.randn((2, 130, 3 * 128), generator=g, device=card).to(torch.bfloat16)
    got = flash_attn.flash_attention_qkv(qkv, 2).float()
    want = flash_attn.attention_qkv_plain(qkv, 2).float()
    assert (got - want).abs().max().item() <= 2e-2
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    qkv = torch.randn((1, 10, 3 * 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attn.flash_attention_qkv(qkv, 2)               # head dim 32
    with pytest.raises(ValueError):
        flash_attn.flash_attention_qkv(qkv.float(), 1)       # float32
    strided = torch.randn((1, 10, 2 * 3 * 64), device=card, dtype=torch.bfloat16)[..., :192]
    with pytest.raises(ValueError):
        flash_attn.flash_attention_qkv(strided, 1)
    gmap, f1, f2, coords, ii, jj = _corr_case(card, torch.float32)
    with pytest.raises(ValueError):
        corr_cuda.corr_pyramid_cl(gmap, f1, f2, coords, ii.long(), jj)
    # the kernel reads a tap's channels in 16-byte loads
    unaligned = f1.new_empty(f1.numel() + 1)[1:].view(f1.shape).copy_(f1)
    with pytest.raises(ValueError):
        corr_cuda.corr_pyramid_cl(gmap, unaligned, f2, coords, ii, jj)
    for c in (20, 64):
        gmap_c, f1, f2, coords, ii, jj = _corr_case(card, torch.bfloat16, C=c)
        with pytest.raises(ValueError):
            corr_cuda.corr_pyramid_cl(gmap_c, f1, f2, coords, ii, jj)
    gmap128, *_ = _corr_case(card, torch.bfloat16, C=128)
    with pytest.raises(ValueError):                      # 128 in gmap, 64 in the fmaps
        corr_cuda.corr_pyramid_cl(gmap128, f1, f2, coords, ii, jj)


def _global_problem(NF=40, M=16, t0=2):
    """Frames on a forward walk; edges to the 3 frames on either side and
    from frames 0-5 to frames 34-39 (loop pairs); targets from the true
    poses plus 0.3 px noise; poses and depths perturbed."""
    g = torch.Generator().manual_seed(3)
    xi = 0.02 * torch.randn((NF, 6), generator=g)
    xi[:, 2] += 0.05 * torch.arange(NF)
    gt = se3_exp(xi)
    K = NF * M
    patches = torch.zeros((K, 3, 3, 3))
    patches[:, 0] = (torch.rand(K, generator=g) * 180)[:, None, None]
    patches[:, 1] = (torch.rand(K, generator=g) * 110)[:, None, None]
    patches[:, 2] = (0.5 + torch.rand(K, generator=g))[:, None, None]
    intr = torch.tensor([115.0, 115.0, 94.0, 60.0])
    pairs = [(i, j) for i in range(NF) for j in range(NF) if 0 < abs(i - j) <= 3]
    pairs += [(i, j) for i in range(6) for j in range(NF - 6, NF)]
    pairs = torch.tensor(pairs)
    ii = pairs[:, 0].repeat_interleave(M)
    jj = pairs[:, 1].repeat_interleave(M)
    kk = ii * M + torch.arange(M).repeat(len(pairs))
    coords = transform(SE3(gt[None]), patches[None], intr.expand(1, NF, 4), ii, jj, kk)
    target = coords[0, :, 1, 1] + 0.3 * torch.randn((len(ii), 2), generator=g)
    weight = torch.rand((len(ii), 2), generator=g)
    pert = se3_exp(0.01 * torch.randn((NF, 6), generator=g))
    pert[:t0] = torch.tensor([0, 0, 0, 0, 0, 0, 1.0])
    noisy = patches.clone()
    noisy[:, 2] = (noisy[:, 2] + 0.1 * torch.randn((K, 1, 1), generator=g)).clamp(min=0.1)
    idx = build_global_indices(ii.numpy(), jj.numpy(), kk.numpy(), M)
    return (se3_mul(pert, gt), noisy, intr, target, weight), idx, t0, NF - t0, M


def test_global_ba_on_the_card_matches_the_cpu_and_repeats(card):
    tensors, idx, t0, N, M = _global_problem()
    want = global_ba_solve(*tensors, idx.to("cpu"), t0, N=N, M=M, iterations=2)
    args = [t.to(card) for t in tensors]
    runs = [global_ba_solve(*args, idx.to(card), t0, N=N, M=M, iterations=2)
            for _ in range(2)]
    assert (want[0] - tensors[0]).abs().max() > 1e-3       # the solve moved the poses
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert (runs[0][0].cpu() - want[0]).abs().max().item() <= 1e-4
    assert (runs[0][1].cpu() - want[1]).abs().max().item() <= 1e-3


def test_heads_on_the_card_match_the_cpu(card, monkeypatch):
    """The linear heads on the 480 x 752 token count and the DPT on its
    35 x 54 taps, then 1/depth resized to the 120 x 188 grid."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.manual_seed(0)
    seg, depth, dpt = SegHeadFlatten().eval(), DepthHeadFlatten(), DPTHead()
    x, tok = torch.randn(1890, 384), torch.randn(1890, 768)
    taps = [(torch.randn(1, 35, 54, 384), torch.randn(1, 384)) for _ in range(4)]
    with torch.no_grad():
        want = (seg(x), depth(tok), dpt(taps))
        for m in (seg, depth, dpt):
            m.to(card)
        got = (seg(x.to(card)), depth(tok.to(card)),
               dpt([(t.to(card), c.to(card)) for t, c in taps]))
        torch.cuda.synchronize()
    assert (got[0].cpu() - want[0]).abs().max().item() <= 1e-4
    assert torch.equal(got[0].argmax(-1).cpu(), want[0].argmax(-1))
    assert ((got[1].cpu() - want[1]).abs() / want[1].abs()).max().item() <= 1e-4
    assert got[2].shape == want[2].shape == (1, 1, 576, 864)
    assert (got[2].cpu() - want[2]).abs().max().item() <= 1e-4 * want[2].abs().max().item()
    disp_want = resize(1.0 / want[2], (120, 188))
    disp = resize(1.0 / got[2], (120, 188)).cpu()
    assert (disp - disp_want).abs().max().item() <= 1e-4 * disp_want.abs().max().item()


@pytest.mark.parametrize("strategy", ["RANDOM", "GRADIENT_BIAS"])
def test_dpvo_slam_on_the_card_matches_the_cpu(card, monkeypatch, strategy):
    """12 random 64 x 96 frames, KEYFRAME_THRESH=0 (no removal to flip)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_cfg().merge_from_file(Path(__file__).resolve().parents[1] / "config"
                                    / "default_dpvo.yaml")
    cfg.update(PATCHES_PER_FRAME=16, BUFFER_SIZE=32, MOTION_PROBE_THR=-1.0, KEYFRAME_THRESH=0.0,
               MIXED_PRECISION=False, CENTROID_SEL_STRAT=strategy)
    rng = np.random.RandomState(0)
    frames = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(12)]
    intr = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
    runs = {}
    for dev in ("cpu", card):
        slam = SLAM(cfg, "dpv", ht=64, wd=96, device=dev, seed=3)
        before = corr_cuda.LAUNCHES.count
        for f, img in enumerate(frames):
            slam(f, img, intr)
        poses, _ = slam.terminate()
        launches = corr_cuda.LAUNCHES.count - before
        runs[str(dev)] = (poses, slam.pg.patches_[: slam.n * 16, :2].cpu(), slam.stats, launches)
    (cp, cc, cs, cl), (gp, gc, gs, gl) = runs["cpu"], runs[str(card)]
    assert cl == 0 and gl == gs["updates"] == cs["updates"] > 0
    assert torch.equal(gc, cc)
    assert np.isfinite(gp).all() and np.abs(gp - cp).max() <= 1e-3
