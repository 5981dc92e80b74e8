"""The hand-written kernels against their plain versions on the card.

Marked ``cuda``: they skip on a host without a CUDA card (run them on the
card with ``python -m pytest tests/test_torch_cuda.py -q``; chip_smoke.py
runs the same comparisons at the main-path shapes). Tolerances: corr f32
1e-4 absolute (f32 dots of 24 or 128 products summed in another order); corr
bf16 5e-3 of max |plain| against the plain version evaluated in f32 on the
same bf16 values; flash attention bf16 max abs 2e-2 and relative Frobenius
1e-2 (bf16 probabilities against bf16 softmax then matmul); flash
attention float32 (three TF32 passes on the tensor cores; the plain
version with TF32 off) 1e-5 of max |plain| on the output and on the
log-sum-exp, two calls bitwise equal; the bf16 forward with the log-sum-exp as the
serving call, its log-sum-exp 1e-3 of max |plain|; the backward kernels
1e-4 of max |plain| in float32 and 1e-2 in bf16 (the plain backward in
float32 on the same values, from the plain output and log-sum-exp; the
kernels round dqkv to bf16), and two backward calls bitwise equal; the
float32 backward (three TF32 passes) also within 1e-5 of max |float64|
against the formula in float64 on the same values (the margin of the
float32 forward; CPU emulation: tests/test_torch_flash_attn_bwd_tf32.py);
global BA on
the card against the CPU port on the same float32 inputs 1e-4 on poses and
1e-3 on inverse depths (cuBLAS and the CPU sum in other orders), and two
solves on the card bitwise equal; the heads on the card against the CPU
port in float32 with TF32 off: seg logits 1e-4 with equal classes, linear
depth 1e-4 relative, DPT and its resize 1e-4 of max |CPU| (cuDNN and the
CPU sum the convolutions in other orders); the DPVO SLAM on the card in
float32 (TF32 off) against the CPU port on the same seeded weights and
frames: the same patch centres, one corr launch per update at C = 128, and
poses within 1e-3 per component (the encoders, the update operator and 16
BAs summed in other orders); the float32 "cdv" SLAM on the card against
the CPU port, the same rule (on a halved delta head); one training loss
and gradient on the card held to a float64 CPU run of the port: loss 1e-4
relative, each gradient leaf within 3x its own float32 noise plus 1e-3
(cuDNN, cuBLAS and the card's scatter-adds sum in other orders and the
damped BA solves amplify it); the segment sums' backward on the card
exactly (a gather); the segment-sum kernel bitwise equal to its plain
version on the CPU (the same order of summation) and, on rows of more
than one element, to ``SegmentPlan.sum`` on the card, which runs it,
within the worst-case rounding of its dtype of a float64 sum, and bitwise
repeatable, in and out of a CUDA graph; the BA iteration's two kernels
(``ops/ba_cuda.py``) bitwise equal to the plain chain they replace (signed
zeros and NaN included) at the three cells' edge counts, with masked
edges, depths behind the camera, residuals over 128 px, projections
outside the margin, NaN weights, depths past 20 and untouched patches,
and a whole ``ba_solve`` on them bitwise equal to the plain one and to the
benchmark's frozen copy, eagerly and in a CUDA graph replay; the Sim3 PGO at n = 200 on the card against the CPU,
both solving in float64, 1e-6 per component; the classical backend's
worker thread (its own stream) against the same close_loop inline, poses
and depths 1e-6; the data-parallel dry run on the card by its own rule
(``parallel/dryrun.py``).
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
from ba_cases import SHAPES, ba_case, solve_args, update_case
from segsum_cases import float64_sum, torch_case

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


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("B,L", [(1, 1), (1, 7), (1, 9), (1, 63), (1, 65), (1, 127), (1, 129),
                                 (2, 1000), (1, 1891), (3, 1611)])
def test_flash_attention_f32_matches_plain(card, monkeypatch, B, L):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn((B, L, 3 * 384), generator=g, device=card)
    before = flash_attn.LAUNCHES_F32.count
    got, lse = flash_attn._forward(qkv, 6, with_lse=True)
    assert flash_attn.LAUNCHES_F32.count == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, L, 384) and lse.shape == (B, 6, L)
    assert _rel(got, flash_attn.attention_qkv_plain(qkv, 6)) <= 1e-5
    assert _rel(lse, flash_attn.attention_lse_plain(qkv, 6)) <= 1e-5
    assert torch.equal(flash_attn.flash_attention_qkv(qkv, 6), got)   # no-LSE launch


def test_flash_attention_f32_is_repeatable_and_counted_once_per_call(card):
    """Two calls bitwise equal (no atomics; the pre-pass and the kernel are
    one wrapper call, counted once)."""
    g = torch.Generator(device=card).manual_seed(6)
    qkv = torch.randn((2, 777, 3 * 384), generator=g, device=card)
    before = flash_attn.LAUNCHES_F32.count
    first, lse1 = flash_attn._forward(qkv, 6, with_lse=True)
    assert flash_attn.LAUNCHES_F32.count == before + 1
    second, lse2 = flash_attn._forward(qkv, 6, with_lse=True)
    assert flash_attn.LAUNCHES_F32.count == before + 2
    assert torch.equal(first, second) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L", [(1, 1), (1, 63), (1, 65), (2, 1000), (1, 1891), (3, 1611)])
def test_flash_attention_backward_matches_plain(card, monkeypatch, dtype, B, L):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=card).manual_seed(4)
    qkv = torch.randn((B, L, 3 * 384), generator=g, device=card).to(dtype)
    dout = torch.randn((B, L, 384), generator=g, device=card).to(dtype)
    out, lse = flash_attn._forward(qkv, 6, with_lse=True)
    # the plain backward from the plain output (float32 on qkv's values) and LSE
    p_out = flash_attn.attention_qkv_plain(qkv.float(), 6)
    p_lse = flash_attn.attention_lse_plain(qkv, 6)
    if dtype == torch.bfloat16:   # the wgmma kernel's output and LSE, as in phase 2
        want_out = flash_attn.attention_qkv_plain(qkv, 6).float()
        assert (out.float() - want_out).abs().max().item() <= 2e-2
        assert ((out.float() - want_out).norm() / want_out.norm()).item() <= 1e-2
        assert _rel(lse, p_lse) <= 1e-3
    before = (flash_attn.LAUNCHES_DQ.count, flash_attn.LAUNCHES_DKV.count)
    got = flash_attn.flash_attention_qkv_backward(qkv, out, lse, dout, 6)
    again = flash_attn.flash_attention_qkv_backward(qkv, out, lse, dout, 6)
    assert (flash_attn.LAUNCHES_DQ.count, flash_attn.LAUNCHES_DKV.count) == (
        before[0] + 2, before[1] + 2)
    want = flash_attn.attention_qkv_backward_plain(qkv, p_out, p_lse, dout, 6)
    assert got.dtype == dtype and got.shape == qkv.shape
    assert torch.equal(got, again)
    assert _rel(got, want) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("B,L", [(3, 1611), (1, 65)])
def test_flash_attention_f32_backward_matches_float64(card, B, L):
    g = torch.Generator(device=card).manual_seed(7)
    qkv = torch.randn((B, L, 3 * 384), generator=g, device=card)
    dout = torch.randn((B, L, 384), generator=g, device=card)
    out, lse = flash_attn._forward(qkv, 6, with_lse=True)
    got = flash_attn.flash_attention_qkv_backward(qkv, out, lse, dout, 6)
    x = qkv.double()
    want = flash_attn.attention_qkv_backward_plain(
        x, flash_attn.attention_qkv_plain(x, 6), flash_attn.attention_lse_plain(x, 6),
        dout.double(), 6)
    assert want.dtype == torch.float64
    assert ((got.double() - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_flash_attention_autograd_matches_plain_autograd(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((2, 301, 3 * 384), generator=g, device=card)
    w = torch.randn((2, 301, 384), generator=g, device=card)
    grads = []
    for fn in (flash_attn.flash_attention_qkv_grad, flash_attn.attention_qkv_plain):
        qkv = x.clone().requires_grad_(True)
        (fn(qkv, 6) * w).sum().backward()
        grads.append(qkv.grad)
    assert _rel(grads[0], grads[1]) <= 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    qkv = torch.randn((1, 10, 3 * 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attn.flash_attention_qkv(qkv, 2)               # head dim 32
    with pytest.raises(ValueError):
        flash_attn.flash_attention_qkv(qkv.half(), 1)        # float16
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


def test_backward_wants_aligned_dout_and_autograd_copies_it(card):
    # the bf16 kernels read dout by TMA, the float32 ones by 16-byte copies
    g = torch.Generator(device=card).manual_seed(6)
    qkv = torch.randn((1, 65, 3 * 384), generator=g, device=card).to(torch.bfloat16)
    dout = torch.randn((1, 65, 384), generator=g, device=card).to(torch.bfloat16)
    out, lse = flash_attn._forward(qkv, 6, with_lse=True)
    odd = dout.new_empty(dout.numel() + 1)[1:].view(dout.shape).copy_(dout)   # 2-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attn.flash_attention_qkv_backward(qkv, out, lse, odd, 6)
    want = flash_attn.flash_attention_qkv_backward(qkv, out, lse, dout, 6)
    x = qkv.clone().requires_grad_(True)
    flash_attn.flash_attention_qkv_grad(x, 6).backward(odd)
    assert torch.equal(x.grad, want)


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


def test_float32_cdv_slam_on_the_card_matches_the_cpu(card, monkeypatch):
    """MIXED_PRECISION=False under "cdv" on the card (it was refused before
    DINO attention had a float32 kernel): 12 random 64 x 96 frames,
    KEYFRAME_THRESH=0, against the CPU port on the same seeded weights and
    frames: the same patch centres, 12 float32 K2 launches per frame and no
    bf16 one, poses within 1e-3 per component. The delta head is halved, as
    in the CPU parity harness (tests/torch_slam_pair.py): at full scale the
    random network drives depths into the BA's reset and the two runs drift
    2.6e-3 apart (measured on the card)."""
    from cdvslam_tpu_torch.models import CDVNet
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_cfg()
    cfg.update(PATCHES_PER_FRAME=16, BUFFER_SIZE=32, MOTION_PROBE_THR=-1.0, KEYFRAME_THRESH=0.0,
               MIXED_PRECISION=False)
    torch.manual_seed(3)
    state = CDVNet().state_dict()
    for k in ("update.d.1.weight", "update.d.1.bias"):
        state[k] = state[k] * 0.5
    rng = np.random.RandomState(0)
    frames = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(12)]
    intr = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
    runs = {}
    for dev in ("cpu", card):
        flash_attn.reset_counts()
        slam = SLAM(cfg, "cdv", ht=64, wd=96, device=dev, seed=3, state_dict=state)
        for f, img in enumerate(frames):
            slam(f, img, intr)
        poses, _ = slam.terminate()
        runs[str(dev)] = (poses, slam.pg.patches_[: slam.n * 16, :2].cpu(),
                          flash_attn.LAUNCHES_F32.count, flash_attn.LAUNCHES.count)
    (cp, cc, cf, cb), (gp, gc, gf, gb) = runs["cpu"], runs[str(card)]
    assert cf == cb == gb == 0 and gf == 12 * len(frames)
    assert torch.equal(gc, cc)
    assert np.isfinite(gp).all() and np.abs(gp - cp).max() <= 1e-3


def test_training_step_on_the_card_matches_the_cpu(card, monkeypatch):
    """One loss and gradient of the training rollout (F 4, M 4, 48 x 64,
    MIN_FRAME 3, 3 iterations), twice on the card, TF32 off, from the same
    seeded weights and draws as two CPU runs of the port, in float32 and
    float64. The card's loss within 1e-4 of the float64 one. Each leaf
    above 1e-6 of the largest (the others are analytically zero) is held to
    its own triangle: both card runs within 3x that leaf's float32 noise
    plus 1e-3 of its max |gradient| of the float64 run, the noise being the
    larger of the CPU float32 run's distance from float64 and the two card
    runs' distance from each other. The damped BA solves amplify float32
    rounding (to 1.4e-2 to 4.3e-2 of a leaf between the CPU's float32 and
    float64 runs, by the host's torch), and the card's scatter-adds sum in an order that changes from
    run to run (two card runs measured 2.6e-3 and 1.2e-2 from the CPU
    float32 run on one leaf). DINO's attention runs the float32 forward 24
    times (the checkpointed extractor runs twice) and each backward kernel
    12 times."""
    from cdvslam_tpu_torch.models import CDVNet
    from cdvslam_tpu_torch.train import RolloutConfig, draw, make_loss_fn, trainable
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = RolloutConfig(F=4, M=4, STEPS=3, MIN_FRAME=3, is_cdv=True)
    rng = np.random.RandomState(0)
    batch = {"images": torch.from_numpy((rng.rand(1, 4, 48, 64, 3) * 255).astype(np.float32)),
             "poses": torch.tensor([0, 0, 0, 0, 0, 0, 1.0]).repeat(1, 4, 1),
             "disps": torch.ones(1, 4, 12, 16),
             "intrinsics": torch.tensor([[60.0, 60.0, 32.0, 24.0]])}
    draws = [draw(cfg, 48, 64, torch.Generator().manual_seed(4))]
    res = {}
    for name, dev, dtype in (("cpu64", "cpu", torch.float64), ("cpu32", "cpu", torch.float32),
                             ("card", card, torch.float32), ("card2", card, torch.float32)):
        flash_attn.reset_counts()
        torch.manual_seed(0)
        model = CDVNet().to(dev, dtype).eval()
        leaves = trainable(model)
        loss, _ = make_loss_fn(model, cfg)({k: v.to(dev, dtype) for k, v in batch.items()},
                                           draws=draws)
        loss.backward()
        res[name] = (loss.item(), {k: t.grad.double().cpu() for k, t in leaves.items()},
                     (flash_attn.LAUNCHES_F32.count, flash_attn.LAUNCHES_DQ.count,
                      flash_attn.LAUNCHES_DKV.count))
    (l64, g64, _), (_, g32, n32) = res["cpu64"], res["cpu32"]
    (lg, gg, ng), (lg2, gg2, ng2) = res["card"], res["card2"]
    assert n32 == (0, 0, 0) and ng == ng2 == (24, 12, 12)
    for loss in (lg, lg2):
        assert np.isfinite(loss) and abs(loss - l64) <= 1e-4 * abs(l64)
    top = max(g.abs().max().item() for g in g64.values())
    bad = {}
    for k, g in g64.items():
        scale = g.abs().max().item()
        if scale < 1e-6 * top:
            continue
        d32, d1, d2, spread = ((a - b).abs().max().item() / scale for a, b in (
            (g32[k], g), (gg[k], g), (gg2[k], g), (gg[k], gg2[k])))
        if max(d1, d2) > 3 * max(d32, spread) + 1e-3:
            bad[k] = (d32, d1, d2, spread)
    assert not bad, bad


def test_segment_sums_backward_on_the_card(card):
    from cdvslam_tpu_torch.ops.scatter import SegmentPlan
    ids = torch.tensor([3, 0, 3, 1, 7, -1, 1, 3], device=card)
    plan = SegmentPlan(ids, 4)
    vals = torch.randn((8, 2, 3), device=card, requires_grad=True)
    up = torch.randn((4, 2, 3), device=card)
    plan.sum(vals).backward(up)
    want = torch.where(((ids >= 0) & (ids < 4))[:, None, None], up[ids.clamp(0, 3)],
                       torch.zeros((), device=card))
    assert torch.equal(vals.grad, want)


# (n, row shape, segments, dtype, ids): the BA's plans (plan_v, plan_b,
# plan_k, plan_e and a 36-wide sum), SoftAgg's sums (agg_kk, agg_ij), the
# PGO's float64 blocks at n = 200, zero rows; "long" segments span hundreds
# of chunks, "spread" ids hold dropped, out-of-range and empty segments
CARD_SEGMENT_CASES = [
    (20480, (6,), 16, np.float32, "long"),
    (40960, (6, 6), 256, np.float32, "ba"),
    (10240, (), 2688, np.float32, "spread"),
    (20480, (6,), 43008, np.float32, "spread"),
    (40960, (36,), 256, np.float32, "long"),
    (10240, (384,), 2688, np.float32, "spread"),
    (10240, (384,), 10240, np.float32, "spread"),
    (1000, (7, 7), 40000, np.float64, "spread"),
    (500, (7,), 200, np.float64, "long"),
    (0, (6,), 16, np.float32, "spread"),
]


@pytest.mark.parametrize("n, shape, S, dtype, ids", CARD_SEGMENT_CASES)
def test_segment_sum_kernel_on_the_card(card, n, shape, S, dtype, ids):
    """One launch a call; the plain version's bits (its serial order) on
    the CPU and, on rows of more than one element, ``SegmentPlan.sum``'s
    on the card, one launch too; 1-D rows it leaves to
    torch.segment_reduce (CUB's tree), with no launch."""
    from cdvslam_tpu_torch.ops import segsum_cuda
    from cdvslam_tpu_torch.ops.scatter import SegmentPlan
    seg, vals, ids_t, vals_t = torch_case(n, shape, S, dtype, ids, seed=n + S, device=card)
    plan = SegmentPlan(ids_t, S)
    before = segsum_cuda.LAUNCHES.count
    a, b = segsum_cuda.segment_sum(vals_t, plan), segsum_cuda.segment_sum(vals_t, plan)
    torch.cuda.synchronize()
    assert segsum_cuda.LAUNCHES.count - before == 2
    assert torch.equal(a, b) and a.dtype == vals_t.dtype and a.shape == (S, *shape)
    plain = SegmentPlan(torch.from_numpy(seg), S).sum(torch.from_numpy(vals))
    assert torch.equal(a.cpu(), plain)
    if len(shape):
        assert torch.equal(plan.sum(vals_t), a)
    else:
        plan.sum(vals_t)
    assert segsum_cuda.LAUNCHES.count - before == 2 + (len(shape) > 0)
    ref, bound = float64_sum(seg, vals, S)
    assert np.all(np.abs(a.cpu().numpy() - ref) <= bound)


def test_segment_sum_kernel_in_a_graph_replay(card):
    """Plan and sum captured together, as in the steady frame: one launch
    counted at the capture, each replay bitwise equal to the eager call,
    on the captured buffers' new values too."""
    from cdvslam_tpu_torch.ops import segsum_cuda
    from cdvslam_tpu_torch.ops.scatter import SegmentPlan
    _, _, ids_t, vals_t = torch_case(40960, (6, 6), 256, np.float32, "ba", 3, device=card)
    ids_in, vals_in = ids_t.clone(), vals_t.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        SegmentPlan(ids_in, 256).sum(vals_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = segsum_cuda.LAUNCHES.count
    with torch.cuda.graph(graph):
        out = SegmentPlan(ids_in, 256).sum(vals_in)
    assert segsum_cuda.LAUNCHES.count - before == 1
    for scale in (1.0, 1.0, -3.0):
        vals_in.copy_(vals_t * scale)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, SegmentPlan(ids_t, 256).sum(vals_t * scale)), scale


def _bits(a, b):
    """Equal bit for bit: signed zeros and NaN payloads included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def _lin_args(case):
    from cdvslam_tpu_torch.ba.ba import INFERENCE_PARAMS
    return (*(case[k] for k in ("poses", "patches", "intrinsics", "target", "weight", "ii", "jj",
                                "kk", "mask")), INFERENCE_PARAMS)


@pytest.mark.parametrize("edge_cases", [False, True], ids=["plain", "edge_cases"])
@pytest.mark.parametrize("cell", list(SHAPES))
def test_ba_linearize_is_the_plain_chain(card, cell, edge_cases):
    """Every row the sums read (the pose blocks, the pose-depth and gradient
    rows, C and u) bitwise the plain chain's, one launch, and a second call
    the same bits."""
    from cdvslam_tpu_torch.ba.ba import _linearize
    from cdvslam_tpu_torch.ops import ba_cuda
    case = ba_case(card, E_pad=SHAPES[cell], edge_cases=edge_cases, nan_weight=edge_cases,
                   seed=SHAPES[cell] + edge_cases)
    before = ba_cuda.LAUNCHES.count
    got, again = ba_cuda.linearize(*_lin_args(case)), ba_cuda.linearize(*_lin_args(case))
    assert ba_cuda.LAUNCHES.count - before == 2
    want = _linearize(*_lin_args(case), None)
    assert all(_bits(a, b) for a, b in zip(got, want))
    assert all(_bits(a, b) for a, b in zip(got, again))
    assert bool(want[3].isnan().any()) == edge_cases     # the NaN weights reach C


@pytest.mark.parametrize("past_end", [0, 3])
@pytest.mark.parametrize("cell", list(SHAPES))
def test_ba_update_is_the_plain_step(card, cell, past_end):
    """The retracted window (zero, small-angle and large steps; window rows
    past the buffer dropped) and the depth step (reset above 20, floor at
    1e-4, untouched patches kept), bitwise the plain step's, new tensors,
    one launch a call; with no dX (``structure_only``) the poses are the
    input tensor itself."""
    from cdvslam_tpu_torch.ba.ba import INFERENCE_PARAMS, _update
    from cdvslam_tpu_torch.ops import ba_cuda
    case = ba_case(card, E_pad=SHAPES[cell], seed=3, past_end=past_end)
    dX, dZ, touched, win_rows = update_case(case)
    poses, patches = case["poses"].clone(), case["patches"].clone()
    before = ba_cuda.LAUNCHES.count
    for step in (dX, None):
        got = ba_cuda.update(poses, patches, step, dZ, touched, win_rows)
        want = _update(poses, patches, step, dZ, touched, win_rows, INFERENCE_PARAMS)
        assert all(_bits(a, b) for a, b in zip(got, want))
        assert got[1].data_ptr() != patches.data_ptr()
        assert (got[0] is poses) == (step is None)
        assert _bits(ba_cuda.update(poses, patches, step, dZ, touched, win_rows)[1], got[1])
    assert ba_cuda.LAUNCHES.count - before == 4
    assert torch.equal(poses, case["poses"]) and torch.equal(patches, case["patches"])
    assert not torch.equal(want[1], patches)


@pytest.mark.parametrize("structure_only", [False, True], ids=["poses", "structure_only"])
@pytest.mark.parametrize("cell", list(SHAPES))
def test_ba_solve_on_the_kernels_is_the_plain_solve(card, monkeypatch, cell, structure_only):
    """A whole two-iteration solve on the kernels (two launches an
    iteration; with structure_only the update skips its pose half) bitwise
    equal to the plain chain and to the benchmark's frozen copy, eagerly
    and in a CUDA graph replay (on the captured buffers' new values too)."""
    from cdvslam_tpu_torch.ba import ba as bamod
    from cdvslam_tpu_torch.ops import ba_cuda
    from portbench.ref.ba import ba as frozen
    case = ba_case(card, E_pad=SHAPES[cell], seed=7)
    args, kw = solve_args(case)
    kw["structure_only"] = structure_only
    before = ba_cuda.LAUNCHES.count
    got = bamod.ba_solve(*args, **kw)
    assert ba_cuda.LAUNCHES.count - before == 4
    want = frozen.ba_solve(*args, **kw)
    with monkeypatch.context() as m:
        m.setattr(bamod, "_on_kernels", lambda *a: False)
        plain = bamod.ba_solve(*args, **kw)
    assert ba_cuda.LAUNCHES.count - before == 4
    assert all(_bits(a, b) and _bits(a, c) for a, b, c in zip(got, plain, want))
    assert not torch.equal(got[1], case["patches"])
    assert torch.equal(got[0], case["poses"]) == structure_only

    inputs = [a.clone() if torch.is_tensor(a) else a for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bamod.ba_solve(*inputs, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ba_cuda.LAUNCHES.count
    with torch.cuda.graph(graph):
        out = bamod.ba_solve(*inputs, **kw)
    assert ba_cuda.LAUNCHES.count - before == 4
    other = ba_case(card, E_pad=SHAPES[cell], seed=8)
    for src in (case, other, case):
        a, _ = solve_args(src)
        for buf, val in zip(inputs, a):
            if torch.is_tensor(buf):
                buf.copy_(val)
        graph.replay()
        torch.cuda.synchronize()
        want = frozen.ba_solve(*a, **kw)
        assert all(_bits(x, y) for x, y in zip(out, want))


def test_ba_solve_keeps_the_plain_chain_off_its_kernels(card):
    """float64, autograd, the training numerics and ``bounds`` run the plain
    chain on the card too: no launch; the same inputs that require grad
    run the kernels under no_grad; the wrappers refuse CUDA float64."""
    from cdvslam_tpu_torch.ba import ba as bamod
    from cdvslam_tpu_torch.ops import ba_cuda
    case = ba_case(card, E_pad=2048, E=1900, seed=5)
    args, kw = solve_args(case)
    a64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)
    grad = (args[0].clone().requires_grad_(), *args[1:])
    before = ba_cuda.LAUNCHES.count
    assert bamod.ba_solve(*a64, **kw)[0].dtype == torch.float64
    bamod.ba_solve(*grad, **kw)[0].sum().backward()
    bamod.ba_solve(*args, **kw, params=bamod.TRAINING_PARAMS)
    bamod.ba_solve(*args, **kw, bounds=(0.0, 0.0, 188.0, 120.0))
    assert ba_cuda.LAUNCHES.count == before and grad[0].grad is not None
    with torch.no_grad():
        bamod.ba_solve(*grad, **kw)
    assert ba_cuda.LAUNCHES.count - before == 4
    with pytest.raises(ValueError, match="CUDA float32"):
        ba_cuda.linearize(*_lin_args({k: a64[i] for i, k in enumerate(
            ("poses", "patches", "intrinsics", "target", "weight", "ii", "jj", "kk", "mask"))}))
    dX, dZ, touched, win_rows = update_case(case)
    with pytest.raises(ValueError, match="CUDA float32"):
        ba_cuda.update(a64[0], a64[1], dX.double(), dZ.double(), touched, win_rows)


def _pgo_ring(n=200, seed=0, noise=0.01):
    """A closed n-keyframe ring (world->cam, float64), its drifted estimate
    and two loop edges measured on the truth."""
    from cdvslam_tpu_torch.lie import se3_inv, se3_to_sim3, sim3_inv, sim3_mul
    rng = np.random.RandomState(seed)
    th = 2 * np.pi * np.arange(n) / n
    xi = np.stack([np.sin(th), 0.1 * np.sin(2 * th), 1 - np.cos(th), 0 * th, th, 0 * th], 1)
    gt = se3_exp(torch.tensor(xi, dtype=torch.float64))
    est = [gt[0]]
    for i in range(1, n):
        rel = se3_mul(gt[i], se3_inv(gt[i - 1]))
        est.append(se3_mul(se3_mul(se3_exp(torch.tensor(noise * rng.randn(6))), rel), est[-1]))
    G = se3_to_sim3(gt)
    pairs = [(n - 1, 0), (3 * n // 4, n // 8)]
    C = torch.stack([sim3_mul(G[j], sim3_inv(G[i])) for i, j in pairs])
    return torch.stack(est), C, np.array([i for i, _ in pairs]), np.array([j for _, j in pairs])


def test_run_pgo_on_the_card_matches_the_cpu_float64(card):
    """The Sim3 PGO at n = 200 on the SLAM's float32 poses: on the card and
    on the CPU it solves in float64 (only the sums' order differs), within
    1e-6 per component."""
    from cdvslam_tpu_torch.ba.pgo import run_pgo
    est, C, ii, jj = _pgo_ring()
    est, C = est.float(), C.float()
    safe_c, out_c = run_pgo(est.to(card), C.to(card), ii, jj)
    safe_h, out_h = run_pgo(est, C, ii, jj)
    assert safe_c == safe_h == 200 and out_c.dtype == torch.float64
    assert float((out_c.cpu() - out_h).abs().max()) <= 1e-6


def test_classic_worker_thread_matches_inline_on_the_card(card):
    """close_loop on a rendered 64-keyframe state (chip_smoke.classic_state):
    the PGO in the worker thread on its own stream (no CLASSIC_LOOP_SYNC),
    applied once the backend's terminate() has joined it, against the same
    call inline; poses and depths within 1e-6."""
    import chip_smoke
    n, loop = 64, (49, 5)
    results = {}
    for sync in (True, False):
        cfg = get_cfg()
        cfg.PATCHES_PER_FRAME = 8
        cfg.BUFFER_SIZE = 96
        cfg.CLASSIC_LOOP_CLOSURE = True
        cfg.CLASSIC_LOOP_SYNC = sync
        slam = SLAM(cfg, "dpv", ht=64, wd=64)
        chip_smoke.fill_classic_state(slam, chip_smoke.classic_state(
            n, 8, 480, 752, chip_smoke.EUROC_INTR, loop))
        lc = slam.long_term_lc
        lc.close_loop(*loop)
        if sync:
            lc.lc_callback()
        else:
            assert lc.worker is not None
            lc.terminate(slam.pg.n)
            assert not lc.worker.is_alive() and lc.stream is not None
        assert slam.stats["lc_applied"] == 1, getattr(lc, "_fail", None)
        results[sync] = (slam.pg.poses_[:n].clone(), slam.pg.patches_[: n * 8, 2].clone())
    for a, b in zip(results[True], results[False]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_colors_timing_and_viewer_on_the_card(card, monkeypatch):
    """The entry-point hooks on the card, on the float32 setting of
    ``test_float32_cdv_slam_on_the_card_matches_the_cpu``: the patch colours
    (gathered on the card every frame, shifted on removal) within one uint8
    level of the CPU run's, ``points()`` finite with one row per kept
    patch, the frame's phases timed by the tracer (``utils.trace``: every
    frame one ``frame`` span, its insert alone as ``insert`` before the
    initialization, after it ``keyframe`` and the graph replay's
    ``launch`` or ``capture``; on the device one stamped row per insert,
    graph replay and eager update, their stages in stamp order, no row
    lost), and the web viewer's ``state.json`` served over loopback from
    the card's buffers."""
    import json
    import urllib.request
    from cdvslam_tpu_torch.models import CDVNet
    from cdvslam_tpu_torch.utils import trace
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_cfg()
    cfg.update(PATCHES_PER_FRAME=16, BUFFER_SIZE=32, MOTION_PROBE_THR=-1.0, MIXED_PRECISION=False)
    torch.manual_seed(3)
    state = CDVNet().state_dict()
    rng = np.random.RandomState(0)
    frames = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(12)]
    intr = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
    colors = {}
    for dev in ("cpu", card):
        on_card = dev != "cpu"
        slam = SLAM(cfg, "cdv", ht=64, wd=96, device=dev, seed=3, state_dict=state,
                    viz=on_card, viewer_port=0)
        for f, img in enumerate(frames):
            slam(f, img, intr)
        if on_card:
            slam.viewer.refresh()
            url = f"http://127.0.0.1:{slam.viewer.port}/state.json"
            served = json.loads(urllib.request.urlopen(url, timeout=10).read())
            assert served["n"] == slam.n and len(served["points"]) > 0
        slam.terminate()
        pts = slam.points()
        assert pts.shape == (slam.m, 3) and np.isfinite(pts).all()
        colors[str(dev)] = slam.pg.colors_[: slam.n].astype(int)
        assert slam.stats["keyframe_removals"] > 0
    assert np.abs(colors["cpu"] - colors[str(card)]).max() <= 1
    rec = slam.trace
    assert rec.device.startswith("cuda") and rec.ended and rec.lost_rows == 0
    tot = rec.totals
    assert tot["frame"][0] == len(frames) and tot["insert"][0] == 8
    assert tot["keyframe"][0] == len(frames) - 8
    assert tot.get("launch", [0])[0] + tot.get("capture", [0])[0] == len(frames) - 8
    assert all(v[1] > 0 for v in tot.values())
    rows = trace.raw_rows(rec)
    kinds = [r.kind for r in rows]
    assert kinds.count("insert") == 8 and kinds.count("replay") == len(frames) - 8
    assert kinds.count("update") == 24
    for r in rows:
        assert min(r.stages.values()) >= 0 and r.end_ns > r.start_ns
        assert r.kind == "update" or r.stages["features"] > 0


def test_dry_run_on_the_card(card, tmp_path):
    """``python -m cdvslam_tpu_torch.parallel.dryrun 2`` with its default
    device: two gloo processes sharing the card against two single
    processes, the dry run's own tolerance (1e-5 of each leaf's max
    |gradient| and 1e-6 of the loss, plus three times the two single runs'
    distance, which the card's scatter-adds make nonzero)."""
    from cdvslam_tpu_torch.parallel import dryrun
    assert dryrun.run(2, workdir=tmp_path) == 0
    a = torch.load(tmp_path / "single.pt")
    assert sum(g.abs().max().item() > 0 for g in a["grads"].values()) > 0.9 * len(a["grads"])


def test_prefetch_from_a_reader_thread_on_the_card(card):
    """``SLAM.prefetch`` on the card from a reader thread: each frame's
    upload on the upload stream arrives bitwise, and the same frames give
    bitwise the poses of plain calls (the float32 "cdv" SLAM); the
    tracer's device rows record one stamped upload per frame, prefetched
    or not as it was."""
    from cdvslam_tpu_torch.utils import trace
    import queue
    import threading
    rng = np.random.RandomState(0)
    frames = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(12)]
    intr = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
    cfg = get_cfg()
    cfg.PATCHES_PER_FRAME, cfg.BUFFER_SIZE = 8, 32
    cfg.MOTION_PROBE_THR, cfg.MIXED_PRECISION = -1.0, False
    runs = []
    for prefetch in (False, True):
        slam = SLAM(cfg, "cdv", ht=64, wd=96, device=card, seed=0)
        q = queue.Queue(maxsize=2)

        def reader():
            for img in frames:
                if prefetch:
                    slam.prefetch(img)
                q.put(img)

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        for f in range(len(frames)):
            img = q.get(timeout=60)
            if prefetch:
                _, frame, ready = slam._prefetched[id(img)]
                ready.synchronize()
                assert torch.equal(frame.cpu(), torch.from_numpy(img))
            slam(f, img, intr)
        th.join(timeout=60)
        assert not th.is_alive()
        assert not slam._prefetched
        runs.append(slam.terminate()[0])
        rows = [r for r in trace.raw_rows(slam.trace) if r.kind != "update"]
        assert [r.prefetched for r in rows] == [prefetch] * len(frames)
        assert all(r.stages["upload"] >= 0 for r in rows)
    assert np.array_equal(runs[0], runs[1])


def test_stamps_inside_the_replay_on_the_card(card):
    """The tracer's device stamps on the card (``utils.trace``,
    ``csrc/trace.cu``): each steady frame's graph replay writes one row in
    stamp order, read without a synchronisation of its own and none lost;
    the device timer's offset from the host clock within 20 us and its
    resolution at most 1 us; and per steady replay the stages' sum (first
    to last stamp) within 5% plus 20 us of the device time CUDA events
    measure around the replay. The stamp kernel counts under its own
    launch counter, never under K1's."""
    from cdvslam_tpu_torch.ops import stamp
    from cdvslam_tpu_torch.slam import fused
    from cdvslam_tpu_torch.utils import trace
    cfg = get_cfg()
    cfg.update(PATCHES_PER_FRAME=16, BUFFER_SIZE=64, MOTION_PROBE_THR=-1.0)
    rng = np.random.RandomState(0)
    frames = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(40)]
    intr = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
    slam = SLAM(cfg, "cdv", ht=64, wd=96, device=card, seed=0)
    timed, replay = [], fused.FusedStep.replay

    def evented(step, g):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        replay(step, g)
        b.record()
        timed.append((step.slam.pg.counter - 1, a, b))

    corr0, stamps0 = corr_cuda.LAUNCHES.count, stamp.LAUNCHES.count
    fused.FusedStep.replay = evented
    try:
        for f, img in enumerate(frames):
            slam(f, img, intr)
    finally:
        fused.FusedStep.replay = replay
    slam.terminate()
    rec = slam.trace
    assert corr_cuda.LAUNCHES.count - corr0 == slam.stats["updates"]
    assert stamp.LAUNCHES.count - stamps0 >= 6 * len(timed)
    assert rec.lost_rows == 0 and rec.clock["error_ns"] <= 20_000
    assert 0 < rec.clock["resolution_ns"] <= 1000
    rows = {r.frame: r for r in trace.raw_rows(rec, "replay")}
    assert len(rows) == len(timed) == len(frames) - 8
    steady = [(f, a.elapsed_time(b) * 1e6) for f, a, b in timed if rows[f].steady]
    assert len(steady) >= 20 and rec.replay[0] == len(steady)
    for f, ev_ns in steady:
        row = rows[f]
        order = [row.stages[k] for k in ("shift", "features", "patches", "update", "ba")]
        assert min(order) >= 0 and sum(order) == row.end_ns - row.start_ns
        assert abs((row.end_ns - row.start_ns) - ev_ns) <= 0.05 * ev_ns + 20_000, (f, ev_ns)
    assert rec.gap[0] > 0 and all(v[1] >= 0 for v in rec.gaps.values())
