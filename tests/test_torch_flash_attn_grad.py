"""DINO attention under autograd on the CPU, and the sums the training BA
differentiates through.

The plain backward written out by formula (``attention_qkv_backward_plain``,
what the card's backward kernels are held to) against autograd through
``attention_qkv_plain`` in float64: 1e-5 of max |gradient| (the formula
computes in float32) for float64 and float32 inputs; on CPU tensors ``flash_attention_qkv_grad`` is the plain version
under autograd; DINO's ``Attention`` takes the gradient path only when a
gradient is taken. ``SegmentPlan.sum`` (the BA's deterministic segment
sums, ``torch.segment_reduce``) has a backward: gradcheck in float64.
"""
import pytest
import torch

from cdvslam_tpu_torch.models import dinov2
from cdvslam_tpu_torch.ops import flash_attn
from cdvslam_tpu_torch.ops.scatter import SegmentPlan

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,L,heads", [(1, 1, 2), (2, 37, 2), (1, 65, 6)])
def test_plain_backward_formula_matches_autograd(dtype, B, L, heads):
    g = torch.Generator().manual_seed(L)
    qkv = torch.randn((B, L, 3 * 64 * heads), generator=g, dtype=torch.float64)
    dout = torch.randn((B, L, 64 * heads), generator=g, dtype=torch.float64)
    x = qkv.clone().requires_grad_(True)
    out = flash_attn.attention_qkv_plain(x, heads)
    out.backward(dout)
    lse = flash_attn.attention_lse_plain(qkv, heads)
    got = flash_attn.attention_qkv_backward_plain(qkv.to(dtype), out.detach().to(dtype),
                                                  lse, dout.to(dtype), heads)
    assert got.dtype == dtype and got.shape == qkv.shape
    assert (got.double() - x.grad).abs().max().item() <= 1e-5 * x.grad.abs().max().item()


def test_grad_path_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 30, 3 * 128), generator=g)
    w = torch.randn((2, 30, 128), generator=g)
    grads = []
    for fn in (flash_attn.flash_attention_qkv_grad, flash_attn.attention_qkv_plain):
        x = qkv.clone().requires_grad_(True)
        (fn(x, 2) * w).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(flash_attn.flash_attention_qkv(qkv, 2), flash_attn.attention_qkv_plain(qkv, 2))


def test_dino_attention_takes_the_gradient_path_only_with_a_gradient(monkeypatch):
    calls = []
    for name in ("flash_attention_qkv", "flash_attention_qkv_grad"):
        fn = getattr(dinov2, name)
        monkeypatch.setattr(dinov2, name,
                            lambda qkv, h, _fn=fn, _n=name: calls.append(_n) or _fn(qkv, h))
    torch.manual_seed(0)
    attn = dinov2.Attention(384, 6)
    x = torch.randn(1, 11, 384)
    with torch.no_grad():
        attn(x)
    attn(x).sum().backward()
    attn.requires_grad_(False)
    attn(x)
    assert calls == ["flash_attention_qkv", "flash_attention_qkv_grad", "flash_attention_qkv"]


def test_segment_sums_have_a_backward():
    g = torch.Generator().manual_seed(1)
    ids = torch.tensor([3, 0, 3, 1, 7, -1, 1, 3])          # 7 and -1 are dropped
    plan = SegmentPlan(ids, 4)
    vals = torch.randn((8, 2, 3), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(plan.sum, (vals,))
    up = torch.randn((4, 2, 3), generator=g, dtype=torch.float64)
    plan.sum(vals).backward(up)
    want = torch.where(((ids >= 0) & (ids < 4))[:, None, None], up[ids.clamp(0, 3)],
                       torch.zeros(()))
    assert torch.equal(vals.grad, want.double())
