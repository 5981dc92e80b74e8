"""DINO attention's backward by formula, on the CPU.

(a) The formula the card's backward kernels are held to
(``attention_qkv_backward_plain``), chained by hand through the block's
qkv and proj linears, against ``jax.vjp`` of the JAX package's DINO
``Attention`` with respect to x (on the CPU it takes the einsum branch,
the plain reference of the library flash-attention kernels), on the same
weights (carried as ``convert_dino`` carries them: Dense kernel =
weight.T): float32, 6 heads of 64, dx within 1e-4 of max |dx|.

(b) The rounding budget of the bf16 backward kernels: the formula with P
and dS rounded to bf16 before the three products (dV = P^T dO, dK = dS^T Q,
dQ = dS K), as the TPU kernels round them (``p.T.astype(do.dtype)``,
``ds.T.astype(do.dtype)``, ``ds.astype(k.dtype)`` in
``jax/experimental/pallas/ops/tpu/flash_attention.py``), stays within the
1e-2 of max |plain| that the card holds the bf16 kernels to. Measured on
bf16 qkv and dout with both results rounded to bf16 as the kernels' are:
5.1e-3 of max |plain| at (1, 65) and 2.9e-3 at (1, 600), so the rounding
takes a half to a third of the budget (the card measures the kernels at
5.7e-3 at worst, L 63 and 65).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.models.dinov2 import Attention as JaxAttention
from cdvslam_tpu_torch.models import dinov2
from cdvslam_tpu_torch.ops import flash_attn

torch.set_num_threads(2)
HEADS, DIM = 6, 384


def _port_dx(attn, x, g):
    """dx of the port's block by hand: the linears' transposes around the
    formula backward of the attention."""
    wq, bq = attn.qkv.weight.detach(), attn.qkv.bias.detach()
    wp = attn.proj.weight.detach()
    qkv = x @ wq.T + bq
    out = flash_attn.attention_qkv_plain(qkv, HEADS)
    lse = flash_attn.attention_lse_plain(qkv, HEADS)
    dout = g @ wp
    dqkv = flash_attn.attention_qkv_backward_plain(qkv, out, lse, dout, HEADS)
    return dqkv @ wq


@pytest.mark.parametrize("L", [1, 65, 600])
def test_formula_backward_matches_jax_vjp_of_dino_attention(L):
    rng = np.random.RandomState(L)
    torch.manual_seed(L)
    attn = dinov2.Attention(DIM, HEADS)
    x = rng.randn(1, L, DIM).astype(np.float32)
    g = rng.randn(1, L, DIM).astype(np.float32)
    params = {name: {"kernel": getattr(attn, name).weight.detach().numpy().T,
                     "bias": getattr(attn, name).bias.detach().numpy()}
              for name in ("qkv", "proj")}
    module = JaxAttention(DIM, HEADS)
    _, vjp = jax.vjp(lambda xx: module.apply({"params": params}, xx), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _port_dx(attn, torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert got.shape == want.shape == (1, L, DIM)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _backward_rounded(qkv, out, lse, dout, heads):
    """``attention_qkv_backward_plain`` with P and dS rounded to bf16 before
    the products, as the bf16 kernels feed them to the tensor cores."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    s = d ** -0.5
    bf = lambda t: t.to(torch.bfloat16).float()   # noqa: E731
    q, k, v = qkv.float().reshape(B, L, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    o = out.float().reshape(B, L, heads, d).transpose(1, 2)
    do = dout.float().reshape(B, L, heads, d).transpose(1, 2)
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * s - lse.float()[..., None])
    dv = torch.matmul(bf(p).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = bf(p * (dp - (do * o).sum(-1, keepdim=True)))
    dq = torch.matmul(ds, k) * s
    dk = torch.matmul(ds.transpose(-1, -2), q) * s
    dqkv = torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(B, L, C3).to(qkv.dtype)


@pytest.mark.parametrize("L", [65, 600])
def test_bf16_operand_rounding_stays_inside_the_card_tolerance(L):
    rng = np.random.RandomState(100 + L)
    qkv = torch.from_numpy(rng.randn(1, L, 3 * DIM).astype(np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(rng.randn(1, L, DIM).astype(np.float32)).to(torch.bfloat16)
    out = flash_attn.attention_qkv_plain(qkv.float(), HEADS)
    lse = flash_attn.attention_lse_plain(qkv, HEADS)
    plain = flash_attn.attention_qkv_backward_plain(qkv, out, lse, dout, HEADS)
    rounded = _backward_rounded(qkv, out, lse, dout, HEADS)
    assert plain.dtype == rounded.dtype == torch.bfloat16
    err = (rounded.float() - plain.float()).abs().max().item()
    assert err <= 1e-2 * plain.float().abs().max().item()
    assert err > 0                                      # the rounding is there
