"""DINO attention: the CUDA kernels ``csrc/flash_attn.cu`` and their wrappers.

``flash_attention_qkv(qkv, heads)`` computes softmax(q k^T * d^-1/2) v per
head, reading q, k and v from the packed ``qkv`` projection (B, L, 3 C),
laid out (B, L, 3, heads, d), and returns (B, L, C). On CPU tensors it
returns ``attention_qkv_plain`` (the JAX package's einsum branch,
``cdvslam_tpu/models/dinov2.py`` Attention); on CUDA tensors it launches
the kernel for qkv's type (bf16: the wgmma kernel; float32: three TF32
passes on wgmma, after a pre-pass that splits q, k and v) or raises.

``flash_attention_qkv_grad(qkv, heads)`` is the same function under
autograd: on the card a ``torch.autograd.Function`` whose forward launches
the kernel with the per-row log-sum-exp saved and whose backward launches
the two backward kernels (dQ, then dK and dV; bf16 on wgmma, float32 in
three TF32 passes on wgmma after a pre-pass, launched by the dQ call, that
splits q, k, v and dout and transposes q, k and dout into a scratch the
dK/dV call reads too) and returns the gradient packed as (B, L, 3 C); on
CPU tensors ``attention_qkv_plain`` under autograd.
``attention_qkv_backward_plain`` is the backward written out by formula,
for the checks on the card.

Launch counts: ``LAUNCHES`` (bf16 forward), ``LAUNCHES_F32`` (float32
forward), ``LAUNCHES_DQ`` and ``LAUNCHES_DKV`` (the backward kernels).
"""
from __future__ import annotations

import torch

from . import native

LAUNCHES = native.LaunchCounter("flash_attn")
LAUNCHES_F32 = native.LaunchCounter("flash_attn_f32")
LAUNCHES_DQ = native.LaunchCounter("flash_attn_bwd_dq")
LAUNCHES_DKV = native.LaunchCounter("flash_attn_bwd_dkv")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_qkv_plain(qkv, heads: int):
    """qkv (B, L, 3 C) -> (B, L, C), in qkv's dtype."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    q, k, v = qkv.reshape(B, L, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    attn = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v).transpose(1, 2).reshape(B, L, C)


def _compute_type(x):
    """float64 for float64 inputs, else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def attention_qkv_backward_plain(qkv, out, lse, dout, heads: int):
    """The gradient of ``attention_qkv_plain`` with respect to qkv, by formula,
    in float32 (float64 for a float64 qkv): P = exp(q k^T s - lse),
    dV = P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P (dP - D),
    dQ = s dS K, dK = s dS^T Q, with s = d^-1/2. qkv (B, L, 3 C), out and
    dout (B, L, C), lse (B, heads, L) -> dqkv (B, L, 3 C) in qkv's dtype."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    s = d ** -0.5
    ct = _compute_type(qkv)
    q, k, v = qkv.to(ct).reshape(B, L, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    o = out.to(ct).reshape(B, L, heads, d).transpose(1, 2)
    do = dout.to(ct).reshape(B, L, heads, d).transpose(1, 2)
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * s - lse.to(ct)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * s
    dk = torch.matmul(ds.transpose(-1, -2), q) * s
    dqkv = torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4)      # (B, L, 3, h, d)
    return dqkv.reshape(B, L, C3).to(qkv.dtype)


def attention_lse_plain(qkv, heads: int):
    """The per-row log-sum-exp of the scaled scores, (B, heads, L), in
    float32 (float64 for a float64 qkv)."""
    B, L, C3 = qkv.shape
    d = C3 // 3 // heads
    q, k, _ = qkv.to(_compute_type(qkv)).reshape(B, L, 3, heads, d).permute(
        2, 0, 3, 1, 4).unbind(0)
    return torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5), dim=-1)


def _check(qkv, heads):
    if not qkv.is_cuda:
        raise ValueError("flash_attention_qkv: qkv must be a CPU or CUDA tensor")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError("flash_attention_qkv: qkv must be (B, L, 3 C) with heads | C")
    if (qkv.shape[-1] // 3) // heads != 64:
        raise ValueError("flash_attention_qkv: the kernels are built for head dim 64")
    if qkv.dtype not in _DTYPES:
        raise ValueError("flash_attention_qkv: the kernels take bfloat16 or float32")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be contiguous and 16-byte aligned")


def _forward(qkv, heads: int, with_lse: bool):
    """(out, lse or None) from the forward kernel of qkv's type."""
    _check(qkv, heads)
    B, L, C3 = qkv.shape
    out = torch.empty((B, L, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((B, heads, L), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    if B * L == 0:
        return out, lse
    lib = native.load("flash_attn")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    scale = float(64 ** -0.5)
    if qkv.dtype == torch.float32:
        # the pre-pass's scratch: Q, K and V^T split into TF32 hi and lo parts
        rows = lib.flash_attn_f32_rows(L)
        ws = torch.empty(6 * B * heads * rows * 64, dtype=torch.float32, device=qkv.device)
        err = lib.flash_attn_qkv_forward_f32(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
            ws.data_ptr(), B, L, heads, scale, stream)
        native.check(err, "flash_attn_qkv_forward_f32")
        LAUNCHES_F32.count += 1
    elif with_lse:
        err = lib.flash_attn_qkv_forward_lse(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                             B, L, heads, scale, stream)
        native.check(err, "flash_attn_qkv_forward_lse")
        LAUNCHES.count += 1
    else:
        err = lib.flash_attn_qkv_forward(qkv.data_ptr(), out.data_ptr(), B, L, heads, scale,
                                         stream)
        native.check(err, "flash_attn_qkv_forward")
        LAUNCHES.count += 1
    return out, lse


def flash_attention_qkv(qkv, heads: int):
    """qkv (B, L, 3 C) contiguous with C = 64 * heads; bfloat16 or float32
    on the card."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads)
    return _forward(qkv, heads, with_lse=False)[0]


def backward_scratch(qkv, heads: int):
    """The float32 backward's scratch on qkv's card (None for bf16): Q, K,
    V and dO split into TF32 hi and lo parts row-major, and Q^T, K^T and
    dO^T split and permuted, 14 planes of flash_attn_bwd_f32_rows(L) x 64
    floats per (batch, head)."""
    if qkv.dtype != torch.float32:
        return None
    B, L, _ = qkv.shape
    rows = native.load("flash_attn").flash_attn_bwd_f32_rows(L)
    return torch.empty(14 * B * heads * rows * 64, dtype=torch.float32, device=qkv.device)


def flash_attention_qkv_backward(qkv, out, lse, dout, heads: int):
    """dqkv (B, L, 3 C) in qkv's type from the two backward kernels: dQ (its
    prologue stores D = rowsum(dO * O)), then dK and dV. Same layouts as
    ``attention_qkv_backward_plain``; all on one card, contiguous."""
    _check(qkv, heads)
    B, L, C3 = qkv.shape
    C = C3 // 3
    if out.shape != (B, L, C) or dout.shape != (B, L, C) or lse.shape != (B, heads, L):
        raise ValueError("flash_attention_qkv_backward: out, dout (B, L, C), lse (B, h, L)")
    if out.dtype != qkv.dtype or dout.dtype != qkv.dtype or lse.dtype != torch.float32:
        raise ValueError("flash_attention_qkv_backward: out and dout in qkv's type, lse float32")
    if not all(t.is_cuda and t.device == qkv.device and t.is_contiguous()
               for t in (out, lse, dout)):
        raise ValueError("flash_attention_qkv_backward: inputs must be contiguous on qkv's card")
    if out.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("flash_attention_qkv_backward: out and dout must be 16-byte aligned "
                         "(the kernels read them by TMA or 16-byte copies)")
    dqkv = torch.empty_like(qkv)
    if B * L == 0:
        return dqkv
    D = torch.empty((B, heads, L), dtype=torch.float32, device=qkv.device)
    lib = native.load("flash_attn")
    ws = backward_scratch(qkv, heads)
    wp = ws.data_ptr() if ws is not None else None
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    scale, dt = float(64 ** -0.5), _DTYPES[qkv.dtype]
    err = lib.flash_attn_qkv_backward_dq(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                         lse.data_ptr(), D.data_ptr(), dqkv.data_ptr(), wp,
                                         B, L, heads, scale, dt, stream)
    native.check(err, "flash_attn_qkv_backward_dq")
    LAUNCHES_DQ.count += 1
    err = lib.flash_attn_qkv_backward_dkv(qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                                          D.data_ptr(), dqkv.data_ptr(), wp, B, L, heads,
                                          scale, dt, stream)
    native.check(err, "flash_attn_qkv_backward_dkv")
    LAUNCHES_DKV.count += 1
    return dqkv


class FlashAttentionQKV(torch.autograd.Function):
    """The kernels under autograd: forward with the log-sum-exp saved,
    backward through the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, qkv, heads):
        out, lse = _forward(qkv, heads, with_lse=True)
        ctx.heads = heads
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:     # a view at an odd offset: a fresh allocation is aligned
            dout = dout.clone()
        return flash_attention_qkv_backward(qkv, out, lse, dout, ctx.heads), None


def flash_attention_qkv_grad(qkv, heads: int):
    """``flash_attention_qkv`` under autograd (the kernels on the card, the
    plain version on the CPU)."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads)
    return FlashAttentionQKV.apply(qkv, heads)


def reset_counts():
    for counter in (LAUNCHES, LAUNCHES_F32, LAUNCHES_DQ, LAUNCHES_DKV):
        counter.reset()
