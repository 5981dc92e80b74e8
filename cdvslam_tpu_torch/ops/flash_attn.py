"""DINO attention: the CUDA kernel ``csrc/flash_attn.cu`` and its wrapper.

``flash_attention_qkv(qkv, heads)`` computes softmax(q k^T * d^-1/2) v per
head, reading q, k and v from the packed ``qkv`` projection (B, L, 3 C),
laid out (B, L, 3, heads, d), and returns (B, L, C). On CPU tensors it
returns ``attention_qkv_plain`` (the JAX package's einsum branch,
``cdvslam_tpu/models/dinov2.py`` Attention); on CUDA tensors it launches
the kernel or raises. ``LAUNCHES.count`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import native

LAUNCHES = native.LaunchCounter("flash_attn")


def attention_qkv_plain(qkv, heads: int):
    """qkv (B, L, 3 C) -> (B, L, C), in qkv's dtype."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    q, k, v = qkv.reshape(B, L, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    attn = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v).transpose(1, 2).reshape(B, L, C)


def flash_attention_qkv(qkv, heads: int):
    """qkv (B, L, 3 C) contiguous with C = 64 * heads; bfloat16 on the card."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads)
    if not qkv.is_cuda:
        raise ValueError("flash_attention_qkv: qkv must be a CPU or CUDA tensor")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError("flash_attention_qkv: qkv must be (B, L, 3 C) with heads | C")
    B, L, C3 = qkv.shape
    C = C3 // 3
    if C // heads != 64:
        raise ValueError("flash_attention_qkv: the kernel is built for head dim 64")
    if qkv.dtype != torch.bfloat16:
        raise ValueError("flash_attention_qkv: the kernel takes bfloat16")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be contiguous and 16-byte aligned")
    out = torch.empty((B, L, C), dtype=qkv.dtype, device=qkv.device)
    if B * L == 0:
        return out
    lib = native.load("flash_attn")
    err = lib.flash_attn_qkv_forward(
        qkv.data_ptr(), out.data_ptr(), B, L, heads, float(64 ** -0.5),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    native.check(err, "flash_attn_qkv_forward")
    LAUNCHES.count += 1
    return out
