"""The reference's DINO attention: the plain formula only (the program's
``ops/flash_attn.py`` launches its CUDA kernels on the card). Frozen copy
of the program's ``attention_qkv_plain``."""
from __future__ import annotations

import torch


def attention_qkv_plain(qkv, heads: int):
    """qkv (B, L, 3 C) -> (B, L, C), in qkv's dtype."""
    B, L, C3 = qkv.shape
    C = C3 // 3
    d = C // heads
    q, k, v = qkv.reshape(B, L, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    attn = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v).transpose(1, 2).reshape(B, L, C)


flash_attention_qkv = flash_attention_qkv_grad = attention_qkv_plain
