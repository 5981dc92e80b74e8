"""The numerics of the float32 forward's three TF32 passes, emulated on the CPU.

``csrc/flash_attn.cu`` computes softmax(q k^T / 8) v in float32 on the
tensor cores: each operand x is split into x_hi = tf32(x) (10 mantissa
bits, rounded) and x_lo = x - x_hi as the tensor core reads it, and each
product is lo hi + hi lo + hi hi, summed in float32. Here that is
emulated with torch on the CPU, with x_lo read both ways (truncated to
TF32, as raw float32 bits are read, and rounded, as the kernel writes it),
at B 1, one head of 64, L 1,611 (the training length) and L 63, and held
to float64: output and log-sum-exp within 1e-5 of max |float64|, the
tolerance the card holds the kernel to. A single TF32 pass misses it,
which shows that the tolerance sees the difference. The last tests check
the index arithmetic that lets P feed P V from the S accumulator's
registers: V^T's keys are permuted in groups of 8 (slot t holds key 2t,
slot t + 4 key 2t + 1), the order of a thread's keys in the accumulator.
"""
import numpy as np
import pytest
import torch

D = 64
SCALE = D ** -0.5


def tf32(x, mode):
    """x (float32) to TF32: "round" to nearest, ties away from zero (as
    cvt.rna.tf32.f32), or "trunc" (the 13 low bits dropped)."""
    bits = x.contiguous().view(torch.int32)
    if mode == "round":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b, lo_mode, passes=3):
    """a @ b in float32 from TF32 operands: three passes (lo hi + hi lo + hi
    hi) with the low parts read by ``lo_mode``, or one pass (hi hi)."""
    ah, bh = tf32(a, "round"), tf32(b, "round")
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah, lo_mode), tf32(b - bh, lo_mode)
    return al @ bh + ah @ bl + ah @ bh


def slot_key(c):
    """The key that slot c of a V^T row holds (the kernel's slot_key)."""
    e = c & 7
    return (c & ~7) + np.where(e < 4, 2 * e, 2 * e - 7)


def attention_tf32(q, k, v, lo_mode, passes=3):
    """(out, lse) of one head in float32 with every product in TF32 passes;
    P V summed over V^T's permuted slots, as the kernel reads it."""
    s = mm_tf32(q, k.T, lo_mode, passes)
    m = s.max(-1, keepdim=True).values * SCALE
    p = torch.exp(s * SCALE - m)
    L = q.shape[0]
    Lp = -(-L // 64) * 64
    keys = slot_key(np.arange(Lp))
    vp = torch.cat([v, v.new_zeros(Lp - L, D)])[keys]        # V^T's slots, as rows
    pp = torch.cat([p, p.new_zeros(L, Lp - L)], 1)[:, keys]
    l = p.sum(-1, keepdim=True)
    return mm_tf32(pp, vp, lo_mode, passes) / l, (m + torch.log(l))[:, 0]


def reference(q, k, v):
    q, k, v = q.double(), k.double(), v.double()
    s = q @ k.T * SCALE
    return torch.softmax(s, -1) @ v, torch.logsumexp(s, -1)


def inputs(L, seed):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((L, 3, D)).astype(np.float32))
    return qkv.unbind(1)


def rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("lo_mode", ["round", "trunc"])
@pytest.mark.parametrize("L", [1611, 63])
def test_three_tf32_passes_match_float64(L, lo_mode):
    q, k, v = inputs(L, seed=L)
    out, lse = attention_tf32(q, k, v, lo_mode)
    want_out, want_lse = reference(q, k, v)
    assert rel(out, want_out) <= 1e-5
    assert rel(lse, want_lse) <= 1e-5


@pytest.mark.parametrize("L", [1611, 63])
def test_one_tf32_pass_misses_the_tolerance(L):
    q, k, v = inputs(L, seed=L)
    out, lse = attention_tf32(q, k, v, "round", passes=1)
    want_out, want_lse = reference(q, k, v)
    assert rel(out, want_out) > 1e-5
    assert rel(lse, want_lse) > 1e-5


def test_split_parts_are_tf32_and_exact():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32(x, "round")
    lo = x - hi
    assert torch.equal(hi + lo, x)                       # x - hi is exact in float32
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    # |lo| is at most half a TF32 ulp of x: 2^-11 relative
    assert (lo.abs() <= x.abs() * 2.0 ** -11).all()


def test_slot_key_permutes_each_group_of_eight():
    c = np.arange(128)
    keys = slot_key(c)
    for g in range(16):
        assert sorted(keys[8 * g:8 * g + 8]) == list(range(8 * g, 8 * g + 8))
    t = np.arange(4)
    assert (keys[t] == 2 * t).all() and (keys[t + 4] == 2 * t + 1).all()


def test_p_fragment_meets_its_key_in_v_transposed():
    """For every lane of a warp: the S accumulator register the kernel puts
    into each TF32 A register of P V holds the P of the same row and of the
    key that V^T's slot for that A register holds."""
    take = [0, 2, 1, 3]       # A register a of k8 step j <- s[4 j + take[a]]
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j in range(8):
            for a in range(4):
                i = 4 * j + take[a]
                # the accumulator layout: s[4 j' + e] is row g + 8 (e >> 1),
                # key 8 j' + 2 t + (e & 1)
                acc_row = g + 8 * ((i % 4) >> 1)
                acc_key = 8 * (i // 4) + 2 * t + (i & 1)
                # the TF32 A fragment of m64nNk8: register a is row g + 8 (a & 1),
                # column (slot) t + 4 (a >> 1) of the k8 step
                a_row = g + 8 * (a & 1)
                a_slot = 8 * j + t + 4 * (a >> 1)
                assert (acc_row, acc_key) == (a_row, int(slot_key(a_slot)))
