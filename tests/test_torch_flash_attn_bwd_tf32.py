"""The numerics of the float32 backward's three TF32 passes, emulated on the CPU.

``csrc/flash_attn.cu`` computes dQ, dK and dV of softmax(q k^T / 8) v in
float32 on the tensor cores, as the float32 forward does: each operand x is
split into x_hi = tf32(x) and x_lo = x - x_hi as the tensor core reads it,
and each of the five products (S = Q K^T, dP = dO V^T, dQ = dS K, dK =
dS^T Q, dV = P^T dO) is lo hi + hi lo + hi hi, summed per 64-token tile
and added to dQ (dK, dV) in float32. The products that sum over tokens read
their shared-memory operand from the pre-pass's transposed planes (K^T, Q^T,
dO^T), whose slots are permuted in groups of 8 (slot t holds token 2t, slot
t + 4 token 2t + 1), so that P and dS feed them from the accumulator's
registers. Here that is emulated with torch on the CPU, with x_lo read both
ways (rounded, as the pre-pass writes it, and truncated, as raw float32 bits
are read), the planes gathered as the kernels read them, at one head of 64,
L 1,611 (the training length) and L 63, and held to the formula in float64:
dQ, dK and dV each within 1e-5 of its own max |float64|. A single TF32 pass
misses that. The last tests check the index arithmetic the kernels add: the
A fragments read from device memory (dO in dQ, K and V in dK/dV), the
accumulator-to-fragment map that meets each permuted plane, and the P^T
hand-over between the dK/dV kernel's two warpgroups.
"""
import numpy as np
import pytest
import torch

from test_torch_flash_attn_f32_split import slot_key, tf32

D = 64
SCALE = D ** -0.5
LOG2E = 1.4426950408889634


def mm3(a, b, lo_mode, passes=3):
    """a @ b from TF32 operands split as the kernels split them: lo hi, hi
    lo, hi hi (three passes, smallest first) or hi hi (one pass)."""
    ah, bh = tf32(a, "round"), tf32(b, "round")
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah, lo_mode), tf32(b - bh, lo_mode)
    return al @ bh + ah @ bl + ah @ bh


def plane_t(x, Lp):
    """The pre-pass's transposed plane of x (L, 64): 64 rows of Lp slots,
    slot c holding token slot_key(c); tokens past L zero."""
    xp = torch.cat([x, x.new_zeros(Lp - x.shape[0], D)])
    return xp[slot_key(np.arange(Lp))].T.contiguous()


def in_slots(m, Lp):
    """The columns (tokens) of an accumulator m (rows, L) in slot order,
    as the A fragments of a product over tokens hold them."""
    mp = torch.cat([m, m.new_zeros(m.shape[0], Lp - m.shape[1])], 1)
    return mp[:, slot_key(np.arange(Lp))]


def backward_tf32(q, k, v, out, lse, dout, lo_mode, passes=3):
    """dq, dk, dv of one head in float32, every product in TF32 passes, per
    64-token tile as the dQ and dK/dV kernels sum them."""
    L = q.shape[0]
    Lp = -(-L // 128) * 128
    s2 = SCALE * LOG2E
    Dr = (dout * out).sum(-1)                       # D = rowsum(dO * O)
    l2 = lse * LOG2E
    kt, qt, dot = plane_t(k, Lp), plane_t(q, Lp), plane_t(dout, Lp)
    dq = torch.zeros(L, D)
    for k0 in range(0, L, 64):                      # the dQ kernel: key tiles
        ks = slice(k0, min(k0 + 64, L))
        s = mm3(q, k[ks].T, lo_mode, passes)
        dp = mm3(dout, v[ks].T, lo_mode, passes)
        ds = torch.exp2(s * s2 - l2[:, None]) * (dp - Dr[:, None])
        ds = torch.cat([ds, ds.new_zeros(L, 64 - ds.shape[1])], 1)   # keys past L: P = 0
        dq = dq + mm3(in_slots(ds, 64), kt[:, k0:k0 + 64].T, lo_mode, passes)
    dk, dv = torch.zeros(L, D), torch.zeros(L, D)
    for q0 in range(0, L, 64):                      # the dK/dV kernel: query tiles
        qs = slice(q0, min(q0 + 64, L))
        st = mm3(k, q[qs].T, lo_mode, passes)
        pt = torch.exp2(st * s2 - l2[None, qs])     # P^T: rows keys, columns queries
        dpt = mm3(v, dout[qs].T, lo_mode, passes)
        dst = pt * (dpt - Dr[None, qs])
        pad = lambda m: torch.cat([m, m.new_zeros(L, 64 - m.shape[1])], 1)   # noqa: E731
        dv = dv + mm3(in_slots(pad(pt), 64), dot[:, q0:q0 + 64].T, lo_mode, passes)
        dk = dk + mm3(in_slots(pad(dst), 64), qt[:, q0:q0 + 64].T, lo_mode, passes)
    return dq * SCALE, dk * SCALE, dv


def reference(q, k, v, dout):
    """(dq, dk, dv) by the formula in float64, and the float32 out and lse
    the forward hands the backward."""
    q, k, v, g = (x.double() for x in (q, k, v, dout))
    s = q @ k.T * SCALE
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[:, None])
    out = p @ v
    ds = p * (g @ v.T - (g * out).sum(-1, keepdim=True))
    return (ds @ k * SCALE, ds.T @ q * SCALE, p.T @ g), out.float(), lse.float()


def inputs(L, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((L, 4, D)).astype(np.float32))
    return x.unbind(1)        # q, k, v, dout


def rels(got, want):
    return [((g.double() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]


@pytest.mark.parametrize("lo_mode", ["round", "trunc"])
@pytest.mark.parametrize("L", [1611, 63])
def test_three_tf32_passes_match_float64(L, lo_mode):
    q, k, v, dout = inputs(L, seed=L)
    want, out, lse = reference(q, k, v, dout)
    assert max(rels(backward_tf32(q, k, v, out, lse, dout, lo_mode), want)) <= 1e-5


@pytest.mark.parametrize("L", [1611, 63])
def test_one_tf32_pass_misses_the_tolerance(L):
    q, k, v, dout = inputs(L, seed=L)
    want, out, lse = reference(q, k, v, dout)
    assert min(rels(backward_tf32(q, k, v, out, lse, dout, "round", passes=1), want)) > 1e-5


def test_a_fragments_from_memory_cover_the_tile_in_the_b_operands_order():
    """``load_a_tf32``: register a of k8 step kk of lane (g, t) in warp w
    holds row 16 w + g + 8 (a & 1), column 8 kk + t + 4 (a >> 1), which is
    the TF32 A fragment's (row g + 8 (a & 1), column t + 4 (a >> 1)) of
    step kk, whose B operand (a row-major tile) holds columns 8 kk..8 kk + 7
    in their own order: every element of the 64 x 64 tile once."""
    seen = np.zeros((64, 64), int)
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kk in range(8):
                for a in range(4):
                    row, col = 16 * w + g + 8 * (a & 1), 8 * kk + t + 4 * (a >> 1)
                    frag_row, frag_col = 16 * w + g + 8 * (a & 1), t + 4 * (a >> 1)
                    assert (row, col) == (frag_row, 8 * kk + frag_col)
                    seen[row, col] += 1
    assert (seen == 1).all()


def test_accumulator_to_fragment_map_meets_each_permuted_plane():
    """``split_to_a``: accumulator element s[4 j + e] (row g + 8 (e >> 1),
    token 8 j + 2 t + (e & 1)) goes to register ((e & 1) << 1 | e >> 1) of
    k8 step j, which is (row g + 8 (a & 1), slot 8 j + t + 4 (a >> 1)); the
    transposed planes hold token slot_key(slot) there. So P in dQ and P^T,
    dS^T in dK/dV meet K^T, dO^T and Q^T at their own token."""
    for lane in range(32):
        g, t = lane // 4, lane % 4
        regs = set()
        for i in range(32):
            j, e = i // 4, i % 4
            a = ((e & 1) << 1) | (e >> 1)
            acc_row, acc_tok = g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)
            a_row, a_slot = g + 8 * (a & 1), 8 * j + t + 4 * (a >> 1)
            assert (acc_row, acc_tok) == (a_row, int(slot_key(a_slot)))
            regs.add((j, a))
        assert len(regs) == 32        # each register of the 8 steps written once


def test_transposed_planes_hold_each_token_once_per_group():
    x = torch.arange(130 * D, dtype=torch.float32).reshape(130, D)
    pt = plane_t(x, 256)
    keys = slot_key(np.arange(256))
    for c in range(256):
        want = x[keys[c]] if keys[c] < 130 else torch.zeros(D)
        assert torch.equal(pt[:, c], want)
    for grp in range(32):
        assert sorted(keys[8 * grp:8 * grp + 8]) == list(range(8 * grp, 8 * grp + 8))


def test_p_transposed_hand_over_is_one_to_one():
    """Warpgroup 0's thread l writes its accumulator element i of P^T at
    i 128 + l and warpgroup 1's thread l reads it there into the same
    element of its dP^T accumulator: the 4,096 (key, query) pairs of a tile
    map one to one onto the buffer's 4,096 floats, and each thread reads
    back exactly the pairs it holds."""
    where = {}
    for ltid in range(128):
        w, lane = ltid // 32, ltid % 32
        g, t = lane // 4, lane % 4
        for i in range(32):
            j, e = i // 4, i % 4
            pair = (16 * w + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1))
            assert pair not in where
            where[pair] = i * 128 + ltid
    assert sorted(where.values()) == list(range(4096))
