"""Segment-sum cases shared by the CPU tests (``test_torch_ops.py``) and
the card's (``test_torch_cuda.py``): seeded ids and rows, and the float64
sum with its error bound. No JAX here: the card's tests import it."""
import numpy as np
import torch


def segment_case(n, shape, S, dtype, ids="spread", seed=0):
    """(ids, vals) as numpy. ``ids``: "spread" draws ids in [-2, S + 3)
    (dropped, out of range and empty segments among them); "long" puts the
    rows in a few segments of thousands of rows (a tenth dropped, a
    twentieth past the end); "ba" is the BA's plan_b at S = 16 x 16: the
    diagonal blocks i * 17 of about 1,300 rows each at n = 40,960, the
    off-diagonal blocks of fewer, and the padded edges' dropped ids."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, *shape)).astype(dtype)
    if ids == "spread":
        seg = rng.integers(-2, S + 3, n)
    elif ids == "long":
        seg = rng.integers(0, min(S, 10), n)
        seg[rng.random(n) < 0.1] = -1
        seg[rng.random(n) < 0.05] = S + 3
    else:
        N = int(round(S ** 0.5))
        E = n // 4
        i = rng.integers(0, N, E)
        j = np.clip(i + rng.integers(-3, 4, E), 0, N - 1)
        seg = np.concatenate([i * N + i, j * N + j, i * N + j, j * N + i])
        seg[np.tile(np.arange(E) >= E * 15 // 16, 4)] = S   # padded edges
    return seg, vals


def float64_sum(seg, vals, S):
    """(sums, bound): the float64 per-segment sums and, per element, the
    worst-case error of adding each segment's rows in any order in the
    rows' dtype: segment length x machine epsilon x the sum of |rows|."""
    keep = (seg >= 0) & (seg < S)
    v = vals[keep].astype(np.float64)
    ref = np.zeros((S, *vals.shape[1:]))
    mag = np.zeros_like(ref)
    np.add.at(ref, seg[keep], v)
    np.add.at(mag, seg[keep], np.abs(v))
    count = np.bincount(seg[keep], minlength=S).reshape(-1, *[1] * (vals.ndim - 1))
    return ref, count * np.finfo(vals.dtype).eps * mag


def torch_case(n, shape, S, dtype, ids="spread", seed=0, device="cpu"):
    seg, vals = segment_case(n, shape, S, dtype, ids, seed)
    return seg, vals, torch.from_numpy(seg).to(device), torch.from_numpy(vals).to(device)
