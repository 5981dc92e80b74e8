"""Port ops and kernel wrappers against the JAX package, on the CPU.

On CPU tensors the kernel wrappers (``ops.corr_cuda``, ``ops.flash_attn``,
``ops.segsum_cuda``) run their plain PyTorch versions and launch nothing; the kernels
themselves are held to the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.models.dinov2 import Attention as JAttention
from cdvslam_tpu.ops.corr import corr as jcorr
from cdvslam_tpu.ops.patchify import patchify as jpatchify
from cdvslam_tpu.ops.scatter import neighbors_np as jneighbors
from cdvslam_tpu.slam.kernels import corr_features as jcorr_features
from cdvslam_tpu_torch.ops import SegmentPlan, corr, corr_cl_plain, neighbors_np, patchify
from cdvslam_tpu_torch.ops import corr_cuda, flash_attn, segsum_cuda
from cdvslam_tpu_torch.slam.kernels import corr_features
from segsum_cases import float64_sum, torch_case

torch.set_num_threads(2)


def _corr_inputs(seed, E=300, K=40, NF=5, C=24, H=20, W=28):
    rng = np.random.default_rng(seed)
    gmap = rng.standard_normal((1, K, C, 3, 3)).astype(np.float32)
    fmap = rng.standard_normal((1, NF, C, H, W)).astype(np.float32)
    # centers spread past every border: part of each window reads zeros
    cx = rng.uniform(-6, W + 6, (1, E, 1, 1))
    cy = rng.uniform(-6, H + 6, (1, E, 1, 1))
    coords = np.stack([cx + rng.uniform(-1.5, 1.5, (1, E, 3, 3)),
                       cy + rng.uniform(-1.5, 1.5, (1, E, 3, 3))], 2).astype(np.float32)
    ii = rng.integers(0, K, E).astype(np.int32)
    jj = rng.integers(0, NF, E).astype(np.int32)
    return gmap, fmap, coords, ii, jj


@pytest.mark.parametrize("mode,radius", [("raw", 1), ("bilinear", 1), ("upperleft", 0),
                                         ("bilinear", 0)])
def test_patchify_matches_jax(mode, radius):
    rng = np.random.default_rng(0)
    net = rng.standard_normal((2, 5, 12, 16)).astype(np.float32)
    coords = np.stack([rng.uniform(-2, 18, (2, 7)), rng.uniform(-2, 14, (2, 7))],
                      -1).astype(np.float32)
    ref = jpatchify(jnp.asarray(net), jnp.asarray(coords), radius, mode=mode)
    out = patchify(torch.from_numpy(net), torch.from_numpy(coords), radius, mode=mode)
    assert out.shape == ref.shape
    # float32, same expression per element: only the blend's rounding differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_corr_matches_jax(seed):
    gmap, fmap, coords, ii, jj = _corr_inputs(seed)
    ref = jcorr(jnp.asarray(gmap), jnp.asarray(fmap), jnp.asarray(coords),
                jnp.asarray(ii), jnp.asarray(jj), radius=3)
    out = corr(torch.from_numpy(gmap), torch.from_numpy(fmap), torch.from_numpy(coords),
               torch.from_numpy(ii), torch.from_numpy(jj), radius=3)
    assert out.shape == (1, 300, 7, 7, 3, 3)
    # the tolerance tests/test_ops.py holds the JAX corr to: f32 dots of
    # 24 products, summed in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def _pyramid_inputs(seed, E=300, K=40, NF=5, C=24, H=32, W=44):
    """Level-1 inputs as _corr_inputs plus the level-2 fmap (H/4, W/4)."""
    gmap, fmap1, coords, ii, jj = _corr_inputs(seed, E, K, NF, C, H, W)
    fmap2 = np.random.default_rng(seed + 100).standard_normal(
        (1, NF, C, H // 4, W // 4)).astype(np.float32)
    return gmap, fmap1, fmap2, coords, ii, jj


def _cl(fmap):
    return torch.from_numpy(fmap[0]).permute(0, 2, 3, 1).contiguous()


def test_corr_wrapper_on_cpu_runs_plain_version_without_launching():
    gmap, fmap1, fmap2, coords, ii, jj = _pyramid_inputs(2, E=64)
    g = torch.from_numpy(gmap[0])
    c = torch.from_numpy(coords[0])
    ti, tj = torch.from_numpy(ii), torch.from_numpy(jj)
    before = corr_cuda.LAUNCHES.count
    out = corr_cuda.corr_pyramid_cl(g, _cl(fmap1), _cl(fmap2), c, ti, tj)
    assert corr_cuda.LAUNCHES.count == before == 0
    assert out.shape == (64, 7, 7, 3, 3, 2)
    # level 1 at coords, level 2 at coords / 4, level innermost
    assert torch.equal(out[..., 0], corr_cl_plain(g, _cl(fmap1), c, ti, tj))
    assert torch.equal(out[..., 1], corr_cl_plain(g, _cl(fmap2), c / 4.0, ti, tj))


@pytest.mark.parametrize("seed", [0, 1])
def test_corr_pyramid_matches_jax_corr_features(seed):
    """The port's corr_features (corr_pyramid_cl, plain on the CPU) against
    the JAX corr_features (XLA gather path on the CPU)."""
    gmap, fmap1, fmap2, coords, ii, jj = _pyramid_inputs(seed)
    ref = jcorr_features(jnp.asarray(gmap[0]), jnp.asarray(fmap1[0]), jnp.asarray(fmap2[0]),
                         jnp.asarray(coords), jnp.asarray(ii), jnp.asarray(jj))
    before = corr_cuda.LAUNCHES.count
    out = corr_features(torch.from_numpy(gmap[0]), _cl(fmap1), _cl(fmap2),
                        torch.from_numpy(coords[0]), torch.from_numpy(ii), torch.from_numpy(jj))
    assert corr_cuda.LAUNCHES.count == before == 0
    assert out.shape == ref.shape == (1, 300, 2 * 49 * 9)
    # as test_corr_matches_jax: f32 dots of 24 products, summed in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def _attention_through_wrapper(B, L, C, h, seed):
    """JAX Attention (einsum branch on the CPU) and the port's packed-qkv
    wrapper on the same projection weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    mod = JAttention(C, h)
    p = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ref = mod.apply(p, jnp.asarray(x))
    w = np.asarray(p["params"]["qkv"]["kernel"])
    b = np.asarray(p["params"]["qkv"]["bias"])
    before = flash_attn.LAUNCHES.count
    out = flash_attn.flash_attention_qkv(torch.from_numpy(x @ w + b), h)
    assert flash_attn.LAUNCHES.count == before == 0
    assert out.shape == (B, L, C)
    pw = np.asarray(p["params"]["proj"]["kernel"])
    pb = np.asarray(p["params"]["proj"]["bias"])
    return out.numpy() @ pw + pb, np.asarray(ref)


def test_flash_attention_wrapper_matches_jax_einsum_path():
    got, ref = _attention_through_wrapper(1, 37, 384, 6, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,L,C,h", [(1, 1, 384, 6), (1, 65, 384, 6), (2, 20, 128, 2)])
def test_attention_qkv_plain_matches_jax_attention(B, L, C, h):
    """attention_qkv_plain through the wrapper on CPU tensors: no launch."""
    got, ref = _attention_through_wrapper(B, L, C, h, L)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


# (n, row shape, segments, dtype, ids, seed, atol): the first case is the
# original; then the BA's widths (1, 6, 36) at its segment counts, SoftAgg's
# rows (384), the PGO's float64 blocks (7 x 7 and 7), zero rows, and
# segments of thousands of rows
SEGMENT_CASES = [
    (500, (3,), 37, np.float32, "spread", 4, 1e-5),
    (4096, (), 2688, np.float32, "spread", 1, None),
    (20480, (6,), 16, np.float32, "long", 2, None),
    (40960, (6, 6), 256, np.float32, "ba", 3, None),
    (10240, (36,), 256, np.float32, "long", 4, None),
    (19200, (6,), 43008, np.float32, "spread", 5, None),
    (2048, (384,), 2688, np.float32, "spread", 6, None),
    (800, (7, 7), 400, np.float64, "spread", 7, None),
    (400, (7,), 200, np.float64, "long", 8, None),
    (0, (6,), 16, np.float32, "spread", 9, None),
]


@pytest.mark.parametrize("n, shape, S, dtype, ids, seed, atol", SEGMENT_CASES)
def test_segment_sum_is_exact_and_repeatable(n, shape, S, dtype, ids, seed, atol):
    """On CPU tensors ``SegmentPlan.sum`` runs the plain version
    (torch.segment_reduce, the kernel's order of summation), launches
    nothing, repeats bitwise, and is within the worst-case rounding of a
    float64 sum; the kernel's wrapper refuses CPU tensors; the plan's
    offsets are the exclusive running sum of the run lengths."""
    seg, vals, ids_t, vals_t = torch_case(n, shape, S, dtype, ids, seed)
    plan = SegmentPlan(ids_t, S)
    kept = np.where((seg >= 0) & (seg < S), seg, S)
    counts = np.bincount(kept, minlength=S + 1)
    np.testing.assert_array_equal(plan.offsets.numpy(), np.cumsum(counts) - counts)
    ref, bound = float64_sum(seg, vals, S)
    tol = bound if atol is None else np.minimum(bound, atol)
    before = segsum_cuda.LAUNCHES.count
    for total in (SegmentPlan(ids_t, S).sum, plan.sum):
        a, b = total(vals_t), total(vals_t)
        assert torch.equal(a, b) and a.dtype == vals_t.dtype and a.shape == (S, *shape)
        assert np.all(np.abs(a.numpy() - ref) <= tol)
    assert segsum_cuda.LAUNCHES.count == before
    with pytest.raises(ValueError):
        segsum_cuda.segment_sum(vals_t, plan)


def test_neighbors_np_matches_jax():
    rng = np.random.default_rng(5)
    kk = rng.integers(0, 20, 200)
    jj = rng.integers(0, 9, 200)
    for a, b in zip(neighbors_np(kk, jj), jneighbors(kk, jj)):
        np.testing.assert_array_equal(a, b)


def test_random_grid_round_trip_misses_cells_and_jit_moves_it():
    """RANDOM_GRID puts patch centers on the DINO grid (x = cell / (4/14))
    and the upper-left context gather maps them back with floor((4/14) x).
    In float32 that round trip falls one ulp short of the cell for part of
    the patches, in the port as in the JAX package, so the gather takes
    the neighbouring token there. Under jax.jit XLA turns the division
    into a multiplication by the reciprocal, which changes the coordinates
    by an ulp and so which patches miss: the whole-slice parity tests draw
    their patches under jax.jit, as the JAX runtime does (ROADMAP Queue 3)."""
    from cdvslam_tpu.models.patchifier import select_random_grid as jselect
    from cdvslam_tpu_torch.models.patchifier import select_random_grid

    hi, wi, M, s = 35, 54, 96, 4.0 / 14.0      # the 480 x 752 main path
    u = s * select_random_grid(torch.Generator().manual_seed(0), 1, M, hi, wi, 3, s)
    assert 0 < int((torch.floor(u) != torch.round(u)).sum()) < u.numel()

    def draw(key):
        return jselect(key, 1, M, hi, wi, 3, s, True)

    key = jax.random.PRNGKey(0)
    eager, jitted = np.asarray(draw(key)), np.asarray(jax.jit(draw)(key))
    np.testing.assert_allclose(eager, jitted, rtol=1e-6)
    assert not np.array_equal(eager, jitted)
