"""Port ``ba_solve`` against the JAX ``ba_solve(..., assembly="scatter")``.

A synthetic window like tests/test_ba.py's: targets from ground-truth poses
plus 0.3 px noise, perturbed poses and depths, random weights, a fixed
first pose (t0 = 1), 2 iterations.

Tolerances: 1e-4 on poses and 1e-3 on inverse depths (measured: 5.9e-5
and 4.3e-4). Both sides solve the same float32 normal equations, but the
monocular scale gauge leaves S = B - E Q E^T close to singular along one
direction, so float32 rounding in the JAX einsums is amplified: the port's
float32 result is within 4e-6 of its own float64 run, the JAX float32
result 6e-5 from it. The float64 comparison is the second test.

Off the card ``ba_solve`` runs its plain chain, which the card's kernels
(``ops/ba_cuda.py``) reproduce bit for bit: on CPU tensors, in float64,
under autograd, with the training numerics and with ``bounds`` it launches
no kernel and gives, bitwise (NaN included), what the benchmark's frozen
copy of the chain (``portbench/ref/ba/ba.py``) gives; the kernels' wrappers
refuse what is not CUDA float32. ``tests/test_torch_cuda.py`` holds the
kernels to the chain on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.ba import ba_solve as jba_solve
from cdvslam_tpu.geom import transform as jtransform
from cdvslam_tpu.lie import SE3 as JSE3
from ba_cases import ba_case, solve_args, update_case
from cdvslam_tpu_torch.ba import ba_solve
from cdvslam_tpu_torch.ba.ba import INFERENCE_PARAMS, TRAINING_PARAMS
from cdvslam_tpu_torch.ops import ba_cuda
from portbench.ref.ba import ba as frozen

torch.set_num_threads(2)


def _window(seed=0, NF=6, M=12, NP=10, P=3):
    rng = np.random.default_rng(seed)
    gt = JSE3.exp(0.05 * jax.random.normal(jax.random.PRNGKey(seed), (1, NF, 6)))
    K = NF * M
    patches = np.zeros((K, 3, P, P), np.float32)
    patches[:, 0] = rng.uniform(20, 100, K)[:, None, None]
    patches[:, 1] = rng.uniform(20, 80, K)[:, None, None]
    patches[:, 2] = rng.uniform(0.5, 1.5, K)[:, None, None]
    intr = np.array([60.0, 60.0, 60.0, 50.0], np.float32)
    ii, jj = np.meshgrid(np.arange(NF), np.arange(NF), indexing="ij")
    sel = ii != jj
    ii = np.repeat(ii[sel], M)
    jj = np.repeat(jj[sel], M)
    kk = ii * M + np.tile(np.arange(M), sel.sum())
    coords = jtransform(gt, jnp.asarray(patches)[None], jnp.tile(intr, (1, NF, 1)),
                        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk))
    target = np.asarray(coords[0, :, P // 2, P // 2, :]) + rng.normal(0, 0.3, (len(ii), 2))
    xi = 0.02 * rng.standard_normal((NF, 6)).astype(np.float32)
    xi[0] = 0
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (NP, 1))
    poses[:NF] = np.asarray(JSE3.exp(jnp.asarray(xi)).mul(JSE3(gt.data[0])).data)
    pert = patches.copy()
    pert[:, 2] = np.clip(pert[:, 2] + 0.2 * rng.standard_normal(K)[:, None, None], 0.05, None)
    weight = rng.uniform(0.1, 1.0, (len(ii), 2)).astype(np.float32)
    return (poses, pert, intr, target.astype(np.float32), weight,
            ii.astype(np.int32), jj.astype(np.int32), kk.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_ba_solve_matches_jax_scatter(seed):
    poses, patches, intr, target, weight, ii, jj, kk = _window(seed)
    K, E = patches.shape[0], len(ii)
    jp, jpat = jba_solve(jnp.asarray(poses), jnp.asarray(patches), jnp.asarray(intr),
                         jnp.asarray(target), jnp.asarray(weight), jnp.asarray(ii),
                         jnp.asarray(jj), jnp.asarray(kk), jnp.ones(E, bool), 1,
                         N=8, K=K, iterations=2, assembly="scatter")
    tp, tpat = ba_solve(*(torch.from_numpy(a) for a in
                          (poses, patches, intr, target, weight, ii, jj, kk)),
                        None, 1, N=8, K=K, iterations=2)
    assert not np.allclose(np.asarray(jp), poses)       # the solve moved the poses
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tpat.numpy(), np.asarray(jpat), atol=1e-3, rtol=0)


def test_ba_solve_float32_close_to_float64():
    """The port's float32 solve against the same solve in float64: 1e-5 on
    poses (measured 3.3e-6) -- the port adds no error of its own."""
    arrays = _window(0)
    K = arrays[1].shape[0]
    t32 = [torch.from_numpy(a) for a in arrays]
    t64 = [t.double() if t.is_floating_point() else t for t in t32]
    p32, d32 = ba_solve(*t32, None, 1, N=8, K=K, iterations=2)
    p64, d64 = ba_solve(*t64, None, 1, N=8, K=K, iterations=2)
    np.testing.assert_allclose(p32.numpy(), p64.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(d32.numpy(), d64.numpy(), atol=1e-4, rtol=0)


def test_ba_solve_is_bitwise_repeatable():
    args = [torch.from_numpy(a) for a in _window(2)]
    K = args[1].shape[0]
    a = ba_solve(*args, None, 1, N=8, K=K, iterations=2)
    b = ba_solve(*args, None, 1, N=8, K=K, iterations=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def bits_equal(a, b):
    """Equal bit for bit: signed zeros and NaN payloads included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


# (ba_case options, ba_solve keywords, float64, inputs that require grad)
OFF_CARD = {
    "inference": ({}, {}, False, False),
    "edge_cases": ({"edge_cases": True, "nan_weight": True}, {}, False, False),
    "past_end": ({"past_end": 3}, {}, False, False),
    "structure_only": ({"edge_cases": True}, {"structure_only": True}, False, False),
    "training": ({"edge_cases": True}, {"params": TRAINING_PARAMS}, False, False),
    "bounds": ({"edge_cases": True}, {"bounds": (0.0, 0.0, 188.0, 120.0)}, False, False),
    "float64": ({"edge_cases": True}, {}, True, False),
    "autograd": ({}, {"params": TRAINING_PARAMS}, False, True),
}


@pytest.mark.parametrize("name", list(OFF_CARD))
def test_ba_solve_off_the_card_is_the_frozen_chain(name):
    """No kernel launch, and the frozen chain's bits, poses and patches (and
    under autograd the gradient of both as well)."""
    opts, kw, f64, grad = OFF_CARD[name]
    case = ba_case("cpu", E_pad=1024, E=900, N=8, NF=12, M=16, seed=len(name), **opts)
    args, kws = solve_args(case)
    if f64:
        args = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                     for a in args)
    if grad:
        args = (args[0].clone().requires_grad_(), args[1].clone().requires_grad_(), *args[2:])
    ref_kw = dict(kw, params=frozen.BAParams(*kw["params"])) if "params" in kw else kw
    before = ba_cuda.LAUNCHES.count
    got = ba_solve(*args, **kws, **kw)
    want = frozen.ba_solve(*args, **kws, **ref_kw)
    assert ba_cuda.LAUNCHES.count == before
    assert all(bits_equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[1][:, 2], args[1][:, 2])          # the depths moved
    # the poses stay with structure_only, and where a NaN weight fails the solve
    assert torch.equal(got[0], args[0]) == bool(kw.get("structure_only")
                                                or opts.get("nan_weight"))
    if grad:
        grads = [torch.autograd.grad(sum(t.square().sum() for t in out), args[:2])
                 for out in (got, want)]
        assert all(bits_equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["linearize", "update"])
def test_ba_kernels_refuse_what_is_not_cuda_float32(kernel, dtype):
    """The wrappers raise a ValueError, and launch nothing, on CPU tensors
    of either float type (the card's test adds CUDA float64)."""
    case = ba_case("cpu", E_pad=256, E=200, N=8, NF=12, M=16)
    case = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in case.items()}
    before = ba_cuda.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA float32"):
        if kernel == "linearize":
            ba_cuda.linearize(*(case[k] for k in ("poses", "patches", "intrinsics", "target",
                                                  "weight", "ii", "jj", "kk", "mask")),
                              INFERENCE_PARAMS)
        else:
            dX, dZ, touched, win_rows = update_case(case)
            ba_cuda.update(case["poses"], case["patches"], dX.to(dtype), dZ.to(dtype), touched,
                           win_rows)
    assert ba_cuda.LAUNCHES.count == before
