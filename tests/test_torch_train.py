"""The port's CDV training rollout against the JAX package's, at the sizes of
tests/test_train.py (F 4, M 4, 48 x 64, MIN_FRAME 3, STEPS 3), on the JAX
weights and draws (tests/torch_train_pair.py).

Tolerances: the loss and its metrics within 5e-5 relative (measured
1.7e-5: float32 rounding through the damped Gauss-Newton solves, whose
conditioning amplifies it; the update operator and the features agree to
1e-6); every parameter's gradient within 1e-3 of the largest |gradient| of
its own leaf (measured at most 3.0e-4); the analytically zero leaves
(JAX gradient below 1e-6 of the largest leaf's) below 1e-5 of it on both
sides (see ``check_grads``). The JAX side runs once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.ba import ba_solve as jax_ba_solve, TRAINING_PARAMS as JAX_TRAINING_PARAMS
from cdvslam_tpu.lie import se3_inv as jse3_inv, se3_log as jse3_log, se3_mul as jse3_mul
from cdvslam_tpu.train import RolloutConfig as JaxRolloutConfig
from cdvslam_tpu.train import build_static_edges as jax_edges, n_visible as jax_n_visible
from cdvslam_tpu_torch.ba import TRAINING_PARAMS, ba_solve
from cdvslam_tpu_torch.lie import se3_inv, se3_log, se3_mul
from cdvslam_tpu_torch.train import RolloutConfig, build_static_edges, n_visible
from cdvslam_tpu_torch.train.rollout import _safe_norm
from torch_train_pair import check_grads, jax_loss_and_grads, port_loss_and_grads

torch.set_num_threads(2)
CFG = dict(F=4, M=4, STEPS=3, MIN_FRAME=3, is_cdv=True)


@pytest.fixture(scope="module")
def pair():
    jl, jm, jg, params = jax_loss_and_grads("cdv", CFG)
    tl, tm, tg = port_loss_and_grads("cdv", CFG, params)
    return (jl, jm, jg), (tl, tm, tg)


@pytest.mark.parametrize("F,M,STEPS,MIN_FRAME", [(5, 3, 4, 3), (15, 80, 18, 8), (4, 1530, 4, 4)])
def test_edge_schedule_matches_jax(F, M, STEPS, MIN_FRAME):
    """The lattice, neighbours and groups of the test size and of the
    sparse and dense recipes, and the reveal schedule."""
    port, jax_ = (fn(cfg(F=F, M=M, STEPS=STEPS, MIN_FRAME=MIN_FRAME)) for fn, cfg in (
        (build_static_edges, RolloutConfig), (jax_edges, JaxRolloutConfig)))
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a, b)
    for s in range(STEPS + 2):
        assert n_visible(RolloutConfig(F=F, M=M, STEPS=STEPS, MIN_FRAME=MIN_FRAME), s) == \
            jax_n_visible(JaxRolloutConfig(F=F, M=M, STEPS=STEPS, MIN_FRAME=MIN_FRAME), s)
    ii, jj, kk, ix, jx, perm, _ = port
    e = (2 * F + 3) * M + 1 if F > 4 else (2 * F + 2) * M + 1
    assert ix[e] == e - M and kk[e] == ii[e] * M + 1
    assert (ii[perm[7]] == ii[perm[7]][0]).all() and (jj[perm[7]] == jj[perm[7]][0]).all()


def test_rollout_loss_matches_jax(pair):
    (jl, jm, _), (tl, tm, _) = pair
    assert np.isfinite(tl) and abs(tl - jl) <= 5e-5 * abs(jl), (tl, jl)
    for k in ("px1", "tr", "ro"):
        assert abs(tm[k] - jm[k]) <= 5e-5 * max(abs(jm[k]), 1e-6), (k, tm[k], jm[k])


def test_every_gradient_matches_jax(pair):
    (_, _, jg), (_, _, tg) = pair
    errs = check_grads(tg, jg)
    # DINO, XFeat (its BatchNorm statistics too), the update operator and
    # the position encoding all receive a gradient
    for prefix in ("patchify.dino.blocks.0.attn.qkv", "patchify.dino.blocks.11",
                   "patchify.xfeat.block1.0.layer.1.running_mean", "update.gatten", "posenc"):
        assert any(k.startswith(prefix) and errs[k][1] > 0 for k in errs), prefix


def test_pose_loss_gradient_at_identity_matches_jax():
    """se3_log and the safe norm at exactly zero rotation and translation
    (identity ground truth and estimate, as in the rollout's first steps):
    the gradient is finite and equals JAX's."""
    rng = np.random.RandomState(3)
    xi = np.zeros((4, 7), np.float32)
    xi[:, 6] = 1.0
    xi[2:, :3] = rng.randn(2, 3).astype(np.float32) * 1e-3     # two off identity
    gt = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32), (4, 1))

    rev = np.array([3, 2, 1, 0])

    def loss(lib, x, g):
        inv, mul, log, norm = lib
        e = log(mul(mul(inv(x), x[rev]), inv(mul(inv(g), g[rev]))))
        return (norm(e[:, :3]) + norm(e[:, 3:6])).sum()

    jlib = (jse3_inv, jse3_mul, jse3_log,
            lambda v: jnp.sqrt(jnp.sum(v * v, -1) + 1e-12))
    jg = np.asarray(jax.grad(lambda x: loss(jlib, x, jnp.asarray(gt)))(jnp.asarray(xi)))
    x = torch.from_numpy(xi).requires_grad_(True)
    loss((se3_inv, se3_mul, se3_log, lambda v: _safe_norm(v, -1)), x,
         torch.from_numpy(gt)).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-4, atol=1e-5)


def test_jax_training_ba_leaves_the_last_pose_of_an_overflowing_window():
    """A fault of the JAX package: the rollout's BA window is t0 = 1, N = F,
    one past the last pose. Its scatter sets the clipped index F - 1 twice,
    with the new pose and then with the old one, and on XLA's CPU the last
    write wins, so the last frame's pose never moves (the dense recipe
    reveals all four frames from the start, the sparse one frame 14 from
    step 14). The port updates every pose of the window."""
    from cdvslam_tpu_torch.geom import transform
    from cdvslam_tpu_torch.lie import SE3, se3_exp
    g = torch.Generator().manual_seed(0)
    F_, M_ = 4, 6
    poses = se3_exp(0.05 * torch.randn((F_, 6), generator=g))
    patches = torch.zeros((F_ * M_, 3, 3, 3))
    patches[:, 0] = (torch.rand(F_ * M_, generator=g) * 60)[:, None, None]
    patches[:, 1] = (torch.rand(F_ * M_, generator=g) * 40)[:, None, None]
    patches[:, 2] = (0.5 + torch.rand(F_ * M_, generator=g))[:, None, None]
    intr = torch.tensor([30.0, 30.0, 32.0, 24.0])
    ii = torch.arange(F_).repeat_interleave(F_ * M_)
    jj = torch.arange(F_).repeat_interleave(M_).repeat(F_)
    kk = ii * M_ + torch.arange(M_).repeat(F_ * F_)
    target = transform(SE3(poses[None]), patches[None], intr.expand(1, F_, 4), ii, jj, kk)[0, :, 1, 1]
    target = target + torch.randn(target.shape, generator=g)
    weight = torch.rand(target.shape, generator=g)
    mask = ii != jj
    start = torch.cat([poses[:1], se3_exp(torch.zeros(F_ - 1, 6))])
    args = (start, patches, intr, target, weight, ii, jj, kk, mask, 1)
    # one iteration: the other poses then solve the same system on both sides
    tp, _ = ba_solve(*args, N=F_, K=F_ * M_, iterations=1, params=TRAINING_PARAMS)
    jp, _ = jax_ba_solve(*(jnp.asarray(a.numpy()) for a in args[:9]), 1, N=F_, K=F_ * M_,
                         iterations=1, params=JAX_TRAINING_PARAMS)
    jp = np.asarray(jp)
    np.testing.assert_array_equal(jp[-1], start[-1].numpy())          # JAX: never moves
    assert (tp[-1] - start[-1]).abs().max() > 1e-3                     # the port: moves
    np.testing.assert_allclose(tp[1:-1].numpy(), jp[1:-1], atol=1e-4)
