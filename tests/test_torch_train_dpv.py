"""The port's DPVO training rollout (VONet, RANDOM patches) against the JAX
package's at the sizes of tests/test_train.py, and ``structure_only``
(depths alone, poses held at the ground truth) in the BA and in the
rollout. Tolerances as in test_torch_train.py: loss and metrics 5e-5
relative (measured 6.7e-6), gradients 1e-3 of each leaf's max |gradient|
(measured at most 1.1e-4), the analytically zero leaves (conv biases ahead
of an instance norm, the SoftAgg gate biases) below 1e-5 of the largest.
The structure-only BA: depths within 1e-5 of JAX's and poses unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.ba import TRAINING_PARAMS as JAX_TRAINING_PARAMS, ba_solve as jax_ba_solve
from cdvslam_tpu_torch.ba import TRAINING_PARAMS, ba_solve
from cdvslam_tpu_torch.geom import transform
from cdvslam_tpu_torch.lie import SE3, se3_exp
from torch_train_pair import (
    check_grads, jax_loss_and_grads, jax_params, port_loss_and_grads,
)

torch.set_num_threads(2)
CFG = dict(F=4, M=4, STEPS=3, MIN_FRAME=3, is_cdv=False)


@pytest.fixture(scope="module")
def pair():
    jl, jm, jg, params = jax_loss_and_grads("dpv", CFG)
    tl, tm, tg = port_loss_and_grads("dpv", CFG, params)
    return (jl, jm, jg), (tl, tm, tg)


def test_dpv_rollout_loss_matches_jax(pair):
    (jl, jm, _), (tl, tm, _) = pair
    assert np.isfinite(tl) and abs(tl - jl) <= 5e-5 * abs(jl), (tl, jl)
    for k in ("px1", "tr", "ro"):
        assert abs(tm[k] - jm[k]) <= 5e-5 * max(abs(jm[k]), 1e-6), (k, tm[k], jm[k])


def test_dpv_every_gradient_matches_jax(pair):
    (_, _, jg), (_, _, tg) = pair
    errs = check_grads(tg, jg)
    for prefix in ("patchify.fnet", "patchify.inet", "update.gru", "update.agg_ij"):
        assert any(k.startswith(prefix) and errs[k][1] > 0 for k in errs), prefix


def _window(seed=0, F_=4, M_=6):
    g = torch.Generator().manual_seed(seed)
    poses = se3_exp(0.05 * torch.randn((F_, 6), generator=g))
    patches = torch.zeros((F_ * M_, 3, 3, 3))
    patches[:, 0] = (torch.rand(F_ * M_, generator=g) * 60)[:, None, None]
    patches[:, 1] = (torch.rand(F_ * M_, generator=g) * 40)[:, None, None]
    patches[:, 2] = (0.5 + torch.rand(F_ * M_, generator=g))[:, None, None]
    intr = torch.tensor([30.0, 30.0, 32.0, 24.0])
    ii = torch.arange(F_).repeat_interleave(F_ * M_)
    jj = torch.arange(F_).repeat_interleave(M_).repeat(F_)
    kk = ii * M_ + torch.arange(M_).repeat(F_ * F_)
    target = transform(SE3(poses[None]), patches[None], intr.expand(1, F_, 4), ii, jj, kk)
    target = target[0, :, 1, 1] + torch.randn((len(ii), 2), generator=g)
    weight = torch.rand((len(ii), 2), generator=g)
    return poses, patches, intr, target, weight, ii, jj, kk, ii != jj


def test_structure_only_ba_matches_jax():
    """Two iterations on the training numerics with the rollout's bounds
    gate: the depths move as JAX's do, the poses stay."""
    args = _window()
    bounds = torch.tensor([-64.0, -64.0, 16.0 + 64, 12.0 + 64])
    tp, tq = ba_solve(*args, 1, N=4, K=24, params=TRAINING_PARAMS, structure_only=True,
                      bounds=bounds)
    jp, jq = jax_ba_solve(*(jnp.asarray(a.numpy()) for a in args), 1, N=4, K=24,
                          params=JAX_TRAINING_PARAMS, structure_only=True, use_bounds=True,
                          bounds=jnp.asarray(bounds.numpy()))
    assert torch.equal(tp, args[0])
    assert (tq[:, 2] - args[1][:, 2]).abs().max() > 1e-3
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5, rtol=0)


def test_structure_only_rollout_matches_jax():
    """The whole rollout with poses held at a moving ground truth (0.05 rad
    and 0.05 per frame): the flow loss alone, no pose loss."""
    import jax
    from cdvslam_tpu.train import RolloutConfig as JaxRolloutConfig, rollout_loss as jax_loss
    from cdvslam_tpu_torch.train import RolloutConfig, rollout_loss
    from torch_train_pair import clip, jax_draws, port_model
    cfg = dict(CFG, STEPS=2, structure_only=True)
    model, params = jax_params("dpv")
    images, _, disps, intr = clip()
    xi = 0.05 * torch.randn((4, 6), generator=torch.Generator().manual_seed(5))
    poses = se3_exp(xi).numpy()
    jl, jm = jax.jit(lambda p: jax_loss(p, model, JaxRolloutConfig(**cfg), images, poses, disps,
                                        intr, jax.random.PRNGKey(2)))(params)
    draws = jax_draws(JaxRolloutConfig(**cfg), jax.random.PRNGKey(2))
    with torch.no_grad():
        tl, tm = rollout_loss(port_model("dpv", params), RolloutConfig(**cfg),
                              *(torch.from_numpy(a) for a in (images, poses, disps, intr)),
                              draws=draws)
    assert float(jm["tr"]) == float(tm["tr"]) == 0.0
    assert abs(float(tl) - float(jl)) <= 5e-5 * abs(float(jl)), (float(tl), float(jl))
