"""How far the JAX dense recipe as it stands lies from the port.

The JAX rollout's BA window overflows by one pose and leaves the clip's
last pose where it was (test_torch_train.py, the overflowing-window
test); the port moves it, and test_torch_train_dense.py holds the port to
the JAX rollout with the window cut to N = F - 1. Here the JAX rollout
runs unchanged on the dense recipe at test size (F 4, M 4, MIN_FRAME 4,
STEPS 3, 48 x 64, identity ground truth, tests/torch_train_pair.py) and
its loss is compared with the port's on the same weights and draws. The
frozen pose is no rounding matter: the loss differs by 0.57 of the
port's (0.963 against 2.249, measured on this size) and px1 by 0.78.
The JAX side is traced afresh (``rollout_loss.__wrapped__``).
"""
import jax
import torch

import cdvslam_tpu.train.rollout as jax_rollout
from cdvslam_tpu.train import RolloutConfig as JaxRolloutConfig
from cdvslam_tpu_torch.train import RolloutConfig, rollout_loss
from torch_train_pair import clip, jax_draws, jax_params, port_model

torch.set_num_threads(2)
CFG = dict(F=4, M=4, STEPS=3, MIN_FRAME=4, is_cdv=True)


def test_dense_loss_with_the_frozen_last_pose_departs_from_the_port():
    model, params = jax_params("cdv")
    images, poses, disps, intr = clip()
    jl, jm = jax.jit(lambda p: jax_rollout.rollout_loss.__wrapped__(
        p, model, JaxRolloutConfig(**CFG), images, poses, disps, intr,
        jax.random.PRNGKey(1)))(params)
    draws = jax_draws(JaxRolloutConfig(**CFG), jax.random.PRNGKey(1))
    with torch.no_grad():
        tl, tm = rollout_loss(port_model("cdv", params), RolloutConfig(**CFG),
                              *(torch.from_numpy(a) for a in (images, poses, disps, intr)),
                              draws=draws)
    gap = abs(float(jl) - float(tl)) / abs(float(tl))
    assert 0.3 < gap < 1.0, (float(jl), float(tl))
    assert float(jm["px1"]) < float(tm["px1"]), (float(jm["px1"]), float(tm["px1"]))
