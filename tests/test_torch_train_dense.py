"""The dense recipe (every other step of train_cdvo.py: MIN_FRAME = F, all
four frames revealed from step 0) of the port's CDV rollout against the
JAX package's, at the sizes of tests/test_train.py (F 4, M 4, 48 x 64,
STEPS 3), on the JAX weights and draws (tests/torch_train_pair.py).

The JAX rollout's BA window (t0 = 1, N = F) runs one past the last pose;
its scatter writes the clipped index F - 1 twice, and on XLA's CPU the
old pose wins, so the dense recipe never moves its last pose
(test_torch_train.py::test_jax_training_ba_leaves_the_last_pose_of_an_overflowing_window).
The port updates every pose of the window, which is what the JAX BA
solves with N = F - 1. The parity tests give the JAX rollout that window
(its ``ba_solve`` called with N - 1) and hold the port as
test_torch_train.py does: loss and metrics within 5e-5 relative, every
gradient leaf within 1e-3 of its own max |gradient| (``check_grads``).
test_torch_train_frozen_pose.py measures how far the JAX rollout as it
stands lies from the port. The JAX side runs once for the module, traced
afresh (``rollout_loss.__wrapped__`` under the helper's own jit), so that
no trace of the unpatched rollout from another test file is reused.
"""
import numpy as np
import pytest
import torch

import cdvslam_tpu.train.rollout as jax_rollout
import torch_train_pair
from torch_train_pair import check_grads, jax_loss_and_grads, port_loss_and_grads

torch.set_num_threads(2)
CFG = dict(F=4, M=4, STEPS=3, MIN_FRAME=4, is_cdv=True)


_JAX_BA = jax_rollout.ba_solve


def _jax_ba_without_overflow(*args, N, **kw):
    return _JAX_BA(*args, N=N - 1, **kw)


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rollout, "ba_solve", _jax_ba_without_overflow)
        mp.setattr(torch_train_pair, "jax_rollout_loss", jax_rollout.rollout_loss.__wrapped__)
        jl, jm, jg, params = jax_loss_and_grads("cdv", CFG)
    tl, tm, tg = port_loss_and_grads("cdv", CFG, params)
    return (jl, jm, jg), (tl, tm, tg)


def test_dense_rollout_loss_matches_jax(pair):
    (jl, jm, _), (tl, tm, _) = pair
    assert np.isfinite(tl) and abs(tl - jl) <= 5e-5 * abs(jl), (tl, jl)
    for k in ("px1", "tr", "ro"):
        assert abs(tm[k] - jm[k]) <= 5e-5 * max(abs(jm[k]), 1e-6), (k, tm[k], jm[k])


def test_dense_every_gradient_matches_jax(pair):
    (_, _, jg), (_, _, tg) = pair
    errs = check_grads(tg, jg)
    for prefix in ("patchify.dino.blocks.0.attn.qkv", "update.gatten", "posenc"):
        assert any(k.startswith(prefix) and errs[k][1] > 0 for k in errs), prefix

