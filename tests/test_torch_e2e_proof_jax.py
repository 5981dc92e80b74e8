"""One training step of the end-to-end proof's recipe
(``cdvslam_tpu_torch.train.e2e_proof``: F 8, M 32, STEPS 10, MIN_FRAME 4,
float32, AdamW at 2e-4 under the one-cycle schedule over 100 steps): the
loss the port's ``make_train_step`` reports against the loss of JAX's
``make_loss_fn``, the function JAX's ``make_train_step`` differentiates
and whose value it reports (its forward alone: the gradient's compile
takes 3 minutes on the CPU at this size, against 25 s), at 48 x 64 on one
rendered clip of the proof's pool, on the JAX weights
(``tests/torch_train_pair.py``) and the JAX step's own draws (the key
split per sample, as the JAX loss function makes it).

The JAX training BA never moves the clip's last pose once all F frames
are visible (from step 7 here: ROADMAP, faults of the JAX package); the
port moves it, which is the JAX BA with N = F - 1, so the JAX rollout
runs with that window (as in test_torch_train_dense.py), traced afresh.
The loss and its metrics are held as the training pair tests hold them:
within 5e-5 relative.
"""
import jax
import numpy as np
import torch

import cdvslam_tpu.train.rollout as jax_rollout
import cdvslam_tpu.train.trainer as jax_trainer
from cdvslam_tpu.train import RolloutConfig as JaxRolloutConfig
from cdvslam_tpu_torch.train import e2e_proof, init_train_state, make_optimizer, make_train_step
from torch_train_pair import jax_draws, jax_params, port_model

torch.set_num_threads(2)
HT, WD = 48, 64
_JAX_BA = jax_rollout.ba_solve


def _jax_ba_without_overflow(*args, N, **kw):
    return _JAX_BA(*args, N=N - 1, **kw)


def test_one_step_of_the_proof_recipe_matches_jax(monkeypatch):
    cfg = e2e_proof.rollout_config()
    clip = e2e_proof.clip_pool(np.random.RandomState(0), HT, WD, e2e_proof.intrinsics(HT, WD),
                               n=1)[0]
    batch = {k: np.asarray(v, np.float32)[None]
             for k, v in zip(("images", "poses", "disps", "intrinsics"), clip)}
    model, params = jax_params("cdv")

    monkeypatch.setattr(jax_rollout, "ba_solve", _jax_ba_without_overflow)
    monkeypatch.setattr(jax_trainer, "rollout_loss", jax_rollout.rollout_loss.__wrapped__)
    jcfg = JaxRolloutConfig(**cfg._asdict())
    key = jax.random.PRNGKey(7)
    jl, (jm, any_nan) = jax.jit(jax_trainer.make_loss_fn(model, jcfg))(params, batch, key)
    jm = {"loss": float(jl), "nan_skip": float(any_nan),
          **{k: float(np.mean(v)) for k, v in jm.items()}}

    tmodel = port_model("cdv", params)
    topt, _ = make_optimizer(lr=2e-4, total_steps=100)
    draws = jax_draws(jcfg, jax.random.split(key, 1)[0], HT, WD)
    _, tm = make_train_step(tmodel, cfg, topt)(
        init_train_state(tmodel, topt), {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=[draws])
    tm = {k: float(v) for k, v in tm.items()}
    assert np.isfinite(tm["loss"]) and tm["nan_skip"] == jm["nan_skip"] == 0
    for k in ("loss", "px1", "tr", "ro"):
        assert abs(tm[k] - jm[k]) <= 5e-5 * max(abs(jm[k]), 1e-6), (k, tm[k], jm[k])
