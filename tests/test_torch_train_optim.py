"""The port's trainer against optax and the JAX trainer's contract: the
one-cycle schedule, AdamW after the global-norm clip, the lock-step NaN
guard, checkpoints, and the loss falling on a fixed batch.

Tolerances: the schedule within 1e-6 of its peak of optax's (both float32;
near the end of the decay start + pct (end - start) cancels, and the two
differ by an ulp of the start value there);
parameters after 3 optimizer steps within 1e-6 relative of optax's on the
same gradients (float32 rounding in another order of the moment updates);
the NaN-guard step equal to optax's step on zero gradients within the
same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cdvslam_tpu.train import make_optimizer as jax_make_optimizer
from cdvslam_tpu_torch.models import CDVNet
from cdvslam_tpu_torch.train import (
    RolloutConfig, init_train_state, make_optimizer, make_train_step,
)
from cdvslam_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from cdvslam_tpu_torch.train.trainer import apply_updates

torch.set_num_threads(2)
F, M, H, W = 4, 4, 48, 64


@pytest.mark.parametrize("lr,total", [(8e-5, 240000), (3e-4, 200), (1e-4, 100), (1e-3, 1000)])
def test_schedule_matches_optax(lr, total):
    ours = make_optimizer(lr=lr, total_steps=total)[1]
    theirs = jax_make_optimizer(lr=lr, total_steps=total)[1]
    b = int(0.01 * total)
    for count in sorted({0, 1, 2, b - 1, b, b + 1, total // 3, total // 2, total - 1, total,
                         total + 7}):
        if count < 0:
            continue
        want = float(theirs(jnp.asarray(count, jnp.int32)))
        got = float(ours(count))
        assert abs(got - want) <= 1e-6 * lr, (count, got, want)


def _params(rng):
    return {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(11).astype(np.float32),
            "c": rng.randn(3, 2, 2).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [0.3, 30.0])
def test_adamw_with_clip_matches_optax_over_three_steps(grad_scale):
    """Gradients below and above the clip (10): optax scales by clip / norm
    only when the norm reaches the clip."""
    rng = np.random.RandomState(0)
    params = _params(rng)
    grads = [{k: (rng.randn(*v.shape) * grad_scale).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt, _ = jax_make_optimizer(lr=1e-2, total_steps=100, weight_decay=1e-2)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = opt.init(jp)
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
    ours, _ = make_optimizer(lr=1e-2, total_steps=100, weight_decay=1e-2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = ours.init(tp)
    for g in grads:
        upd, state = ours.update([torch.from_numpy(g[k]) for k in tp], state, tp)
        apply_updates(tp, upd)
    assert state.count == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        assert not np.allclose(tp[k].numpy(), params[k])


def _batch(n, seed=1):
    rng = np.random.RandomState(seed)
    return {"images": torch.from_numpy((rng.rand(n, F, H, W, 3) * 255).astype(np.float32)),
            "poses": torch.tensor([0, 0, 0, 0, 0, 0, 1.0]).repeat(n, F, 1),
            "disps": torch.ones(n, F, H // 4, W // 4),
            "intrinsics": torch.tensor([[60.0, 60.0, 32.0, 24.0]]).repeat(n, 1)}


def _model():
    torch.manual_seed(0)
    return CDVNet().eval()


def test_nan_guard_zeroes_every_gradient_and_still_steps():
    """One sample of two is NaN: the loss is the other's, every gradient is
    zeroed, and the optimizer still steps, so each parameter moves by the
    weight decay alone (optax's AdamW on zero gradients)."""
    model = _model()
    cfg = RolloutConfig(F=F, M=M, STEPS=2, MIN_FRAME=3, is_cdv=True)
    opt, _ = make_optimizer(lr=1e-3, total_steps=100, weight_decay=1e-2)
    state = init_train_state(model, opt)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    batch = _batch(2)
    batch["images"][1, 0, 0, 0, 0] = float("nan")
    step = make_train_step(model, cfg, opt)
    state, metrics = step(state, batch, key=3)
    assert float(metrics["nan_skip"]) == 1.0 and np.isfinite(float(metrics["loss"]))
    assert state.step == 1 and state.opt_state.count == 1
    jopt, _ = jax_make_optimizer(lr=1e-3, total_steps=100, weight_decay=1e-2)
    jp = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    upd, _ = jopt.update(jax.tree_util.tree_map(jnp.zeros_like, jp), jopt.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-9)
    moved = [k for k in before if not torch.equal(before[k], state.params[k].detach())]
    assert "patchify.dino.blocks.0.attn.qkv.weight" in moved
    # the same batch without the NaN: a finite step that no longer skips
    batch["images"][1, 0, 0, 0, 0] = 0.0
    state, metrics = step(state, batch, key=3)
    assert float(metrics["nan_skip"]) == 0.0 and np.isfinite(float(metrics["loss"]))


def test_checkpoint_round_trip(tmp_path):
    model = _model()
    opt, _ = make_optimizer(lr=1e-3, total_steps=100)
    state = init_train_state(model, opt)
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, p in enumerate(state.params.values())]
    upd, opt_state = opt.update(grads, state.opt_state, state.params)
    apply_updates(state.params, upd)
    state = state._replace(opt_state=opt_state, step=7)
    save_checkpoint(tmp_path / "ckpt" / "cdv_000007.pt", state)
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    fresh = _model()
    restored = load_checkpoint(tmp_path / "ckpt" / "cdv_000007.pt", init_train_state(fresh, opt))
    assert restored.step == 7 and restored.opt_state.count == 1
    for (k, v), mu, nu, mu0, nu0 in zip(restored.params.items(), restored.opt_state.mu,
                                        restored.opt_state.nu, opt_state.mu, opt_state.nu):
        assert torch.equal(v.detach(), saved[k]) and torch.equal(mu, mu0) and torch.equal(nu, nu0)
    assert torch.equal(fresh.state_dict()["patchify.xfeat.block1.0.layer.1.running_var"],
                       saved["patchify.xfeat.block1.0.layer.1.running_var"])


def test_loss_decreases_over_30_steps():
    """As tests/test_train.py holds the JAX trainer: a fixed batch and key,
    lr 3e-4; the mean of the last three losses below 0.9 of the first
    three's (measured 0.20)."""
    model = _model()
    cfg = RolloutConfig(F=F, M=M, STEPS=2, MIN_FRAME=3, is_cdv=True)
    opt, _ = make_optimizer(lr=3e-4, total_steps=200)
    state = init_train_state(model, opt)
    step = make_train_step(model, cfg, opt)
    batch = _batch(1)
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch, key=3)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    assert last < 0.9 * first, (first, last, losses)
