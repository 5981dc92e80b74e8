"""The JAX training rollout and the port's on the same weights and draws.

Shared by the training parity tests. The sizes are those of
tests/test_train.py: a clip of F = 4 random 48 x 64 frames, M = 4 patches,
MIN_FRAME = 3, identity ground-truth poses, unit inverse depths. The JAX
parameters come from ``model.init`` as test_train.py makes them; the port
gets them through ``models.convert`` (``load_flax_params`` or
``vonet_state``), and so does the JAX gradient tree, so that each port
leaf is compared with the JAX leaf of the same name. The port takes the
JAX rollout's own draws (``jax_draws``: the key splits of
``rollout_loss``, evaluated under ``jax.jit`` as the rollout evaluates
them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cdvslam_tpu.models import CDVNet as JaxCDVNet, VONet as JaxVONet, build_update_aux
from cdvslam_tpu.models.patchifier import select_random, select_random_grid
from cdvslam_tpu.train import RolloutConfig as JaxRolloutConfig, rollout_loss as jax_rollout_loss
from cdvslam_tpu_torch.models import CDVNet, VONet
from cdvslam_tpu_torch.models.convert import load_flax_params, vonet_state
from cdvslam_tpu_torch.train import Draws, RolloutConfig, rollout_loss, trainable

F, M, H, W = 4, 4, 48, 64
INTR = np.array([60.0, 60.0, 32.0, 24.0], np.float32)


def _merge(a, b):
    if not isinstance(a, dict):
        return b
    out = dict(a)
    for k, v in dict(b).items():
        out[k] = _merge(out[k], v) if k in out else v
    return out


def jax_params(network):
    """Seeded flax variables ("params" and "batch_stats") of the JAX network,
    as numpy arrays."""
    key = jax.random.PRNGKey(0)
    img = jnp.zeros((F, H, W, 3))
    E = 8
    aux = build_update_aux(np.zeros(E, np.int64), np.arange(E), np.arange(E), 0, 16, M=E,
                           E_pad=E)
    net0, corr0 = jnp.zeros((1, E, 384)), jnp.zeros((1, E, 2 * 49 * 9))
    if network == "cdv":
        m = JaxCDVNet()
        parts = [m.init(key, img, method=JaxCDVNet.features_f),
                 m.init(key, img, method=JaxCDVNet.features_i),
                 m.init(key, net0, net0, corr0, aux, 16, method=JaxCDVNet.update),
                 m.init(key, jnp.zeros((1, E, 2)), method=JaxCDVNet.posenc)]
    else:
        m = JaxVONet()
        parts = [m.init(key, img, method=JaxVONet.features),
                 m.init(key, net0, net0, corr0, aux, 16, 16, method=JaxVONet.update)]
    params = {}
    for p in parts:
        params = _merge(params, dict(p))
    return m, jax.tree_util.tree_map(np.asarray, params)


def port_state(network, tree):
    """A flax tree (weights or gradients) under the port's names."""
    return load_flax_params(tree) if network == "cdv" else vonet_state(tree)


def port_model(network, params):
    model = CDVNet() if network == "cdv" else VONet()
    model.load_state_dict(port_state(network, params))
    return model.eval()


def clip(seed=0, n=None):
    """images (F, H, W, 3) in [0, 255], identity poses, unit disparities; a
    leading batch dim of n when n is given."""
    rng = np.random.RandomState(seed)
    shape = (F, H, W, 3) if n is None else (n, F, H, W, 3)
    images = (rng.rand(*shape) * 255).astype(np.float32)
    lead = () if n is None else (n,)
    poses = np.broadcast_to(np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32),
                            lead + (F, 7)).copy()
    disps = np.ones(lead + (F, H // 4, W // 4), np.float32)
    intr = np.broadcast_to(INTR, lead + (4,)).copy()
    return images, poses, disps, intr


def jax_draws(cfg, key, H=H, W=W):
    """The draws ``rollout_loss`` makes from ``key`` for cfg.F frames of
    H x W and cfg.M patches: patch centres, d0 and the dropout rolls,
    under jax.jit."""
    F, M = cfg.F, cfg.M

    @jax.jit
    def draw(key):
        key, k1 = jax.random.split(key)
        if cfg.is_cdv:
            coords = select_random_grid(k1, F, M, -(-H // 14), -(-W // 14), cfg.P, 4.0 / 14.0,
                                        True)
        else:
            coords = select_random(k1, F, M, H // 4, W // 4)
        key, k2 = jax.random.split(key)
        d0 = jax.random.uniform(k2, (F * M, 1, 1))
        key, k3, _ = jax.random.split(key, 3)
        return coords, d0.reshape(-1), jax.random.uniform(k3, (cfg.STEPS,))
    c, d0, roll = (np.asarray(x) for x in draw(key))
    return Draws(torch.from_numpy(c.copy()), torch.from_numpy(d0.copy()), roll)


def jax_loss_and_grads(network, cfg_kw, seed=1):
    """(loss, metrics, gradient tree under the port's names, flax params)."""
    model, params = jax_params(network)
    cfg = JaxRolloutConfig(**cfg_kw)
    images, poses, disps, intr = clip()
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_rollout_loss(p, model, cfg, images, poses, disps, intr,
                                   jax.random.PRNGKey(seed)), has_aux=True))
    (loss, metrics), grads = fn(params)
    grads = port_state(network, jax.tree_util.tree_map(np.asarray, grads))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, params


def port_loss_and_grads(network, cfg_kw, params, seed=1, dtype=torch.float32):
    """The port's loss, metrics and {name: gradient} on the JAX draws."""
    model = port_model(network, params).to(dtype)
    leaves = trainable(model)
    cfg = RolloutConfig(**cfg_kw)
    images, poses, disps, intr = (torch.from_numpy(a).to(dtype) for a in clip())
    draws = jax_draws(JaxRolloutConfig(**cfg_kw), jax.random.PRNGKey(seed))
    loss, metrics = rollout_loss(model, cfg, images, poses, disps, intr,
                                 draws=draws._replace(d0=draws.d0.to(dtype)))
    loss.backward()
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t)).float()
             for k, t in leaves.items()}
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def check_grads(grads, want, rel=1e-3, zero=1e-6):
    """Every leaf within rel of its own max |JAX gradient|. A leaf whose JAX
    gradient is below ``zero`` of the largest leaf's is analytically zero
    (a bias ahead of a softmax over segments or of an instance norm: a
    constant added to every logit or channel changes nothing), and both
    sides must then stay below 10 ``zero`` of the largest. Returns
    {name: (max |port - JAX|, max |JAX|)}."""
    assert set(grads) == set(want) - {k for k in want if "num_batches" in k}
    errs = {k: ((g - want[k]).abs().max().item(), want[k].abs().max().item())
            for k, g in grads.items()}
    top = max(s for _, s in errs.values())
    bad = {}
    for k, (err, scale) in errs.items():
        if scale < zero * top:
            ok = grads[k].abs().max().item() <= 10 * zero * top
        else:
            ok = err <= rel * scale
        if not ok:
            bad[k] = (err, scale)
    assert not bad, (top, bad)
    return errs
