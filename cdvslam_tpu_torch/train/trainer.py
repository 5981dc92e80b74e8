"""Data-parallel trainer (port of ``cdvslam_tpu.train.trainer``).

The JAX trainer is optax's AdamW after a global-norm clip, with a linear
one-cycle learning-rate schedule, over every leaf of the flax variables.
Here the same formulas are written out over the model's trainable tensors:
its parameters and, as in the JAX package (whose leaves include XFeat's
``batch_stats``), its floating-point buffers, which the rollout then
differentiates (``models.xfeat.BasicLayer``).

A train step runs the rollout of every sample of the batch (this process's
share of it under ``torch.distributed``), takes the mean loss over the
samples that are not NaN, backpropagates, sums the gradients over the
processes, and applies the lock-step NaN guard: when any sample of the
global batch is NaN (an ``all_reduce(MAX)`` of the flag) every gradient is
zeroed, and so is any gradient leaf holding a NaN; the optimizer still
steps (moments decay, weight decay applies), as the JAX step does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel import ddp
from .rollout import RolloutConfig, rollout_loss


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


class TrainState(NamedTuple):
    params: dict          # name -> trainable tensor, shared with the model
    opt_state: AdamState
    step: int


def trainable(model) -> dict:
    """The leaves the JAX trainer updates: parameters and float buffers
    (the XFeat BatchNorm statistics), marked to take gradients."""
    leaves = dict(model.named_parameters())
    for name, buf in model.named_buffers():
        if buf.is_floating_point():
            buf.requires_grad_(True)
            leaves[name] = buf
    return leaves


def onecycle_schedule(lr: float, total_steps: int, pct_start: float = 0.01,
                      pct_final: float = 1.0, div_factor: float = 25.0,
                      final_div_factor: float = 1e4):
    """``optax.linear_onecycle_schedule`` written out, in float32: linear
    interpolation between the running products of the scales at the
    boundaries {pct_start T: div, pct_final T: 1/div, T: 1/final_div} (a
    later boundary at the same step replaces an earlier one)."""
    scales = {}
    for b, s in ((int(pct_start * total_steps), div_factor),
                 (int(pct_final * total_steps), 1.0 / div_factor),
                 (total_steps, 1.0 / final_div_factor)):
        scales[b] = s
    bounds_, s_ = zip(*sorted(scales.items()))
    bounds = np.array((0,) + bounds_)
    values = np.cumprod(np.array((lr / div_factor,) + s_)).astype(np.float32)
    sizes = (bounds[1:] - bounds[:-1]).astype(np.float32)

    def schedule(count: int) -> np.float32:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (np.float32(count) - bounds[:-1].astype(np.float32)) / sizes
            interp = values[:-1] + pct * (values[1:] - values[:-1])
            indicator = ((bounds[:-1] <= count) & (count < bounds[1:])).astype(np.float32)
            return np.float32(indicator @ interp + np.float32(bounds[-1] <= count) * values[-1])

    return schedule


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(schedule, weight_decay))."""

    def __init__(self, schedule, clip=10.0, weight_decay=1e-6, b1=0.9, b2=0.999, eps=1e-8):
        self.schedule, self.clip, self.wd = schedule, clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params.values()],
                         [torch.zeros_like(p) for p in params.values()])

    @torch.no_grad()
    def update(self, grads: list, state: AdamState, params: dict):
        """-> (updates, new state), as optax's ``update``."""
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        # clip_by_global_norm: scale by clip / norm only when norm >= clip
        keep = gnorm < self.clip
        grads = [torch.where(keep, g, g / gnorm * self.clip) for g in grads]
        count = state.count + 1
        f32 = torch.float32
        c1 = 1 - torch.tensor(self.b1, dtype=f32) ** count
        c2 = 1 - torch.tensor(self.b2, dtype=f32) ** count
        lr = float(self.schedule(state.count))
        mu, nu, updates = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params.values()):
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * (g * g) + self.b2 * v
            u = (m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device)) + self.eps)
            u = u + self.wd * p
            updates.append(torch.tensor(-lr, dtype=u.dtype, device=u.device) * u)
            mu.append(m)
            nu.append(v)
        return updates, AdamState(count, mu, nu)


@torch.no_grad()
def apply_updates(params: dict, updates: list):
    for p, u in zip(params.values(), updates):
        p.add_(u)


def make_optimizer(lr=8e-5, total_steps=240000, clip=10.0, weight_decay=1e-6):
    """AdamW with the linear one-cycle schedule; returns (optimizer, schedule)."""
    sched = onecycle_schedule(lr, total_steps)
    return AdamW(sched, clip=clip, weight_decay=weight_decay), sched


def sample_generator(key: int, index: int, device) -> torch.Generator:
    """The generator of global sample ``index`` of the step keyed ``key``."""
    return torch.Generator(device=device).manual_seed(int(key) * 1000003 + int(index))


def make_loss_fn(model, cfg: RolloutConfig):
    """loss_fn(batch, key, draws=None, offset=0) -> (loss, (metrics, any_nan)).

    batch: images (B, F, H, W, 3), poses (B, F, 7), disps (B, F, H/4, W/4),
    intrinsics (B, 4), this process's samples; ``offset`` is the global index
    of its first sample. Sample b draws from ``sample_generator(key, offset
    + b)`` unless ``draws`` gives its ``Draws``. The loss is the sum of the
    finite sample losses over the global count of finite samples; any_nan
    is global (collectives only under ``torch.distributed``).
    """

    def loss_fn(batch, key=0, draws=None, offset=0):
        B = batch["images"].shape[0]
        losses, mets = [], []
        for b in range(B):
            gen = None if draws is not None else sample_generator(
                key, offset + b, batch["images"].device)
            loss, met = rollout_loss(
                model, cfg, batch["images"][b], batch["poses"][b], batch["disps"][b],
                batch["intrinsics"][b], generator=gen,
                draws=None if draws is None else draws[b])
            losses.append(loss)
            mets.append(met)
        losses = torch.stack(losses)
        isnan = torch.isnan(losses)
        n_ok = ddp.sum_across((~isnan).sum().float())
        any_nan = ddp.max_across(isnan.any().float()) > 0
        loss = torch.where(isnan, torch.zeros_like(losses), losses).sum() / n_ok.clamp(min=1)
        metrics = {k: torch.stack([m[k] for m in mets]).float().mean() for k in mets[0]}
        return loss, (metrics, any_nan)

    return loss_fn


def make_train_step(model, cfg: RolloutConfig, optimizer: AdamW):
    """train_step(state, batch, key, draws=None, offset=0) -> (state, metrics)."""
    loss_fn = make_loss_fn(model, cfg)

    def train_step(state: TrainState, batch, key=0, draws=None, offset=0):
        params = state.params
        for p in params.values():
            p.grad = None
        loss, (metrics, any_nan) = loss_fn(batch, key, draws, offset)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params.values()]
        grads = ddp.sum_grads(grads)
        # lock-step NaN guard: zero every gradient when any sample is NaN,
        # and any leaf holding a NaN; the optimizer still steps
        grads = [torch.where(any_nan | torch.isnan(g).any(), torch.zeros_like(g), g)
                 for g in grads]
        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        out = {"loss": ddp.sum_across(loss.detach()), "nan_skip": any_nan.float(),
               **{k: v.detach() for k, v in metrics.items()}}
        return TrainState(params, opt_state, state.step + 1), out

    return train_step


def init_train_state(model, optimizer: AdamW) -> TrainState:
    params = trainable(model)
    return TrainState(params, optimizer.init(params), 0)
