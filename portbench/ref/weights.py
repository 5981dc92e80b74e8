"""Seeded random weights for a network, made on the device in a few calls.

``state_dict(model, seed, device)`` reads the names and shapes from
``model`` (``meta_model(cls)`` builds one that holds no memory) and
draws every tensor as PyTorch's default initialisation draws it, from
two large draws of one ``torch.Generator`` on ``device``:

- linear and convolution weights and biases: uniform in +-1/sqrt(fan_in);
- the Fourier encoding's ``Wr``: normal with standard deviation 1;
- layer norms and layer scales: 1 (bias 0); the cls token and the
  position embedding: 0; batch-norm running statistics: mean 0, var 1.

The program and the reference are both handed this one dict.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _rules(model: nn.Module):
    """(name, shape, kind, arg) for every entry of model's state dict:
    kind "uniform" (arg: bound), "normal" (arg: std) or "const" (arg: value)."""
    out = []
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for name, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            full, shape = prefix + name, tuple(t.shape)
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                w = mod.weight
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                if full.endswith("Wr.weight"):
                    out.append((full, shape, "normal", 1.0))
                else:
                    out.append((full, shape, "uniform", 1.0 / math.sqrt(fan_in)))
            elif name == "num_batches_tracked":
                out.append((full, shape, "const", 0))
            elif name in ("weight", "gamma", "running_var"):
                out.append((full, shape, "const", 1.0))
            elif name in ("bias", "running_mean", "cls_token", "pos_embed", "mask_token"):
                out.append((full, shape, "const", 0.0))
            else:
                raise ValueError(f"no initialisation rule for {full} in {type(mod).__name__}")
    return out


def meta_model(cls):
    """``cls()`` on the meta device: names and shapes, no memory. Random
    initialisers are skipped while it is built (``nn.init.normal_`` on the
    meta device first imports much of torch.distributed, seconds)."""
    normal = nn.init.normal_
    nn.init.normal_ = lambda t, *args, **kwargs: t
    try:
        with torch.device("meta"):
            return cls()
    finally:
        nn.init.normal_ = normal


def state_dict(model: nn.Module, seed: int, device) -> dict:
    """The float32 state dict of ``model``'s shapes on ``device``, drawn from
    ``seed`` (any integer below 2**63)."""
    rules = _rules(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_uni = sum(math.prod(s) for _, s, k, _ in rules if k == "uniform")
    n_nrm = sum(math.prod(s) for _, s, k, _ in rules if k == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_nrm, generator=gen, device=device)
    sd, ou, on = {}, 0, 0
    for name, shape, kind, arg in rules:
        size = math.prod(shape)
        if kind == "uniform":
            sd[name] = (uni[ou:ou + size] * arg).view(shape)
            ou += size
        elif kind == "normal":
            sd[name] = (nrm[on:on + size] * arg).view(shape)
            on += size
        elif name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            sd[name] = torch.full(shape, float(arg), device=device)
    return sd
