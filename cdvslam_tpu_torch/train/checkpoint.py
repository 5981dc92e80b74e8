"""Training checkpoints (port of ``cdvslam_tpu.train.checkpoint``): the
trainable tensors, the optimizer state and the step, with ``torch.save``."""
from __future__ import annotations

import os

import torch

from .trainer import AdamState, TrainState


def save_checkpoint(path, state: TrainState):
    """Write ``state`` to ``path`` (its directory is created)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in state.params.items()},
                "opt_state": {"count": state.opt_state.count,
                              "mu": [t.cpu() for t in state.opt_state.mu],
                              "nu": [t.cpu() for t in state.opt_state.nu]},
                "step": state.step}, path)


def load_checkpoint(path, state: TrainState) -> TrainState:
    """Load ``path`` into ``state``'s tensors (in place, on their devices) and
    return the restored state."""
    ckpt = torch.load(path, map_location="cpu")
    if list(ckpt["params"]) != list(state.params):
        raise ValueError(f"{path}: the checkpoint's tensors are not this model's")
    with torch.no_grad():
        for name, t in state.params.items():
            t.copy_(ckpt["params"][name])
    dev = [t.device for t in state.params.values()]
    opt = ckpt["opt_state"]
    return TrainState(state.params,
                      AdamState(opt["count"], [t.to(d) for t, d in zip(opt["mu"], dev)],
                                [t.to(d) for t, d in zip(opt["nu"], dev)]),
                      ckpt["step"])
