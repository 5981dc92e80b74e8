"""Training: rollout, loss, data-parallel trainer, checkpoints."""
from .rollout import Draws, RolloutConfig, build_static_edges, draw, n_visible, rollout_loss  # noqa: F401
from .trainer import (  # noqa: F401
    TrainState, init_train_state, make_loss_fn, make_optimizer, make_train_step, trainable,
)
