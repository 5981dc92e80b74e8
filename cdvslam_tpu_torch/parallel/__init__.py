"""Data parallelism over processes (port of ``cdvslam_tpu.parallel``: the
JAX mesh becomes ``torch.distributed``)."""
from .ddp import (  # noqa: F401
    init_process_group, max_across, rank, replicate, shard_batch, sum_across, sum_grads,
    world_size,
)
