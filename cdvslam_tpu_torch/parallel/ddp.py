"""Data-parallel training over processes with ``torch.distributed``.

The JAX trainer shards the batch over a device mesh and XLA inserts the
gradient sum. Here each process runs its share of the batch and the
trainer sums the gradients explicitly (one ``all_reduce`` over a flat
buffer), which is what ``DistributedDataParallel`` does for a module's
forward; the rollout calls several model methods per step under
checkpointing, so the sum is taken once, after the backward pass.

``init_process_group(rank, world_size, port)`` joins a group on this host
(``tcp://localhost:<port>``; NCCL on the card, gloo on the CPU).
``replicate`` broadcasts rank 0's tensors, ``shard_batch`` takes this
process's contiguous slice of a batch, ``sum_grads`` / ``sum_across`` /
``max_across`` reduce over the processes. Without a process group, or with
one process, none of them runs a collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_process_group(rank: int, world_size: int, port: int, device: str = "cpu"):
    """Join the group at tcp://localhost:port; NCCL for a CUDA device, else gloo."""
    backend = "nccl" if str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)


def replicate(tensors):
    """Broadcast rank 0's values into ``tensors`` (in place); returns them."""
    if _active():
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, 0)
    return tensors


def shard_batch(batch: dict) -> tuple[dict, int]:
    """This process's contiguous share of a global batch dict (leading dim
    divisible by the world size) and the global index of its first sample."""
    n, r = world_size(), rank()
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} does not split over {n} processes")
    per = B // n
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}, r * per


def sum_grads(grads: list) -> list:
    """The sum of each gradient over the processes (one flat all_reduce)."""
    if not _active() or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """A scalar summed over the processes."""
    if not _active():
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def max_across(x: torch.Tensor) -> torch.Tensor:
    """A scalar's maximum over the processes (the NaN flag)."""
    if not _active():
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x
