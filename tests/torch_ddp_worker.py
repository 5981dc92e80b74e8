"""One process of tests/test_torch_ddp.py's two-process run, or the
single-process reference run: the gradient of one train-step loss of a
seeded CDVNet on a seeded batch of two clips (F 4, M 4, 48 x 64).

    python torch_ddp_worker.py RANK WORLD PORT OUT

RANK and WORLD 0 1 run the whole batch in this process (no process group);
otherwise the process joins a gloo group at tcp://localhost:PORT, takes
its share of the batch and sums the gradients over the group. Rank 0 (or
the single process) saves {"loss", "any_nan", "grads"} to OUT with
torch.save.
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cdvslam_tpu_torch.models import CDVNet  # noqa: E402
from cdvslam_tpu_torch.parallel import ddp  # noqa: E402
from cdvslam_tpu_torch.train import RolloutConfig, make_loss_fn, trainable  # noqa: E402

F, M, H, W = 4, 4, 48, 64


def batch(n=2, seed=0):
    rng = np.random.RandomState(seed)
    return {"images": torch.from_numpy((rng.rand(n, F, H, W, 3) * 255).astype(np.float32)),
            "poses": torch.tensor([0, 0, 0, 0, 0, 0, 1.0]).repeat(n, F, 1),
            "disps": torch.ones(n, F, H // 4, W // 4),
            "intrinsics": torch.tensor([[60.0, 60.0, 32.0, 24.0]]).repeat(n, 1)}


def main(rank, world, port, out):
    torch.set_num_threads(2)
    if world > 1:
        ddp.init_process_group(rank, world, port)
    torch.manual_seed(rank)          # a different init on each rank ...
    model = CDVNet().eval()
    leaves = trainable(model)
    torch.manual_seed(0)
    ref = CDVNet().eval().state_dict()
    if rank == 0:
        model.load_state_dict(ref)
    ddp.replicate(list(leaves.values()))   # ... replaced by rank 0's
    shard, offset = ddp.shard_batch(batch())
    loss_fn = make_loss_fn(model, RolloutConfig(F=F, M=M, STEPS=2, MIN_FRAME=3, is_cdv=True))
    loss, (_, any_nan) = loss_fn(shard, key=5, offset=offset)
    loss.backward()
    grads = ddp.sum_grads([t.grad for t in leaves.values()])
    total = ddp.sum_across(loss.detach())
    if rank == 0:
        torch.save({"loss": float(total), "any_nan": bool(any_nan),
                    "grads": dict(zip(leaves, grads))}, out)
    if world > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
