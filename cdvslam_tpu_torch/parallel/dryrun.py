"""Data-parallel dry run (port of ``cdvslam_tpu.parallel.dryrun``).

    python -m cdvslam_tpu_torch.parallel.dryrun N [--device cpu]

Runs one data-parallel training step of a seeded CDVNet on a seeded batch
of N clips (F 4, M 4, 48 x 64) as N processes of a gloo group, each taking
one clip, and the same batch twice in one process, and checks that the
gradient summed over the group equals the single process's and so does
the loss. Every rank but 0 starts from other weights, which
``ddp.replicate`` overwrites with rank 0's. The JAX dry run jits the
sharded step over a virtual N-device CPU mesh; here the N devices are N
processes: on the card (the default; without one it raises unless
``--device cpu``) all of them share it, with gloo on CUDA tensors, since
NCCL takes one rank per card. Exits 0 when they agree.

Tolerance: each gradient leaf within 1e-5 of its max |gradient| and the
loss within 1e-6 relative (the group adds the clips' gradients in another
order), plus three times the distance between the two single-process runs
(0 on the CPU; on the card the scatter-adds' order changes from run to
run).

``step(rank, world, port, out, clips, device)`` is one process of it
(``python -m cdvslam_tpu_torch.parallel.dryrun --worker RANK WORLD PORT
OUT CLIPS DEVICE``): with world 1 it runs the whole batch alone, without a
group.
"""
from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

F, M, H, W = 4, 4, 48, 64


def batch(n=2, seed=0):
    """A seeded batch of n clips of F frames at H x W."""
    rng = np.random.RandomState(seed)
    return {"images": torch.from_numpy((rng.rand(n, F, H, W, 3) * 255).astype(np.float32)),
            "poses": torch.tensor([0, 0, 0, 0, 0, 0, 1.0]).repeat(n, F, 1),
            "disps": torch.ones(n, F, H // 4, W // 4),
            "intrinsics": torch.tensor([[60.0, 60.0, 32.0, 24.0]]).repeat(n, 1)}


def step(rank, world, port, out, clips=2, device="cpu"):
    """One train-step gradient of this process's share of ``batch(clips)``
    on ``device``, summed over the group; rank 0 saves {"loss", "any_nan",
    "grads"} (on the CPU) to ``out`` with torch.save."""
    from ..models import CDVNet
    from ..train import RolloutConfig, make_loss_fn, trainable
    from . import ddp

    torch.set_num_threads(2)
    if world > 1:
        ddp.init_process_group(rank, world, port)    # gloo, on CUDA tensors too
    torch.manual_seed(rank)          # a different init on each rank ...
    model = CDVNet().eval()
    torch.manual_seed(0)
    ref = CDVNet().eval().state_dict()
    if rank == 0:
        model.load_state_dict(ref)
    model.to(device)
    leaves = trainable(model)
    ddp.replicate(list(leaves.values()))   # ... replaced by rank 0's
    shard, offset = ddp.shard_batch({k: v.to(device) for k, v in batch(clips).items()})
    loss_fn = make_loss_fn(model, RolloutConfig(F=F, M=M, STEPS=2, MIN_FRAME=3, is_cdv=True))
    loss, (_, any_nan) = loss_fn(shard, key=5, offset=offset)
    loss.backward()
    grads = ddp.sum_grads([t.grad for t in leaves.values()])
    total = ddp.sum_across(loss.detach())
    if rank == 0:
        torch.save({"loss": float(total), "any_nan": bool(any_nan),
                    "grads": {k: g.cpu() for k, g in zip(leaves, grads)}}, out)
    if world > 1:
        torch.distributed.destroy_process_group()


def compare(single, again, group):
    """The dry run's checks on three saved results (two single-process
    runs and the group's): (ok, worst leaf error over its limit, loss
    error over its limit); ok when both are at most 1."""
    a, a2, b = (torch.load(p) for p in (single, again, group))
    ok = not (a["any_nan"] or a2["any_nan"] or b["any_nan"]) and a["loss"] > 0
    ok &= a["grads"].keys() == a2["grads"].keys() == b["grads"].keys()
    loss_use = abs(a["loss"] - b["loss"]) / max(
        1e-6 * abs(a["loss"]) + 3 * abs(a["loss"] - a2["loss"]), 1e-30)
    worst = 0.0
    for k, g in a["grads"].items():
        scale = max(g.abs().max().item(), 1e-12)
        ok &= bool(torch.isfinite(g).all())
        spread = (g - a2["grads"][k]).abs().max().item()
        worst = max(worst, (g - b["grads"][k]).abs().max().item() / (1e-5 * scale + 3 * spread))
    return ok and worst <= 1 and loss_use <= 1, worst, loss_use


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(n, device=None, workdir=None):
    """The dry run over n processes on ``device`` (the card when None);
    saves single.pt, single2.pt and group.pt under ``workdir`` (a new
    temporary directory when None); returns the exit code."""
    from ..slam.runtime import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        from ..ops import native
        native.build()               # once, before the processes load the kernels
    root = Path(__file__).resolve().parents[2]
    tmp = Path(workdir or tempfile.mkdtemp(prefix="cdv_dryrun_"))
    port = _free_port()

    def worker(rank, world, out):
        return subprocess.Popen([sys.executable, "-m", "cdvslam_tpu_torch.parallel.dryrun",
                                 "--worker", str(rank), str(world), str(port), str(tmp / out),
                                 str(n), str(device)],
                                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    procs = [worker(r, n, "group.pt") for r in range(n)]
    procs += [worker(0, 1, "single.pt"), worker(0, 1, "single2.pt")]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        print("\n".join(logs))
        return 1
    ok, worst, loss_use = compare(tmp / "single.pt", tmp / "single2.pt", tmp / "group.pt")
    print(f"dryrun_ddp({n}): {n} gloo processes on {device}, worst leaf error "
          f"{worst:.3e} of its limit, loss error {loss_use:.3e} of its limit: "
          f"{'ok' if ok else 'MISMATCH'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        rank, world, port, out, clips, device = argv[1:7]
        step(int(rank), int(world), int(port), out, int(clips), device)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="processes (clips in the batch)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.n, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
