"""Train CDVNet or VONet on TartanAir (the port's ``train_cdvo.py`` and
``train_dpvo.py``).

    python -m cdvslam_tpu_torch.train.cli cdv [--device cpu] [options]
    python -m cdvslam_tpu_torch.train.cli dpv [options]

CDV alternates the sparse recipe (F = n_frames, 80 patches, ``--iter``
steps) and the dense one (4 frames, 1530 patches, 4 steps) 50/50; DPVO
runs the sparse recipe with 96 patches. ``--schedule`` (a comma-separated
list of "sparse" and "dense", one per training step) fixes the modes and
the run's length, while ``--steps`` still sets the learning-rate schedule
(the one-cycle schedule is NaN below 100 steps, as optax's is). The
networks start from seeded random weights (``--seed``) or ``--ckpt``.
Training runs on the card unless ``--device cpu``; ``--compute_dtype
bfloat16`` runs the networks in bf16 on float32 master weights. With
``--world_size N`` the process joins a ``torch.distributed`` group at
tcp://localhost:``--port`` as ``--rank`` and takes its share of each batch
(each process runs the same data order). Every ``--eval_every`` steps rank
0 saves the state under ``--outdir`` and, for CDVNet, runs the in-training
validation of ``train_cdvo.py``: the TartanAir validation split
(``eval.tartan.evaluate``, scenes ``--eval_datapath/*/Easy/*``, by default
``--datapath``) with ``config/default_cdvo.yaml`` and the weights under
training, on the training device; it is skipped when that path is not a
directory, a directory without a scene raises before the first step, and
a validation that fails raises (the JAX trainer prints the error and goes
on, and runs a randomly initialised network).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.tartan import TartanAirDataset
from ..models import CDVNet, VONet
from ..parallel import ddp
from .checkpoint import load_checkpoint, save_checkpoint
from .logger import Logger
from .rollout import RolloutConfig
from .trainer import init_train_state, make_optimizer, make_train_step


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("network", choices=("cdv", "dpv"))
    ap.add_argument("--name", default=None, help="run name (default: cdv or dpvo)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--steps", type=int, default=240000)
    ap.add_argument("--lr", type=float, default=8e-5)
    ap.add_argument("--clip", type=float, default=10.0)
    ap.add_argument("--n_frames", type=int, default=15)
    ap.add_argument("--iter", type=int, default=18)
    ap.add_argument("--pose_weight", type=float, default=10.0)
    ap.add_argument("--flow_weight", type=float, default=0.1)
    ap.add_argument("--datapath", default="datasets/TartanAir")
    ap.add_argument("--scene_info", default="datasets/TartanAir.pickle")
    ap.add_argument("--crop_size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--batch_per_device", type=int, default=1)
    ap.add_argument("--eval_every", type=int, default=10000)
    ap.add_argument("--eval_datapath", default=None,
                    help="the validation's TartanAir root (default: --datapath)")
    ap.add_argument("--outdir", default="checkpoints")
    ap.add_argument("--logdir", default="runs", help="TensorBoard logs")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--schedule", default=None,
                    help="comma-separated sparse/dense modes, one per step: the run's length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world_size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=29500)
    return ap


def configs(args):
    """{mode: RolloutConfig} of the network's recipes."""
    common = dict(flow_weight=args.flow_weight, pose_weight=args.pose_weight,
                  compute_dtype=args.compute_dtype)
    if args.network == "dpv":
        return {"sparse": RolloutConfig(F=args.n_frames, M=96, STEPS=args.iter, is_cdv=False,
                                        **common)}
    return {"sparse": RolloutConfig(F=args.n_frames, M=80, STEPS=args.iter, is_cdv=True, **common),
            "dense": RolloutConfig(F=4, M=1530, STEPS=4, MIN_FRAME=4, is_cdv=True, **common)}


def main(argv=None, on_step=None):
    """Train; returns one record per step (mode, loss, ms, metrics).
    ``on_step(record, state)``, when given, is called after each step."""
    args = parser().parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on the CPU")
    device = torch.device(args.device or "cuda")
    if args.world_size > 1:
        ddp.init_process_group(args.rank, args.world_size, args.port, str(device))
    name = args.name or ("cdv" if args.network == "cdv" else "dpvo")
    torch.manual_seed(args.seed)
    model = (CDVNet() if args.network == "cdv" else VONet()).to(device).eval()
    optimizer, _ = make_optimizer(args.lr, args.steps, args.clip)
    state = init_train_state(model, optimizer)
    ddp.replicate(list(state.params.values()))
    if args.ckpt:
        state = load_checkpoint(args.ckpt, state)
    steps = {mode: make_train_step(model, cfg, optimizer) for mode, cfg in configs(args).items()}
    schedule = args.schedule.split(",") if args.schedule else None
    if schedule and any(m not in steps for m in schedule):
        raise ValueError(f"--schedule modes must be among {sorted(steps)}")
    n_steps = len(schedule) if schedule else args.steps
    if args.network == "cdv" and n_steps >= args.eval_every and ddp.rank() == 0:
        validation_path(args)      # a validation set without a scene fails now

    db = TartanAirDataset(args.datapath, n_frames=args.n_frames,
                          crop_size=tuple(args.crop_size), scene_info_path=args.scene_info)
    logger = Logger(name, logdir=args.logdir)
    rng = np.random.default_rng(12345 + args.seed)
    records = []
    B = args.world_size * args.batch_per_device
    for total, batch in enumerate(db.batches(B, n_steps), start=1):
        if schedule:
            mode = schedule[total - 1]
        else:
            mode = "sparse" if args.network == "dpv" or rng.random() < 0.5 else "dense"
        key = int(rng.integers(2 ** 31))
        if mode == "dense":
            for k in ("images", "poses", "disps"):
                batch[k] = batch[k][:, :4]
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).float().to(device)
                 for k, v in batch.items()}
        shard, offset = ddp.shard_batch(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = steps[mode](state, shard, key=key, offset=offset)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record = {"step": state.step, "mode": mode, "ms": (time.perf_counter() - t0) * 1e3,
                  **{k: float(v) for k, v in metrics.items()}}
        records.append(record)
        logger.push({k: v for k, v in record.items() if k not in ("step", "mode")})
        if on_step is not None:
            on_step(record, state)
        if total % args.eval_every == 0 and ddp.rank() == 0:
            save_checkpoint(os.path.join(args.outdir, f"{name}_{total:06d}.pt"), state)
            if args.network == "cdv":
                validate(args, model, device, logger)
    return records


def validation_path(args):
    """The validation's TartanAir root, or None when it is not a directory
    (the validation is then skipped, as in the JAX trainer); a directory
    with no scene under ``*/Easy/*`` raises."""
    from ..eval import tartan

    datapath = args.eval_datapath or args.datapath
    if not os.path.isdir(datapath):
        return None
    if not tartan.validation_scenes(datapath):
        raise FileNotFoundError(
            f"no validation scene under {datapath}/*/Easy/* (the training layout is "
            "scene/scene/Easy/P: pass --eval_datapath ROOT/scene)")
    return datapath


def validate(args, model, device, logger):
    """The in-training validation (reference train_cdvo.py:219-224): the
    TartanAir validation split with ``config/default_cdvo.yaml`` and the
    model's current weights; the summary goes to the logger and is
    returned (None when the validation data is not a directory)."""
    from ..eval import tartan
    from ..eval.harness import default_parser, load_cfg

    datapath = validation_path(args)
    if datapath is None:
        print(f"[validation] skipped: {args.eval_datapath or args.datapath} is not a directory")
        return None
    eargs = default_parser("--datapath", datapath).parse_args(
        ["--config", "config/default_cdvo.yaml", "--device", str(device)])
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    results = tartan.evaluate(datapath, load_cfg(eargs), eargs, trials=1, state_dict=weights)
    logger.write_dict(results)
    return results


if __name__ == "__main__":
    main()
