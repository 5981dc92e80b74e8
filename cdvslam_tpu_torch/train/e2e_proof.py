"""Trained-weights end-to-end proof (port of ``tools/train_e2e_proof.py``).

    python -m cdvslam_tpu_torch.train.e2e_proof [--steps 1500] [--device cpu]
        [--ckpt PATH] [--eval-only CKPT] [--json PATH]

Trains a CDVNet from seeded random weights on rendered planar-scene clips
(``data.render``: exact plane geometry, so the poses and inverse depths
are the ground truth), then runs the whole SLAM on a held-out texture and
trajectory with the trained weights and with random ones, and compares
the two ATEs. A disagreement anywhere between the training rollout and
the runtime (feature layouts, corr ordering, patch selection, what the
weights mean) leaves the trained network no better than a random one.

The recipe is the tool's: 240 x 320 clips of F = 8 frames, M = 32
patches, 10 update steps from frame 4 on (CDVNet at full width, DINOv2
ViT-S/14); a pool of 48 clips over the textures of seeds 0-3, drawn with
``RandomState(0)``; disparities normalized as the TartanAir reader does
(s = 0.7 q98); float32; AdamW at lr 2e-4 under the one-cycle schedule
over max(steps, 100) steps (it is NaN below 100). The evaluation runs the
``get_cfg()`` defaults (bf16 networks) with MOTION_PROBE_THR -1 and
BUFFER_SIZE 256 on 40 frames of ``overhead_loop_poses(40, height=1.6,
radius=0.7)`` over the texture of seed 11, at the SLAM seeds 0-4 (the
seed draws the patch centres, and the random weights): the tool's figures
are seed 0's, and the ATEs of every seed give the spread to read them
against. The loss curve (every 25 steps) goes to stderr, the tool's JSON
line to stdout; ``--json`` also writes the curve, the step times and the
result to a file. It runs on the card unless ``--device cpu``, and without
a card it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HT, WD = 240, 320
INTR = np.array([140.0, 140.0, 160.0, 120.0], np.float64)
F, M, STEPS, MIN_FRAME = 8, 32, 10, 4
POOL, TEXTURES = 48, 4
EVAL_FRAMES = 40
EVAL_SEEDS = (0, 1, 2, 3, 4)
CKPT_PATH = os.path.join("checkpoints", "e2e_proof.pt")


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def make_clip(scene, rng):
    """One training clip over ``scene``: F frames of ``random_walk_poses``,
    their images (F, H, W, 3) float32, world->cam poses (F, 7), inverse
    depths at quarter resolution (F, H/4, W/4) and the intrinsics (4,),
    normalized as the TartanAir reader does (s = 0.7 q98 of the
    disparities; disparities / s, translations * s). Float64 geometry."""
    from ..data.render import random_walk_poses
    poses = random_walk_poses(rng, F).astype(np.float64)
    images = np.stack([scene.render(p) for p in poses]).astype(np.float32)
    hf, wf = scene.ht // 4, scene.wd // 4
    px, py = np.meshgrid(np.arange(wf, dtype=np.float64) + 0.5,
                         np.arange(hf, dtype=np.float64) + 0.5)
    disps = np.stack([scene.true_inv_depth(p, px.reshape(-1), py.reshape(-1)).reshape(hf, wf)
                      for p in poses])
    s = 0.7 * np.quantile(disps, 0.98)
    poses[:, :3] *= s
    return images, poses, disps / s, scene.intr.copy()


def intrinsics(ht=HT, wd=WD):
    """The proof's intrinsics scaled to an ht x wd image."""
    return INTR * np.array([wd / WD, ht / HT, wd / WD, ht / HT])


def clip_pool(rng, ht=HT, wd=WD, intr=INTR, n=POOL, textures=TEXTURES):
    """n clips, clip i over the texture of seed i % textures."""
    from ..data.render import PlaneScene
    scenes = [PlaneScene(intr, ht, wd, seed=s) for s in range(textures)]
    return [make_clip(scenes[i % textures], rng) for i in range(n)]


def rollout_config():
    from .rollout import RolloutConfig
    return RolloutConfig(F=F, M=M, STEPS=STEPS, MIN_FRAME=MIN_FRAME, is_cdv=True)


def new_model(device, seed=0):
    """CDVNet with the seeded random weights training starts from."""
    from ..models import CDVNet
    torch.manual_seed(seed)
    return CDVNet().to(device).eval()


def train(steps, device, lr=2e-4, ckpt=CKPT_PATH, ht=HT, wd=WD, pool=POOL, on_step=None,
          rollout=None, key=None):
    """Train for ``steps`` steps on a clip pool at ht x wd and save the state
    to ``ckpt``; returns (model, state, records): one record per step
    (step, ms, loss and metrics; the log shows every 25th and the last).
    ``on_step(record)``, when given, is called after each step.
    ``rollout``: the RolloutConfig (the proof's by default); ``key``: the
    draws' key at every step (by default 7 + step)."""
    from .checkpoint import save_checkpoint
    from .trainer import init_train_state, make_optimizer, make_train_step

    device = torch.device(device)
    model = new_model(device)
    optimizer, _ = make_optimizer(lr=lr, total_steps=max(steps, 100))
    state = init_train_state(model, optimizer)
    step_fn = make_train_step(model, rollout or rollout_config(), optimizer)
    rng = np.random.RandomState(0)
    _log("rendering clip pool...")
    clips = clip_pool(rng, ht, wd, intrinsics(ht, wd), pool)
    records = []
    t0 = time.perf_counter()
    for it in range(steps):
        batch = {k: torch.as_tensor(v, dtype=torch.float32, device=device)[None]
                 for k, v in zip(("images", "poses", "disps", "intrinsics"),
                                 clips[rng.randint(len(clips))])}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        state, metrics = step_fn(state, batch, key=7 + it if key is None else key)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec = {"step": it, "ms": (time.perf_counter() - t) * 1e3,
               **{k: float(metrics[k]) for k in ("loss", "px1", "tr", "ro")}}
        if it % 25 == 0 or it == steps - 1:
            _log(f"step {it:5d} loss {rec['loss']:8.4f} px1 {rec['px1']:.3f} "
                 f"tr {rec['tr']:.4f} ro {rec['ro']:.4f} ({time.perf_counter() - t0:.0f}s)")
        records.append(rec)
        if on_step is not None:
            on_step(rec)
    save_checkpoint(ckpt, state)
    _log(f"checkpoint -> {ckpt}")
    return model, state, records


def load_weights(ckpt, device="cpu"):
    """The CDVNet state dict of a ``train`` checkpoint (its trainable
    tensors over the seeded model, whose other buffers training leaves as
    they are)."""
    from .checkpoint import load_checkpoint
    from .trainer import init_train_state, make_optimizer
    model = new_model(device)
    load_checkpoint(ckpt, init_train_state(model, make_optimizer()[0]))
    return {k: v.detach() for k, v in model.state_dict().items()}


def cam_centres(poses):
    """(N, 3) camera centres of world->cam poses [t, q]: -R^T t."""
    from ..data.render import _qmat
    poses = np.asarray(poses, np.float64)
    return np.stack([-_qmat(p[3:7]).T @ p[:3] for p in poses])


def ate_and_path(poses, gt):
    """The tool's ATE (Sim3-aligned RMSE of the estimated cam->world
    translations against the ground truth's camera centres) and the ground
    truth's path length, over the first min(len) frames."""
    from ..eval.ate import ate_rmse
    gt_wc = cam_centres(gt)
    k = min(len(poses), len(gt))
    ate = float(ate_rmse(poses[:k, :3], gt_wc[:k]))
    path = float(np.linalg.norm(np.diff(gt_wc[:k], axis=0), axis=-1).sum())
    return ate, path


def run_slam(state_dict, scene, gt, device, tag, sink=None, seed=0):
    """The SLAM (seeded ``seed``) over the rendered views of gt; returns
    (ATE, path length). ``sink``: optional list the SLAM is appended to."""
    from ..config import get_cfg
    from ..slam import SLAM
    cfg = get_cfg()
    cfg.MOTION_PROBE_THR = -1.0   # keep every frame: ATE on all poses
    cfg.BUFFER_SIZE = 256
    slam = SLAM(cfg, network="cdv", ht=scene.ht, wd=scene.wd, state_dict=state_dict,
                seed=seed, device=device)
    for f in range(len(gt)):
        slam(f, scene.render(gt[f]), scene.intr)
    poses, _ = slam.terminate()
    if sink is not None:
        sink.append(slam)
    ate, path = ate_and_path(poses, gt)
    _log(f"{tag}: ATE {ate:.4f} ({100 * ate / path:.1f}% of {path:.2f} path)")
    return ate, path


def evaluate(state_dict, device, ht=HT, wd=WD, frames=EVAL_FRAMES, seeds=EVAL_SEEDS,
             sink=None):
    """Trained (``state_dict``) against random weights on the held-out
    texture (seed 11) and trajectory, at each SLAM seed (trained, then
    random); returns the tool's result dict at the first seed, with every
    seed's ATEs under ``ate_trained_seeds`` and ``ate_random_seeds``.
    ``sink``: optional list the SLAMs are appended to, in run order."""
    from ..data.render import PlaneScene, overhead_loop_poses
    scene = PlaneScene(intrinsics(ht, wd), ht, wd, seed=11)
    gt = overhead_loop_poses(frames, height=1.6, radius=0.7)
    ates = {"trained": [], "random": []}
    for seed in seeds:
        for tag, weights in (("trained", state_dict), ("random", None)):
            ate, path = run_slam(weights, scene, gt, device, f"{tag} (seed {seed})", sink, seed)
            ates[tag].append(round(ate, 4))
    ate_t, ate_r = ates["trained"][0], ates["random"][0]
    return {"ate_trained": ate_t, "ate_random": ate_r,
            "path_len": round(path, 3), "trained_pct_of_path": round(100 * ate_t / path, 2),
            "improvement": round(ate_r / max(ate_t, 1e-9), 2),
            "ate_trained_seeds": ates["trained"], "ate_random_seeds": ates["random"]}


def main(argv=None):
    from ..slam.runtime import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--ckpt", default=CKPT_PATH, help="where training saves its state")
    ap.add_argument("--eval-only", metavar="CKPT", default=None,
                    help="evaluate this checkpoint without training")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the loss curve, step times and result here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    records, ckpt = [], args.eval_only
    if ckpt is None:
        _, _, records = train(args.steps, device, ckpt=args.ckpt)
        _log(f"loss first/last: {records[0]['loss']:.4f} -> {records[-1]['loss']:.4f}")
        ckpt = args.ckpt
    out = evaluate(load_weights(ckpt, device), device)
    print(json.dumps(out), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        steady = [r["ms"] for r in records[2:]]
        with open(args.json, "w") as f:
            json.dump({"steps": len(records), "device": str(device),
                       "card": torch.cuda.get_device_name(device) if device.type == "cuda"
                       else None,
                       "step_ms_median": float(np.median(steady)) if steady else None,
                       "records": records, "result": out}, f)
    return out


if __name__ == "__main__":
    main()
