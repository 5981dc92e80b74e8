"""Shared evaluation harness for the dataset evaluations (port of
``cdvslam_tpu.eval.harness``).

Implements the reference protocol (reference: evaluate_tartan.py:63-70,
143-161): run SLAM over a sequence, associate timestamps, Sim3-aligned ATE
RMSE of the translation part, multi-trial medians, AUC = mean(max(1-ate,0)).

The SLAM runs on the card unless the caller passes ``device="cpu"``
(``--device cpu``); without a card it raises before reading a frame.
Relative paths of configs, calibration files and the shipped ground truth
are looked up in the working directory first, then in the checkout
(``repo_path``). Unlike the JAX package, a ``--network`` or ``--config``
that does not exist raises instead of running random weights or the
defaults.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .ate import ate_rmse, associate_timestamps

ROOT = Path(__file__).resolve().parents[2]


def repo_path(path):
    """``path`` as given when it exists or is absolute, else under the
    checkout (where ``config/``, ``calib/`` and ``datasets/`` live)."""
    p = Path(path)
    if p.is_absolute() or p.exists():
        return str(p)
    return str(ROOT / p)


def load_network(network, version="cdv"):
    """The state dict of a reference checkpoint (``models.convert.
    load_torch_checkpoint``), or None for ``network`` "" (random weights);
    a path that does not exist raises."""
    if not network:
        return None
    if not Path(network).exists():
        raise FileNotFoundError(f"network checkpoint not found: {network}")
    from ..models.convert import load_torch_checkpoint
    return load_torch_checkpoint(network, version=version)[0]


def run_sequence(cfg, imagedir, calib, stride=1, skip=0, version="cdv",
                 network="", viz=False, crop_border=None,
                 slam_sink=None, device=None, **slam_kwargs):
    """Run the SLAM loop over an image directory; returns (poses, tstamps).

    ``device``: the SLAM's device (the card when None); ``slam_kwargs`` go
    to ``SLAM``: ``state_dict`` (the network's weights; else ``network``'s
    checkpoint, else random weights), ``patch_sampler``, ...
    ``slam_sink``: optional list; the SLAM instance is appended before
    terminate() so callers (smoke tests) can inspect runtime state such as
    ``slam.stats`` feature-fire counters."""
    from ..slam import SLAM
    from ..slam.runtime import resolve_device
    from ..slam.stream import image_stream, read_frames, start_reader

    device = resolve_device(device)
    if "state_dict" not in slam_kwargs:
        slam_kwargs["state_dict"] = load_network(network, version)
    q, th = start_reader(image_stream, imagedir, calib, stride, skip,
                         crop_border=crop_border)
    slam = None
    for t, image, intrinsics in read_frames(q):
        if slam is None:
            h, w, _ = image.shape
            slam = SLAM(cfg, network=version, ht=h, wd=w, viz=viz, device=device,
                        **slam_kwargs)
        slam(t, image[..., ::-1].copy(), intrinsics)
    th.join()
    if slam_sink is not None:
        slam_sink.append(slam)
    return slam.terminate()


def evaluate_against_tum_gt(traj_est, tstamps, gt_file, t_scale=1.0, max_diff=0.08):
    """ATE vs a TUM-format ground-truth file (t x y z qx qy qz qw)."""
    gt = np.loadtxt(gt_file)
    if gt.ndim == 1:
        gt = gt[None]
    # strip comments already handled by loadtxt; columns: t, xyz, quat
    ia, ib = associate_timestamps(np.asarray(tstamps) * t_scale, gt[:, 0], max_diff)
    if len(ia) < 3:
        return float("inf")
    return ate_rmse(traj_est[ia, :3], gt[ib, 1:4], align=True, correct_scale=True)


def evaluate_against_pose_array(traj_est, gt_poses):
    """ATE vs a (N, >=3) pose array aligned index-by-index."""
    n = min(len(traj_est), len(gt_poses))
    return ate_rmse(traj_est[:n, :3], gt_poses[:n, :3], align=True, correct_scale=True)


def summarize(results):
    """Per-scene medians + AVG + AUC (reference evaluate_tartan.py:143-161)."""
    out = {}
    all_ates = []
    meds = []
    for scene, ates in results.items():
        med = float(np.median(ates))
        out[scene] = med
        meds.append(med)
        all_ates.extend(ates)
    out["AVG"] = float(np.mean(meds)) if meds else float("nan")
    out["AUC"] = float(np.maximum(1 - np.array(all_ates), 0).mean()) if all_ates else 0.0
    return out


def default_parser(datadir_flag, datadir_default):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--version", type=str, default="cdv", choices=["cdv", "dpv"])
    parser.add_argument("--expname", default="")
    parser.add_argument("--network", type=str, default="")
    parser.add_argument("--config", default="config/default_cdvo.yaml")
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--viz", action="store_true")
    parser.add_argument("--trials", type=int, default=1)
    parser.add_argument(datadir_flag, default=datadir_default)
    parser.add_argument("--backend_thresh", type=float, default=96.0)
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--opts", nargs="+", default=[])
    parser.add_argument("--save_trajectory", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return parser


def parse_args(parser, argv=None):
    """``parser.parse_args(argv)`` with ``--device`` resolved: the card
    when it is not given, and a raise without one."""
    from ..slam.runtime import resolve_device

    args = parser.parse_args(argv)
    args.device = str(resolve_device(args.device))
    return args


def save_results(name, results, summary, expname="", network=""):
    """Append per-scene results + command line to results/{name}_{exp}.txt
    and write a timestamped snapshot (reference evaluate_tartan.py:148-150,
    232-244)."""
    import datetime
    import sys

    os.makedirs("results", exist_ok=True)
    path = os.path.join("results", f"{name}_{expname}.txt")
    with open(path, "a") as f:
        print(network, "\n", file=f)
        print(" ".join(sys.argv), "\n", file=f)
        for k, v in results.items():
            print(k, v, file=f)
        print(summary, "\n", file=f)
    stamp = datetime.datetime.now().strftime("%m-%d-%I%p")
    with open(os.path.join("results", f"{name}-{stamp}.txt"), "w") as f:
        all_vals = [x for v in results.values()
                    for x in (v if isinstance(v, (list, tuple)) else [v])]
        f.write(",".join(str(x) for x in all_vals))
    return path


def derived_calib(name, calib):
    """Write a derived calibration row (KITTI's P0, nuScenes' half
    resolution) to results/calib/{name}.txt and return its path."""
    os.makedirs(os.path.join("results", "calib"), exist_ok=True)
    path = os.path.join("results", "calib", f"{name}.txt")
    np.savetxt(path, np.asarray(calib, np.float64)[None])
    return path


def config_from(path):
    """``get_cfg()`` merged with the config file ``path`` (none for "");
    a file that does not exist raises."""
    from ..config import get_cfg

    cfg = get_cfg()
    if path:
        config = repo_path(path)
        if not os.path.exists(config):
            raise FileNotFoundError(f"config not found: {path}")
        cfg.merge_from_file(config)
    return cfg


def load_cfg(args):
    cfg = config_from(args.config)
    cfg.BACKEND_THRESH = args.backend_thresh
    cfg.merge_from_list(args.opts)
    return cfg
