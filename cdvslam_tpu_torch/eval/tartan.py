"""TartanAir evaluation (port of ``evaluate_tartan.py``; reference:
evaluate_tartan.py).

    python -m cdvslam_tpu_torch.eval.tartan [--datapath D] [--split test] [--device cpu]

Validation split (the scenes ``datapath/*/Easy/*``) or test split
(``datapath/mono/MH000-007, ME000-007``); NED->xyz GT permutation,
multi-trial medians, AUC summary. Also the trainer's in-training
validation (``evaluate(..., state_dict=...)``).
"""
import glob
import os.path as osp

import numpy as np

from .ate import ate_rmse
from .harness import default_parser, parse_args, load_cfg, repo_path, run_sequence, save_results, summarize

# reference cdvslam/data_readers/tartan.py:17-50
TEST_SPLIT = [f"MH{i:03d}" for i in range(8)] + [f"ME{i:03d}" for i in range(8)]

NED_PERM = [1, 2, 0, 4, 5, 3, 6]  # ned -> xyz (reference evaluate_tartan.py:104)


def validation_scenes(datapath):
    return sorted(glob.glob(osp.join(datapath, "*/Easy/*")))


def evaluate_scene(cfg, scene_path, args, **slam_kwargs):
    imagedir = osp.join(scene_path, "image_left")
    gt_file = osp.join(scene_path, "pose_left.txt")
    traj, tstamps = run_sequence(cfg, imagedir, repo_path("calib/tartan.txt"), args.stride,
                                 version=args.version, network=args.network,
                                 device=args.device, **slam_kwargs)
    traj_ref = np.loadtxt(gt_file, delimiter=" ")[:: args.stride, NED_PERM]
    n = min(len(traj), len(traj_ref))
    return ate_rmse(traj[:n, :3], traj_ref[:n, :3], align=True, correct_scale=True)


def evaluate(datapath="datasets/TartanAir", cfg=None, args=None, trials=1, split="validation",
             **slam_kwargs):
    """Per-scene ATE medians, AVG and AUC over the split; ``slam_kwargs``
    go to every ``SLAM`` (the trainer passes ``state_dict``)."""
    results = {}
    scenes = validation_scenes(datapath) if split == "validation" else [
        osp.join(datapath, "mono", s) for s in TEST_SPLIT
    ]
    for scene in scenes:
        if not osp.isdir(scene):
            continue
        key = "_".join(scene.split("/")[-3:])
        results[key] = []
        for _ in range(trials):
            results[key].append(evaluate_scene(cfg, scene, args, **slam_kwargs))
        print(key, sorted(results[key]))
    summary = summarize(results)
    save_results("tartan", results, summary, expname=args.expname,
                 network=args.network)
    return summary


def main(argv=None):
    parser = default_parser("--datapath", "datasets/TartanAir")
    parser.add_argument("--split", default="validation", choices=["validation", "test"])
    args = parse_args(parser, argv)
    cfg = load_cfg(args)
    summary = evaluate(args.datapath, cfg, args, trials=args.trials, split=args.split)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
