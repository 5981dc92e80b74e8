"""EuRoC MAV evaluation (port of ``evaluate_euroc.py``; reference:
evaluate_euroc.py).

    python -m cdvslam_tpu_torch.eval.euroc [--eurocdir D] [--device cpu] ...

11 sequences, stride 2, timestamp-associated Sim3-aligned ATE vs the
shipped ground truth (TUM columns, nanosecond stamps). The images' stamps
are taken in seconds and associated in nanoseconds (``t_scale`` 1e9, the
0.08 s window as 8e7 ns): the JAX script associates seconds with the
ground truth's nanoseconds, finds no pair and reports an infinite ATE.
"""
import glob
import os

import numpy as np

from .harness import (
    default_parser, parse_args, evaluate_against_tum_gt, load_cfg, repo_path, run_sequence, save_results,
    summarize,
)

EUROC_SCENES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]


def main(argv=None):
    parser = default_parser("--eurocdir", "datasets/EUROC")
    parser.set_defaults(stride=2)
    args = parse_args(parser, argv)
    cfg = load_cfg(args)

    results = {}
    for scene in EUROC_SCENES:
        imagedir = os.path.join(args.eurocdir, scene, "mav0/cam0/data")
        gt = repo_path(f"datasets/euroc_groundtruth/{scene}.txt")
        if not os.path.isdir(imagedir):
            print(f"[skip] {scene}: no data at {imagedir}")
            continue
        results[scene] = []
        for trial in range(args.trials):
            traj, _ = run_sequence(cfg, imagedir, repo_path("calib/euroc.txt"),
                                   args.stride, version=args.version,
                                   network=args.network, viz=args.viz, device=args.device)
            images = sorted(glob.glob(os.path.join(imagedir, "*.png")))[::args.stride]
            tstamps = np.array([float(os.path.basename(x)[:-4]) for x in images]) / 1e9
            ate = evaluate_against_tum_gt(traj, tstamps[: len(traj)], gt, t_scale=1e9,
                                          max_diff=0.08e9)
            results[scene].append(ate)
            print(f"{scene} trial {trial+1}: ATE {ate:.4f}")

    summary = summarize(results)
    print(summary)
    save_results("euroc", results, summary, expname=args.expname,
                 network=args.network)
    return summary


if __name__ == "__main__":
    main()
