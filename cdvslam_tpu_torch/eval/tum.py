"""TUM-RGBD freiburg1 evaluation (port of ``evaluate_tum.py``; reference:
evaluate_tum.py).

    python -m cdvslam_tpu_torch.eval.tum [--tumdir D] [--device cpu] ...

9 fr1 sequences, timestamp-associated Sim3-aligned ATE vs each
sequence's TUM-format ground truth, with the reference's distortion
boundary crop ``crop_border=(8, 16)``.
"""
import glob
import os

import numpy as np

from .harness import (
    default_parser, parse_args, evaluate_against_tum_gt, load_cfg, repo_path, run_sequence, save_results,
    summarize,
)

TUM_SCENES = [
    "360", "desk", "desk2", "floor", "plant", "room", "rpy", "teddy", "xyz",
]


def main(argv=None):
    parser = default_parser("--tumdir", "datasets/TUM-RGBD")
    args = parse_args(parser, argv)
    cfg = load_cfg(args)

    results = {}
    for scene in TUM_SCENES:
        seq = f"rgbd_dataset_freiburg1_{scene}"
        imagedir = os.path.join(args.tumdir, seq, "rgb")
        gt = os.path.join(args.tumdir, seq, "groundtruth.txt")
        if not os.path.isdir(imagedir):
            print(f"[skip] {scene}: no data at {imagedir}")
            continue
        results[scene] = []
        for trial in range(args.trials):
            # fr1 intrinsics + distortion with the reference's boundary
            # crop (reference evaluate_tum.py:29-47)
            traj, _ = run_sequence(cfg, imagedir, repo_path("calib/tum1.txt"),
                                   args.stride, version=args.version,
                                   network=args.network, viz=args.viz,
                                   crop_border=(8, 16), device=args.device)
            images = sorted(glob.glob(os.path.join(imagedir, "*.png")))[::args.stride]
            tstamps = np.array([float(os.path.basename(x)[:-4]) for x in images])
            ate = evaluate_against_tum_gt(traj, tstamps[: len(traj)], gt)
            results[scene].append(ate)
            print(f"{scene} trial {trial+1}: ATE {ate:.4f}")

    summary = summarize(results)
    print(summary)
    save_results("tum", results, summary, expname=args.expname,
                 network=args.network)
    return summary


if __name__ == "__main__":
    main()
