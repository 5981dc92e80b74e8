"""ICL-NUIM evaluation (port of ``evaluate_icl_nuim.py``; reference:
evaluate_icl_nuim.py).

    python -m cdvslam_tpu_torch.eval.icl_nuim [--icldir D] [--device cpu] ...

Timestamp association with ``max_diff`` 0.5.
"""
import os.path as osp

import numpy as np

from .harness import (
    default_parser, parse_args, evaluate_against_tum_gt, load_cfg, repo_path, run_sequence, save_results,
    summarize,
)

ICL_SCENES = [
    "living_room_traj0_frei_png", "living_room_traj1_frei_png",
    "living_room_traj2_frei_png", "living_room_traj3_frei_png",
    "traj0_frei_png", "traj1_frei_png", "traj2_frei_png", "traj3_frei_png",
]


def main(argv=None):
    parser = default_parser("--icldir", "datasets/ICL_NUIM")
    args = parse_args(parser, argv)
    cfg = load_cfg(args)

    results = {}
    for scene in ICL_SCENES:
        imagedir = osp.join(args.icldir, scene, "rgb")
        gt = osp.join(args.icldir, scene, "groundtruth.txt")
        if not osp.isdir(imagedir):
            print(f"[skip] {scene}")
            continue
        results[scene] = []
        for trial in range(args.trials):
            traj, tstamps = run_sequence(cfg, imagedir, repo_path("calib/icl_nuim.txt"),
                                         args.stride, version=args.version,
                                         network=args.network, device=args.device)
            ate = evaluate_against_tum_gt(traj, np.asarray(tstamps), gt, max_diff=0.5)
            results[scene].append(ate)
            print(f"{scene} trial {trial+1}: ATE {ate:.4f}")
    summary = summarize(results)
    print(summary)
    save_results("icl_nuim", results, summary, expname=args.expname,
                 network=args.network)
    return summary


if __name__ == "__main__":
    main()
