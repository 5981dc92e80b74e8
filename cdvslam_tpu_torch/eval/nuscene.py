"""nuScenes CAM_FRONT evaluation at half resolution (port of
``evaluate_nuscene.py``; reference: evaluate_nuscene.py).

    python -m cdvslam_tpu_torch.eval.nuscene [--nuscdir D] [--scenes ...] [--device cpu]

The half-resolution intrinsics go to results/calib/.
"""
import os
import os.path as osp

import numpy as np

from .ate import ate_rmse
from .harness import default_parser, parse_args, derived_calib, load_cfg, run_sequence, save_results, summarize

# half-resolution CAM_FRONT intrinsics (reference evaluate_nuscene.py:60-87)
NUSC_CALIB = np.array([1266.417 / 2, 1266.417 / 2, 816.267 / 2, 491.507 / 2])


def main(argv=None):
    parser = default_parser("--nuscdir", "datasets/nuscenes")
    parser.add_argument("--scenes", nargs="+", default=[])
    args = parse_args(parser, argv)
    cfg = load_cfg(args)

    scenes = args.scenes or sorted(
        d for d in os.listdir(args.nuscdir) if d.startswith("scene")
    ) if osp.isdir(args.nuscdir) else []

    results = {}
    for scene in scenes:
        imagedir = osp.join(args.nuscdir, scene, "CAM_FRONT")
        gt_file = osp.join(args.nuscdir, scene, "poses.txt")
        if not osp.isdir(imagedir):
            continue
        cpath = derived_calib(f"nusc_{scene}", NUSC_CALIB)
        results[scene] = []
        for trial in range(args.trials):
            traj, _ = run_sequence(cfg, imagedir, cpath, args.stride,
                                   version=args.version, network=args.network,
                                   device=args.device)
            if osp.exists(gt_file):
                gt = np.loadtxt(gt_file)
                n = min(len(traj), len(gt))
                ate = ate_rmse(traj[:n, :3], gt[:n, :3], align=True, correct_scale=True)
            else:
                ate = float("nan")
            results[scene].append(ate)
            print(f"{scene} trial {trial+1}: ATE {ate:.4f}")
    summary = summarize(results)
    print(summary)
    save_results("nuscene", results, summary, expname=args.expname,
                 network=args.network)
    return summary


if __name__ == "__main__":
    main()
