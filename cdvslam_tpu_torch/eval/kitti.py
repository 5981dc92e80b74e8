"""KITTI odometry 00-10 evaluation (port of ``evaluate_kitti.py``;
reference: evaluate_kitti.py).

    python -m cdvslam_tpu_torch.eval.kitti [--kittidir D] [--device cpu] ...

P0 projection-matrix calib parsing (the derived calibration goes to
results/calib/), KITTI-format GT poses, default config
default_cdvslam++.yaml.
"""
import os.path as osp

import numpy as np

from .ate import ate_rmse
from .harness import default_parser, parse_args, derived_calib, load_cfg, run_sequence, save_results, summarize

KITTI_SEQS = [f"{i:02d}" for i in range(11)]


def parse_p0_calib(calib_file):
    """P0 row of calib.txt -> fx fy cx cy (reference evaluate_kitti.py:28-60)."""
    with open(calib_file) as f:
        for line in f:
            if line.startswith("P0:"):
                vals = np.array(line.split()[1:], np.float64).reshape(3, 4)
                return np.array([vals[0, 0], vals[1, 1], vals[0, 2], vals[1, 2]])
    raise ValueError(f"no P0 in {calib_file}")


def main(argv=None):
    parser = default_parser("--kittidir", "datasets/KITTI/dataset")
    parser.set_defaults(config="config/default_cdvslam++.yaml")
    args = parse_args(parser, argv)
    cfg = load_cfg(args)

    results = {}
    for seq in KITTI_SEQS:
        seqdir = osp.join(args.kittidir, "sequences", seq)
        imagedir = osp.join(seqdir, "image_0")
        gt_file = osp.join(args.kittidir, "poses", f"{seq}.txt")
        if not osp.isdir(imagedir):
            print(f"[skip] {seq}")
            continue
        cpath = derived_calib(f"kitti_{seq}", parse_p0_calib(osp.join(seqdir, "calib.txt")))

        results[seq] = []
        for trial in range(args.trials):
            traj, _ = run_sequence(cfg, imagedir, cpath, args.stride,
                                   version=args.version, network=args.network,
                                   device=args.device)
            gt = np.loadtxt(gt_file).reshape(-1, 3, 4)[:: args.stride, :, 3]
            n = min(len(traj), len(gt))
            ate = ate_rmse(traj[:n, :3], gt[:n], align=True, correct_scale=True)
            results[seq].append(ate)
            print(f"KITTI {seq} trial {trial+1}: ATE {ate:.4f}")
    summary = summarize(results)
    print(summary)
    save_results("kitti", results, summary, expname=args.expname,
                 network=args.network)
    return summary


if __name__ == "__main__":
    main()
