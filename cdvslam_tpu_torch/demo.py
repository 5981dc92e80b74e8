"""Run the port's SLAM on an image directory or a video (port of
``demo.py``; flag-compatible with the reference demo.py:58-102).

    python -m cdvslam_tpu_torch.demo --imagedir DIR --calib calib.txt \\
        [--device cpu] [--network ckpt.pth] [--version cdv|dpv] \\
        [--save_trajectory] [--plot] [--save_ply] [--save_colmap] [--timeit]

Runs on the card unless ``--device cpu``. Writes
saved_trajectories/NAME.txt (TUM format), trajectory_plots/NAME.pdf,
NAME.ply and the COLMAP text model colmap_saving/NAME/ (with the first
frame's intrinsics) under the working directory; ``--timeit`` prints the
median of each timed section ("SLAM" per frame; "patch", "keyframe" and
"update" inside it).
"""
import argparse
import os
from pathlib import Path

import numpy as np


def run(cfg, args):
    from .eval.harness import load_network
    from .slam import SLAM
    from .slam.runtime import resolve_device
    from .slam.stream import image_stream, read_frames, start_reader, video_stream
    from .utils.timer import ALL_TIMES, Timer

    device = resolve_device(args.device)
    state_dict = load_network(args.network, args.version)
    ALL_TIMES.clear()
    slam = first_intrinsics = None
    is_video = os.path.isfile(args.imagedir)
    reader = video_stream if is_video else image_stream
    q, th = start_reader(reader, args.imagedir, args.calib, args.stride, args.skip)

    for t, image, intrinsics in read_frames(q):
        if slam is None:
            h, w, _ = image.shape
            slam = SLAM(cfg, network=args.version, ht=h, wd=w, viz=args.viz, device=device,
                        state_dict=state_dict)
            slam.enable_timing = args.timeit
            first_intrinsics = intrinsics

        image = image[..., ::-1].copy()  # BGR -> RGB like the reference upload
        with Timer("SLAM", enabled=args.timeit, device=device):
            slam(t, image, intrinsics)
    th.join()

    poses, tstamps = slam.terminate()

    if args.timeit:
        for name, times in ALL_TIMES.items():
            print(f"{name}: median {np.median(times)*1000:.2f} ms over {len(times)} calls")

    if args.save_trajectory:
        Path("saved_trajectories").mkdir(exist_ok=True)
        from .viz.plot import save_trajectory_tum_format
        save_trajectory_tum_format((poses, tstamps), f"saved_trajectories/{args.name}.txt")

    if args.save_ply:
        from .viz.plot import save_ply
        save_ply(args.name, slam)

    if args.save_colmap:
        from .viz.plot import save_output_for_COLMAP
        save_output_for_COLMAP(f"colmap_saving/{args.name}", slam, *first_intrinsics)

    if args.plot:
        from .viz.plot import plot_trajectory
        Path("trajectory_plots").mkdir(exist_ok=True)
        plot_trajectory((poses, tstamps), title=f"CDV-SLAM {args.name}",
                        filename=f"trajectory_plots/{args.name}.pdf")

    return poses, tstamps


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", type=str, default="")
    ap.add_argument("--imagedir", type=str, required=True)
    ap.add_argument("--calib", type=str, required=True)
    ap.add_argument("--name", type=str, default="result")
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--version", type=str, default="cdv", choices=["cdv", "dpv"])
    ap.add_argument("--config", default="config/default_cdvo.yaml")
    ap.add_argument("--timeit", action="store_true")
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--save_ply", action="store_true")
    ap.add_argument("--save_colmap", action="store_true")
    ap.add_argument("--save_trajectory", action="store_true")
    ap.add_argument("--opts", nargs="+", default=[])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    from .eval.harness import config_from
    from .slam.runtime import resolve_device

    args = parser().parse_args(argv)
    resolve_device(args.device)
    cfg = config_from(args.config)
    cfg.merge_from_list(args.opts)

    print("Running with config:")
    print(cfg)
    return run(cfg, args)


if __name__ == "__main__":
    main()
