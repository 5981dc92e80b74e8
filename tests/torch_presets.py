"""Rendered sequences and the harness drive shared by the port's preset
tests (``test_torch_presets*.py``), the port's counterpart of
``test_fidelity_configs.py``: a textured plane seen by a camera circling
above it (``render_plane``) at 192 x 256, written as PNGs with a
calibration file, run through ``eval.harness.run_sequence`` on the CPU
with seeded random weights, ``BUFFER_SIZE`` 64 and ``MOTION_PROBE_THR``
-1 (the random network's motion probe would keep no frame)."""
import numpy as np
import torch

from render_plane import PlaneScene, overhead_loop_poses

from cdvslam_tpu_torch.eval.harness import load_cfg, run_sequence

HT, WD = 192, 256
INTR = np.array([220.0, 220.0, 128.0, 96.0], np.float32)
F = 20          # frames for the short runs
F_LONG = 44     # proximity LC needs loop pairs with j - i >= 30


def render_sequences(root, names=(("images", F),), seed=5):
    """{name: image dir} of rendered loops, and the calibration file."""
    import cv2
    scene = PlaneScene(INTR, HT, WD, seed=seed)
    dirs = {}
    for name, nf in names:
        d = root / name
        d.mkdir()
        gt = overhead_loop_poses(nf)
        for f in range(nf):
            cv2.imwrite(str(d / f"{f:06d}.png"), scene.render(gt[f])[..., ::-1])
        dirs[name] = str(d)
    calib = root / "calib.txt"
    calib.write_text(" ".join(str(float(x)) for x in INTR))
    return dirs, str(calib)


class Args:
    def __init__(self, config):
        self.config = config
        self.backend_thresh = 96.0
        self.opts = []


def smoke(sequences, config, version, stride=1, opts=(), images="images", nframes=F):
    """The preset through the harness; checks what the JAX smokes check
    (every frame's pose, finite, initialized, updates ran) and returns
    (poses, slam)."""
    dirs, calib = sequences
    torch.set_num_threads(2)
    cfg = load_cfg(Args(config))
    cfg.merge_from_list(list(opts))
    cfg.BUFFER_SIZE = 64
    cfg.MOTION_PROBE_THR = -1.0
    sink = []
    traj, tstamps = run_sequence(cfg, dirs[images], calib, stride=stride, version=version,
                                 slam_sink=sink, device="cpu")
    nexp = len(range(0, nframes, stride))
    assert traj.shape == (nexp, 7), traj.shape
    assert np.all(np.isfinite(traj)), "non-finite poses"
    slam = sink[0]
    assert slam.is_initialized, "SLAM never initialized"
    assert slam.stats["updates"] > 0, "update/BA never executed"
    return traj, slam
