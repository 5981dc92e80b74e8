"""``SLAM.prefetch`` on the CPU: frames prefetched one ahead give bitwise
the poses of frames passed without it, every upload is used once, and at
most 4 are kept (the oldest goes first)."""
import numpy as np
import torch

from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.slam import SLAM

H, W, FRAMES = 64, 96, 12
INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)


def _slam():
    cfg = get_cfg()
    cfg.PATCHES_PER_FRAME = 8
    cfg.BUFFER_SIZE = 32
    cfg.MOTION_PROBE_THR = -1.0
    return SLAM(cfg, "cdv", ht=H, wd=W, device="cpu")


def test_prefetched_frames_give_bitwise_the_same_poses():
    rng = np.random.RandomState(0)
    frames = [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(FRAMES)]
    runs = []
    for prefetch in (False, True):
        slam = _slam()
        with torch.no_grad():
            if prefetch:
                slam.prefetch(frames[0])
            for f, img in enumerate(frames):
                if prefetch and f + 1 < FRAMES:
                    slam.prefetch(frames[f + 1])
                slam(f, img, INTR)
                assert not prefetch or id(img) not in slam._prefetched
            runs.append(slam.terminate()[0])
        assert not slam._prefetched
    assert np.array_equal(runs[0], runs[1])


def test_prefetch_keeps_at_most_four_uploads():
    slam = _slam()
    frames = [np.full((H, W, 3), k, np.uint8) for k in range(6)]
    for img in frames:
        slam.prefetch(img)
    assert list(slam._prefetched) == [id(img) for img in frames[2:]]
    image, frame, ready = slam._prefetched[id(frames[5])]
    assert image is frames[5]
    assert ready is None and frame.dtype == torch.uint8 and int(frame[0, 0, 0]) == 5
    frames[5][:] = 9            # the upload is a copy, not a view of the array
    assert int(slam._frame_on_device(frames[5])[0, 0, 0]) == 5
