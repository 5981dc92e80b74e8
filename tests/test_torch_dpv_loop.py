"""DPV-SLAM: DPVO with the proximity loop closure (LOOP_CLOSURE=True), the
port's SLAM against the JAX SLAM, as tests/test_torch_loop_closure.py runs
CDV: 44 random 64 x 96 frames under config/default_dpvo.yaml with
KEYFRAME_THRESH=0 (so n reaches the 36 keyframes loop edges need),
BACKEND_THRESH=999 (random frames predict little common motion) and
BUFFER_SIZE=108 (frames + 64: the JAX update's window clamp never
triggers).

Loop edges and global BAs fire on both sides with equal counts, the
inactive edge stores hold the same indices, and the discrete decisions
are equal. The poses are held by the float64 triangle of
``check_against_float64`` (tests/torch_slam_pair.py): through 13 global BAs
the float32 runs drift 1.5e-3 apart (measured), and each lies as close to
a float64 run of the port as rounding allows -- the gap is reassociation,
as in the CDV runs with removals.
"""
import numpy as np
import torch

from test_torch_dpv_slam import DPVO
from torch_slam_pair import check_against_float64

torch.set_num_threads(2)


def test_dpv_slam_with_loop_closure_matches_jax(monkeypatch):
    nframes = 44
    js, ts, ws, gaps = check_against_float64(
        monkeypatch, keyframe_thresh=0.0, d_head_scale=0.5, nframes=nframes, network="dpv",
        overrides=dict(DPVO, KEYFRAME_THRESH=0.0, LOOP_CLOSURE=True, BACKEND_THRESH=999.0,
                       BUFFER_SIZE=nframes + 64, PATCHES_PER_FRAME=4))
    assert ts.stats["loop_edges"] > 0 and ts.stats["global_ba"] > 0
    for name in ("ii_inac", "jj_inac", "kk_inac"):
        np.testing.assert_array_equal(getattr(ts.pg, name), getattr(js.pg, name), name)
    print("gaps (jax-port, jax-f64, port-f64):", gaps)
