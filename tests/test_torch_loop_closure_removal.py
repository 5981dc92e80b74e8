"""Whole SLAM with proximity loop closure and keyframe removals, against
the JAX SLAM: 44 random 64 x 96 frames, KEYFRAME_THRESH=0.2 (six frames
are removed, two of them before loop edges appear and four around it),
BACKEND_THRESH=999 and BUFFER_SIZE=108 as in test_torch_loop_closure.py.

Removals while loop edges are active reach the 1e-4 parity of the other
tests' float32 runs only by luck: the global BA frees the first pose
(t0 = the oldest loop edge's source frame), patch depths sit at the BA's
1e-4 floor, and float32 rounding in either framework moves the poses by
up to 1.6e-3. So, as for the full-scale delta head, both float32 runs are
held to a float64 run of the port (``check_against_float64`` in
tests/torch_slam_pair.py states the tolerances). Measured: JAX to port
1.2e-3, JAX to float64 4.4e-4, port to float64 1.6e-3; the inactive edge
stores of all three runs hold the same edges.
"""
import numpy as np
import torch

from torch_slam_pair import check_against_float64

torch.set_num_threads(2)


def test_loop_closure_with_removals_lies_within_rounding_of_float64(monkeypatch):
    nframes = 44
    js, ts, ws, _ = check_against_float64(
        monkeypatch, keyframe_thresh=0.2, d_head_scale=0.5, nframes=nframes,
        overrides={"LOOP_CLOSURE": True, "BACKEND_THRESH": 999.0,
                   "BUFFER_SIZE": nframes + 64})
    assert ts.stats["keyframe_removals"] > 0
    assert ts.stats["loop_edges"] > 0 and ts.stats["global_ba"] > 0
    for name in ("ii_inac", "jj_inac", "kk_inac"):
        np.testing.assert_array_equal(getattr(ts.pg, name), getattr(js.pg, name), name)
        np.testing.assert_array_equal(getattr(ws.pg, name), getattr(js.pg, name), name)
