"""A fault of the JAX runtime that the port does not copy: the fused
steady-state step reads stale seg rows.

``cdvslam_tpu/slam/runtime.py::_fused_frame_update`` computes the
dynamic-class weights (``dynamic_class_weight(pg.seg_dev, ...)``) before
it dispatches the fused program, which first applies the pending keyframe
shift and then writes the new frame's seg row. So in each frame's update
the new frame's patches take the class of a row not yet written, and
after a removal the rows from the removed frame on take the class of the
frame before the shift. The reference, the JAX init and termination
updates, and the port insert first and weight after. With the JAX step
patched to do the same (``insert_then_update`` in
tests/torch_slam_pair.py) the CDVO++ run agrees within rounding
(test_torch_heads_slam.py: 1.6e-4); unpatched it does not.
"""
import numpy as np
import torch

from torch_slam_pair import HEADS, dynamic_seg, run_pair

torch.set_num_threads(2)


def test_unpatched_jax_fused_step_weights_stale_seg_rows(monkeypatch):
    js, ts, (jp, _), (tp, _) = run_pair(monkeypatch, overrides=HEADS, edit_jax=dynamic_seg)
    assert ts.stats["keyframe_removals"] == js.stats["keyframe_removals"] > 0
    assert np.abs(tp - jp).max() > 1e-2          # measured 8.7e-2
