"""Whole-SLAM parity with the heads (see tests/torch_slam_pair.py for the
shared set-up: 14 random 64 x 96 frames, the JAX SLAM's weights, draws,
SCORE uniforms and head weights carried into the port, the JAX steady
step inserting the frame before it weights the edges).

- (a) The CDVO++ settings: SCORE, linear seg and depth heads,
  FILTER_DYNAMIC_CLASS, with keyframe removals. The depth head's scale
  adjustment opens after every update here (rate about 0.88): each update
  rescales the window by about 12% against the BA, and this feedback
  carries float32 rounding to 1.6e-4 between the two float32 runs, so the
  runs are held by ``check_against_float64``'s float64 triangle (measured:
  JAX-port 1.6e-4, JAX-float64 1.6e-3, port-float64 1.7e-3). With the
  scale adjustment off the same run agrees within 9.6e-5.
- (b) DEPTH_HEAD="dpt_random" with RANDOM_GRID: 1e-4 per pose component
  after terminate() (measured 1.2e-5).
"""
import numpy as np
import torch

from cdvslam_tpu_torch.slam import runtime
from torch_slam_pair import FRAMES, HEADS, check_against_float64, dynamic_seg, run_pair

torch.set_num_threads(2)


def test_cdvo_pp_heads_with_removal_lie_within_rounding_of_float64(monkeypatch):
    weights, rates = [], []
    dcw, sa = runtime.dynamic_class_weight, runtime.scale_adjustment
    monkeypatch.setattr(runtime, "dynamic_class_weight",
                        lambda *a: weights.append(dcw(*a)) or weights[-1])
    monkeypatch.setattr(runtime, "scale_adjustment",
                        lambda *a: rates.append(sa(*a)[2]) or (a[0], a[1], rates[-1]))
    js, ts, ws, gaps = check_against_float64(monkeypatch, None, d_head_scale=0.5,
                                             overrides=HEADS, edit_jax=dynamic_seg,
                                             weights_after_insert=True)
    assert ts.stats["keyframe_removals"] > 0
    n, M = ts.pg.n, ts.M
    np.testing.assert_array_equal(ts.pg.seg_[:n].numpy(), np.asarray(js.pg.seg_dev[:n]))
    np.testing.assert_array_equal(ts.pg.score_[:n * M].numpy(),
                                  np.asarray(js.pg.score_dev[:n * M]))
    np.testing.assert_allclose(ts.pg.scale_[:n].numpy(), np.asarray(js.pg.scale_[:n]),
                               rtol=1e-3, atol=0)
    down = torch.cat(weights)[:, 0] < 1
    assert 0 < down.float().mean() < 0.5          # measured 0.115 of the edges
    assert sum(float(r) != 1.0 for r in rates) > 0


def test_dpt_head_matches_jax(monkeypatch):
    js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, overrides={"DEPTH_HEAD": "dpt_random"})
    assert ts.depth_is_dpt and js.depth_is_dpt
    assert ts.stats["keyframe_removals"] == js.stats["keyframe_removals"]
    np.testing.assert_array_equal(tt, jt)
    assert tp.shape == jp.shape == (FRAMES, 7)
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    n = ts.pg.n
    np.testing.assert_allclose(ts.pg.scale_[:n].numpy(), np.asarray(js.pg.scale_[:n]),
                               rtol=1e-4, atol=0)
