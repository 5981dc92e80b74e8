"""Proximity loop closure with the seg head: the port's SLAM against the
JAX SLAM with SCORE, the linear seg head and FILTER_DYNAMIC_CLASS, and
LOOP_CLOSURE=True, classical backend off, on the loop-closure parity
test's 44 random 64 x 96 frames (KEYFRAME_THRESH=0, BACKEND_THRESH=999,
BUFFER_SIZE=108; see test_torch_loop_closure.py).

The weight an update stores for the global BA is the one its BA solved
with: the network's weight times the dynamic-class factor and the patch
score (the JAX ``weight_full``). Tolerances: equal counts, classes and
retired-edge indices; the stored weights within 5e-3 (as in
test_torch_loop_closure.py), and every stored weight of an edge on a
dynamic-class patch at most 1e-4 on both sides. Poses: the float64
triangle of ``check_against_float64``. The edges down-weighted to 1e-4
leave their patches' depths barely constrained, and the 13 global BAs
(which free pose 0) carry float32 rounding to about 1e-3 between the two
float32 runs (measured: JAX-port 1.2e-3, JAX-float64 1.9e-4,
port-float64 1.0e-3; 2.1e-5 between the two without the heads).

The depth head is left out here: with it, its scale adjustment after each
update that runs no global BA carries both float32 runs 5.7e-3 and 6.3e-3
from a float64 run, beyond the triangle's 5e-3, and the run takes over two
minutes; the depth head is held with removals in test_torch_heads_slam.py.

The Tier-1 test runs 4 patches per frame (the harness's 8 in the full
drive, marked slow): the time goes to the port's float64 run over the
growing edge set, which scales with the patches.
"""
import numpy as np
import pytest
import torch

from cdvslam_tpu_torch.models.datamaps import ADE20K_INDEX_FILT
from torch_slam_pair import HEADS, check_against_float64, dynamic_seg

torch.set_num_threads(2)


def test_loop_closure_with_heads_stores_the_multiplied_weights(monkeypatch):
    _drive(monkeypatch, 4)


@pytest.mark.slow
def test_loop_closure_with_heads_stores_the_multiplied_weights_full(monkeypatch):
    _drive(monkeypatch, 8)


def _drive(monkeypatch, patches):
    nframes = 44
    heads = {k: v for k, v in HEADS.items() if k != "DEPTH_HEAD"}
    js, ts, ws, gaps = check_against_float64(
        monkeypatch, 0.0, d_head_scale=0.5, nframes=nframes, edit_jax=dynamic_seg,
        weights_after_insert=True,
        overrides=dict(heads, LOOP_CLOSURE=True, BACKEND_THRESH=999.0,
                       BUFFER_SIZE=nframes + 64, PATCHES_PER_FRAME=patches))
    assert ts.stats["loop_edges"] > 0 and ts.stats["global_ba"] > 0
    n, M = ts.pg.n, ts.M
    seg = ts.pg.seg_[:n].numpy()
    np.testing.assert_array_equal(seg, np.asarray(js.pg.seg_dev[:n]))
    for name in ("ii_inac", "jj_inac", "kk_inac"):
        np.testing.assert_array_equal(getattr(ts.pg, name), getattr(js.pg, name), name)
    jw = np.asarray(js.pg.weight_inac)
    tw = ts.pg.tw_inac[:, 2:].numpy()
    np.testing.assert_allclose(tw, jw, atol=5e-3, rtol=0)
    kk = ts.pg.kk_inac
    dynamic = np.isin(seg.reshape(-1)[kk], ADE20K_INDEX_FILT)
    assert 0 < dynamic.mean() < 0.5
    assert (tw[dynamic] <= 1e-4).all() and (jw[dynamic] <= 1e-4).all()
    assert (tw[~dynamic] > 1e-3).mean() > 0.5
