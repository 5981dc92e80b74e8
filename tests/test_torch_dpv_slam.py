"""Whole-SLAM parity for DPVO (``network="dpv"``): the port's SLAM against
the JAX SLAM under ``config/default_dpvo.yaml`` on 14 random 64 x 96 frames
(see tests/torch_slam_pair.py for the shared set-up: 8 patches per frame,
the JAX weights through ``vonet_state``, the JAX draws through
``patch_sampler``, the delta head at half scale), with RANDOM and with
GRADIENT_BIAS selection. With the preset's KEYFRAME_THRESH the random
network's motion falls under the threshold and frames are removed.

Tolerances: the discrete decisions (keyframe removals, kept frames,
updates, timestamps) are equal and the kept frames' patch centres are
equal exactly (the same selections). RANDOM: the poses within 1e-4
absolute per component after terminate() (measured 1.4e-5). GRADIENT_BIAS:
float32 reassociation reaches 1.03e-4 (measured), so both float32 runs are
held to a float64 run of the port by ``check_against_float64`` (the JAX run
no farther from it than 3x the port run, the two within 3e-3).
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_slam_pair import FRAMES, M, check_against_float64, run_pair

torch.set_num_threads(2)

# the preset's knobs at the harness's 8 patches per frame
DPVO = {k: v for k, v in yaml.safe_load(
    (Path(__file__).resolve().parents[1] / "config" / "default_dpvo.yaml").read_text()).items()
    if k != "PATCHES_PER_FRAME"}


@pytest.mark.parametrize("strategy", ["RANDOM", "GRADIENT_BIAS"])
def test_dpvo_slam_with_keyframe_removal_matches_jax(monkeypatch, strategy):
    overrides = dict(DPVO, CENTROID_SEL_STRAT=strategy)
    if strategy == "RANDOM":
        js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, network="dpv", overrides=overrides)
        assert ts.pg.n == js.pg.n
        np.testing.assert_array_equal(tt, jt)
        for key in ("keyframe_removals", "updates"):
            assert ts.stats[key] == js.stats[key], key
        assert tp.shape == jp.shape == (FRAMES, 7)
        np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    else:   # the discrete decisions are checked in check_against_float64
        js, ts, _, _ = check_against_float64(monkeypatch, None, d_head_scale=0.5,
                                             network="dpv", overrides=overrides)
    assert ts.pg.DIM == 384 and ts.pg.gmap_.shape[1] == 128
    assert ts.stats["keyframe_removals"] > 0
    # the kept frames' patch centres: the same selections (the BA moves depths only)
    n = ts.pg.n
    np.testing.assert_array_equal(ts.pg.patches_[:n * M, :2].numpy(),
                                  np.asarray(js.pg.patches_)[:n * M, :2])
