"""``fast_dpvo.yaml`` (KEYFRAME_INDEX 2, REMOVAL_WINDOW 14, OPTIMIZATION_WINDOW
7, PATCH_LIFETIME 9, KEYFRAME_THRESH 12.5) held to the JAX SLAM through
``run_pair(..., network="dpv", overrides=<fast_dpvo.yaml>)`` at 64 x 96
(``torch_slam_pair``: the JAX weights and draws, MIXED_PRECISION off, the
halved delta head), with 16 patches for CPU time in place of the preset's
48 (the pair takes 60 s at 48 against 40 s at 16 on a CPU; the card runs
the preset as shipped, chip_smoke.py phase 10): the same keyframe
removals, updates and timestamps, poses within 1e-4 per component. The
run records the span of each JAX removal (the rows after
the removed one): with the lagged decision every span is KEYFRAME_INDEX
or less, inside the fixed-span shift (1 to KEYFRAME_INDEX + 2), so the
JAX generic shift path (``_shift_buffers``), which gathers neither
``seg_dev`` nor ``scale_``, is not reached by this preset either."""
import numpy as np
import yaml

from torch_slam_pair import run_pair

FAST_DPVO = "config/fast_dpvo.yaml"


def test_fast_dpvo_holds_to_jax(monkeypatch):
    with open(FAST_DPVO) as f:
        fast = yaml.safe_load(f)
    fast["PATCHES_PER_FRAME"] = 16
    spans = []

    def record_spans(js):
        """The span of each JAX removal (rows after the removed one), which
        picks the fixed-span or the generic shift."""
        apply = js._kf_apply

        def recorded(k, staging=False, **kw):
            if k is not None:
                spans.append(js.pg.n + (1 if staging else 0) - 1 - k)
            return apply(k, staging=staging, **kw)
        monkeypatch.setattr(js, "_kf_apply", recorded)

    js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, network="dpv", overrides=fast,
                                          edit_jax=record_spans)
    assert ts.M == js.M == 16 and ts.cfg.KEYFRAME_INDEX == 2
    assert js.stats["keyframe_removals"] == ts.stats["keyframe_removals"] == len(spans) > 0
    assert js.stats["updates"] == ts.stats["updates"] and js.pg.n == ts.pg.n
    assert all(1 <= s <= js.cfg.KEYFRAME_INDEX for s in spans), spans
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
