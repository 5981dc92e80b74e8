"""Run the JAX SLAM and the port's SLAM side by side on the same frames.

Shared by the whole-slice parity tests. Both runs use the CDV network at
64 x 96 with MIXED_PRECISION=False, PATCHES_PER_FRAME=8, BUFFER_SIZE=32,
MOTION_PROBE_THR=-1 and the 'scatter' BA assembly (``BA_ASSEMBLY`` is read
when the JAX fused program is traced). The port gets the JAX SLAM's
weights through ``load_flax_params`` and the JAX SLAM's patch draws
through its ``patch_sampler`` hook: ``fold_in(PRNGKey(7), counter)`` fed
to ``select_random_grid`` and ``uniform``, evaluated under ``jax.jit`` as
the JAX runtime evaluates them (XLA turns the grid's division by
``scale_f2i`` into a multiplication, which moves the upper-left context
gather by one token for about half the patches). With seg or depth heads
the port gets the JAX SLAM's head weights through the ``models.convert``
head functions, and under SCORE the JAX SLAM's Gumbel uniforms through
its ``score_noise`` hook, drawn under ``jax.jit`` the same way.
"""
import jax
import numpy as np
import torch

from cdvslam_tpu.config import get_cfg as jax_get_cfg
from cdvslam_tpu.models.patchifier import select_random_grid as jax_select_random_grid
from cdvslam_tpu.slam import SLAM as JaxSLAM
from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.models.convert import (
    depth_head_state, dpt_head_state, load_flax_params, seg_head_state,
)
from cdvslam_tpu_torch.slam import SLAM

H, W, M, FRAMES = 64, 96, 8, 14
INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
# The seed init's delta head, at full scale, drives the random network's
# depths into the BA's "d > 20 -> 1" reset; there the 24 terminal
# Gauss-Newton iterations amplify float32 reassociation to 1.3e-3 in the
# poses (test_torch_slam_parity_fullscale.py holds both float32 runs to a
# float64 run of the port there). At half scale the run keeps its motion
# (translations up to 0.07) and its keyframe removals, and both sides
# solve the same problem.
D_HEAD_SCALE = 0.5


def _cfg(make, keyframe_thresh, motion_probe_thr, overrides=None):
    cfg = make()
    cfg.MIXED_PRECISION = False
    cfg.PATCHES_PER_FRAME = M
    cfg.BUFFER_SIZE = 32
    cfg.MOTION_PROBE_THR = motion_probe_thr
    if keyframe_thresh is not None:
        cfg.KEYFRAME_THRESH = keyframe_thresh
    cfg.update(overrides or {})
    return cfg


def jax_patch_sampler():
    """The JAX SLAM's patch draws, for the port's ``patch_sampler`` hook."""
    hi, wi = -(-H // 14), -(-W // 14)

    @jax.jit
    def draw(counter):
        key = jax.random.fold_in(jax.random.PRNGKey(7), counter)
        coords = jax_select_random_grid(key, 1, M, hi, wi, 3, 4.0 / 14.0, True)[0]
        depth = jax.random.uniform(jax.random.fold_in(key, 1), (M, 1, 1))
        return coords, depth.reshape(M)

    def sampler(counter):
        coords, depth = draw(counter)
        return np.asarray(coords), np.asarray(depth)
    return sampler


def jax_score_noise():
    """The JAX SLAM's SCORE uniforms, for the port's ``score_noise`` hook."""
    hi, wi = -(-H // 14), -(-W // 14)

    @jax.jit
    def draw(counter):
        key = jax.random.fold_in(jax.random.PRNGKey(7), counter)
        return jax.random.uniform(key, (1, hi * wi), minval=1e-12, maxval=1.0)

    return lambda counter: np.asarray(draw(counter))[0]


def port_slam(params, keyframe_thresh=None, motion_probe_thr=-1.0, dtype=None,
              overrides=None, heads=None):
    """The port's SLAM on the CPU with the flax ``params``, the JAX draws,
    and ``heads``: the JAX SLAM whose seg and depth head weights it takes."""
    ts = SLAM(_cfg(get_cfg, keyframe_thresh, motion_probe_thr, overrides), "cdv",
              ht=H, wd=W, device="cpu", state_dict=load_flax_params(params),
              patch_sampler=jax_patch_sampler(), dtype=dtype, score_noise=jax_score_noise())
    if ts.seg_head is not None:
        ts.seg_head.load_state_dict(seg_head_state(_np(heads.seg_params)))
    if ts.depth_head is not None:
        state = dpt_head_state if ts.depth_is_dpt else depth_head_state
        ts.depth_head.load_state_dict(state(_np(heads.depth_params)))
    return ts


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


HEADS = {"CENTROID_SEL_STRAT": "SCORE", "SEG_HEAD": "random", "DEPTH_HEAD": "random",
         "FILTER_DYNAMIC_CLASS": True}


def dynamic_seg(js):
    """``edit_jax``: swap the JAX seg head's outputs 73 and 13 ("person").
    Its seeded init gives the random network's tokens at 64 x 96 the
    classes 73, 100 and 143, none of them dynamic; after the swap about
    a tenth of the edges fall on a dynamic-class patch."""
    lin = js.seg_params["params"]["linear"]
    kernel, bias = np.array(lin["kernel"]), np.array(lin["bias"])
    kernel[:, [73, 13]] = kernel[:, [13, 73]]
    bias[[73, 13]] = bias[[13, 73]]
    js.seg_params = {"params": {**js.seg_params["params"],
                                "linear": {"kernel": kernel, "bias": bias}},
                     "batch_stats": js.seg_params["batch_stats"]}


def insert_then_update(monkeypatch, js):
    """Make the JAX SLAM's steady-state step insert the frame before it
    computes the update's dynamic-class weights, as its init and
    termination updates and the port do: apply the pending keyframe shift,
    run ``_process_frame`` (which allocates the frame's slots first), then
    ``update()``, and queue the keyframe decision as the fused step does.
    The fused step (``_fused_frame_update``) computes the weights from the
    seg rows before its program shifts them and writes the new frame's
    row."""
    def step(image_dev, seed, fac, intr_row):
        pg = js.pg
        js._apply_pending_shift()
        pg.n -= 1
        try:
            js._process_frame(image_dev, seed, fac, True, intr_row)
        finally:
            pg.n += 1
        js.update()
        if pg.n - js.cfg.KEYFRAME_INDEX >= 1:
            js._kf_queue.append((int(pg.tstamps_[pg.n - js.cfg.KEYFRAME_INDEX]),
                                 js._mm_cache[2]))
    monkeypatch.setattr(js, "_fused_frame_update", step)


def frames(n=FRAMES):
    rng = np.random.RandomState(0)
    return [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(n)]


def drive_port(slam, n=FRAMES):
    """Feed n frames to a port SLAM; returns terminate()'s (poses, tstamps)."""
    with torch.no_grad():
        for f, img in enumerate(frames(n)):
            slam(f, img, INTR)
        return slam.terminate()


def run_pair(monkeypatch, keyframe_thresh=None, alloc_slot_first=True,
             motion_probe_thr=-1.0, probes=None, d_head_scale=D_HEAD_SCALE,
             overrides=None, nframes=FRAMES, weights_after_insert=False, edit_jax=None):
    """Run both SLAMs over ``nframes`` random frames and terminate both.

    ``alloc_slot_first``: the JAX fused steady-state step builds the
    update's index rows before it allocates the new frame's feature slot
    (``runtime.py`` ``_fused_frame_update``), so that frame's first update
    reads a stale slot. With True the JAX SLAM allocates the slot first,
    which is what its pre-init path and the port do.
    ``probes``: a dict that collects each side's motion-probe values under
    "jax" and "port".
    ``d_head_scale``: factor on the delta head's weights, on both sides.
    ``overrides``: further config values, on both sides.
    ``weights_after_insert``: run the JAX steady-state step through
    ``insert_then_update`` (which also allocates the slot first).
    ``edit_jax``: called with the JAX SLAM before either side runs (to edit
    its head weights, which the port then takes).
    Returns (jax_slam, port_slam, (jax poses, tstamps), (port poses, tstamps));
    ``jax_slam.params`` holds the weights both sides ran.
    """
    monkeypatch.setenv("BA_ASSEMBLY", "scatter")
    js = JaxSLAM(_cfg(jax_get_cfg, keyframe_thresh, motion_probe_thr, overrides), "cdv",
                 ht=H, wd=W)
    params = jax.tree_util.tree_map(np.asarray, js.params)
    head = params["params"]["update_op"]["heads"]["d"]
    head["kernel"] = head["kernel"] * d_head_scale
    head["bias"] = head["bias"] * d_head_scale
    js.params = js.cparams = params
    if edit_jax is not None:
        edit_jax(js)
    if weights_after_insert:
        insert_then_update(monkeypatch, js)
    elif alloc_slot_first:
        fused = js._fused_frame_update

        def fused_alloc_first(*args, **kwargs):
            js._alloc_frame_slots(js.pg.n - 1)
            return fused(*args, **kwargs)
        monkeypatch.setattr(js, "_fused_frame_update", fused_alloc_first)

    ts = port_slam(params, keyframe_thresh, motion_probe_thr, overrides=overrides, heads=js)
    if probes is not None:
        for side, slam in (("jax", js), ("port", ts)):
            probe = slam.motion_probe

            def logged(probe=probe, log=probes.setdefault(side, [])):
                log.append(probe())
                return log[-1]
            monkeypatch.setattr(slam, "motion_probe", logged)
    for f, img in enumerate(frames(nframes)):
        js(f, img, INTR)
    jax_out = js.terminate()
    return js, ts, jax_out, drive_port(ts, nframes)


def check_against_float64(monkeypatch, keyframe_thresh, d_head_scale=1.0, overrides=None,
                          nframes=FRAMES, weights_after_insert=False, edit_jax=None):
    """The JAX and port float32 runs (full-scale delta head unless
    ``d_head_scale`` says otherwise), held to a float64 run of the port
    (networks and geometry) on the same frames.

    Tolerances, per pose component after terminate():
    - every run makes the same discrete decisions: keyframe removals, kept
      frames, updates, loop edges, global BAs and timestamps are equal;
    - the JAX float32 run is no farther from the float64 run than 3x the
      port float32 run is: rounding in the port's own code moves the result
      as far as the other framework does, so the gap between the two is
      reassociation and not a difference in what is computed;
    - the two float32 runs agree within 3e-3 and each lies within 5e-3 of
      the float64 run.
    Returns (jax slam, port slam, float64 port slam, the three distances
    (jax-port, jax-f64, port-f64)).
    """
    js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, keyframe_thresh=keyframe_thresh,
                                          d_head_scale=d_head_scale, overrides=overrides,
                                          nframes=nframes, edit_jax=edit_jax,
                                          weights_after_insert=weights_after_insert)
    ws = port_slam(js.params, keyframe_thresh, dtype=torch.float64, overrides=overrides,
                   heads=js)
    wp, wt = drive_port(ws, nframes)
    assert wp.dtype == np.float64 and wp.shape == (nframes, 7)
    for key in ("keyframe_removals", "updates", "loop_edges", "global_ba"):
        assert js.stats[key] == ts.stats[key] == ws.stats[key], key
    assert js.pg.n == ts.pg.n == ws.pg.n
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(wt, jt)
    gaps = tuple(float(np.abs(a - b).max()) for a, b in ((jp, tp), (jp, wp), (tp, wp)))
    jax_port, jax_64, port_64 = gaps
    assert jax_64 <= 3 * port_64, gaps
    assert jax_port <= 3e-3, gaps
    assert max(jax_64, port_64) <= 5e-3, gaps
    return js, ts, ws, gaps
