"""CDVO++ on the steady-state step and in the benchmark, on the CPU.

- (a) The padded CDVO++ step (SCORE, seg and depth heads,
  FILTER_DYNAMIC_CLASS) runs the depth-anchored scale adjustment as its
  last stage, with the step's t0 and n as device scalars over a static
  window. It is held bitwise to the eager order it replaced: the step
  without it, then ``SLAM._adjust_scale`` with host ints (what the eager
  initialisation and termination updates still call), at a step with a
  deferred keyframe shift and one without. The heads' device counters
  count each step once.
- (b) The ``cdvopp.euroc-stream`` cell, run on the CPU at 64 x 96 with 8
  patches (shrunk traffic, every steady step of its window sampled),
  reads correct.
- (c) The same run reads not correct with the seg row written after the
  update (the JAX package's stale-seg order: ``weight``), with the scale
  adjustment left out of the step (``ba_pose``: the rotation gate stays
  shut at these steps, so what is missing is the rebuild of the window's
  poses from their inverses, a few parts in a million against a bitwise
  sound run) and with the depth head's output scaled by 1.01
  (``depth.max``).
- (d) The benchmark's rule for the seg head (its dynamic classes' bias
  raised until a fifth of the first view's tokens take one) lands within
  20% +- 2% on the first view of the cell's scene at 224 x 336.
The test marked ``cuda`` holds every CDVO++ key's first replay on the card
to the eager body, the scale adjustment inside; it skips without a card.
"""
import numpy as np
import pytest
import torch

from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.slam import SLAM, fused, runtime
from cdvslam_tpu_torch.slam.kernels import SCALARS
from portbench import cell

torch.set_num_threads(2)
H, W, M = 64, 96, 8
INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
HEADS = {"CENTROID_SEL_STRAT": "SCORE", "SEG_HEAD": "random", "DEPTH_HEAD": "random",
         "FILTER_DYNAMIC_CLASS": True}
SHRINK = {"ht": H, "wd": W, "settings": {"PATCHES_PER_FRAME": M},
          "traffic": {"period": 24, "warm_frames": 12, "check_steps": [2, 16], "check_samples": 14,
                      "sequence_frames": 24, "profile_frames": 3, "tex_size": 256}}
SEED = 2**31 + 101


def _slam(device="cpu"):
    cfg = get_cfg()
    cfg.PATCHES_PER_FRAME, cfg.BUFFER_SIZE = M, 64
    cfg.MOTION_PROBE_THR, cfg.MIXED_PRECISION = -1.0, False
    cfg.update(HEADS)
    return SLAM(cfg, "cdv", ht=H, wd=W, device=device)


def _drive(slam, n):
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for f in range(n):
            slam(f, (rng.rand(H, W, 3) * 255).astype(np.uint8), INTR)


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


# ---------------------------------------------------------------------------
def test_the_scale_adjustment_in_the_step_equals_the_eager_order():
    slam = _slam()
    run, steps = slam.fused.run, []

    def spy(key, frame, ints, floats):
        steps.append((key, frame.clone(), ints.copy(), floats.copy(), _clone(slam.pg.state())))
        return run(key, frame, ints, floats)

    slam.fused.run = spy
    _drive(slam, 18)
    picked = {bool(s[0].shift_span): s for s in steps}
    assert set(picked) == {False, True}
    adjust = slam._adjust_scale
    for key, frame, ints, floats, state in picked.values():
        assert key.iterations > 0
        inp = fused.FrameInputs(frame, torch.from_numpy(ints), torch.from_numpy(floats))
        tally = slam._tally.clone()
        inside = _clone(state)
        with torch.no_grad():
            mm_in, dP_in = fused.fused_body(slam, inside, inp, key)
            counted = slam._tally - tally
            eager = _clone(state)
            slam._adjust_scale = lambda *a: None
            try:
                mm, dP = fused.fused_body(slam, eager, inp, key)
            finally:
                slam._adjust_scale = adjust
            tail = dict(zip(SCALARS, ints[-len(SCALARS):].tolist()))
            slam._adjust_scale(eager, tail["t0"], tail["n"] + 1)
        for name in inside:
            assert torch.equal(inside[name], eager[name]), name
        assert torch.equal(mm_in, mm) and (dP is None) == (dP_in is None)
        assert dP is None or torch.equal(dP_in, dP)
        assert not torch.equal(inside["patches_"], state["patches_"])
        got = dict(zip(runtime.HEAD_COUNTERS, counted.tolist()))
        assert got["scale_calls"] == 1 and got["tokens"] == 5 * 7, got


def test_the_heads_counters_and_no_eager_scale_on_steady_frames(monkeypatch):
    slam = _slam()
    calls = []
    adjust = slam._adjust_scale
    monkeypatch.setattr(slam, "_adjust_scale",
                        lambda *a: calls.append(slam.fused.off_path) or adjust(*a))
    after, eager = slam._after_update, []

    def counted_after(t0, long_range, scaled=False):
        n = len(calls)
        after(t0, long_range, scaled)
        eager.append(len(calls) - n)

    monkeypatch.setattr(slam, "_after_update", counted_after)
    _drive(slam, 16)
    slam.terminate()
    s = slam.stats
    assert eager[:12] == [1] * 12 and eager[12:20] == [0] * 8 and eager[20:] == [1] * 12
    assert s["scale_calls"] == s["updates"] == 32 and 0 <= s["scale_gate_open"] <= 32
    assert s["tokens"] == 16 * 5 * 7 and 0 < s["dynamic_tokens"] < s["tokens"]
    assert 0 <= s["edges_downweighted"] <= s["edges"] and s["edges"] > 0


# ---------------------------------------------------------------------------
def _run(hook=None):
    return cell.run("cdvopp.euroc-stream", SEED, 0.1, 0, device="cpu", shrink=SHRINK,
                    slam_hook=hook, log=lambda obj: None)


def test_the_cdvopp_cell_reads_correct():
    result, checks = _run()
    assert checks["missing_samples"]["value"] == 0
    assert result["correct"], checks


def seg_after_update(slam):
    """The steady step writes the new frame's seg row after the update, so
    the update's dynamic-class weights read the row as it was (the JAX
    package's stale-seg order)."""
    insert, update, held = slam._insert_frame, slam._update_step, {}

    def insert_(st, inp, initialized):
        before = st["seg_"].clone()
        insert(st, inp, initialized)
        if initialized:
            held["seg"] = st["seg_"].clone()
            st["seg_"].copy_(before)

    def update_(st, inp, key):
        mm = update(st, inp, key)
        if "seg" in held:
            st["seg_"].copy_(held.pop("seg"))
        return mm

    slam._insert_frame, slam._update_step = insert_, update_


def scale_left_out(slam):
    """The steady step runs no scale adjustment."""
    run, adjust, inside = slam.fused.run, slam._adjust_scale, []

    def run_(*args):
        inside.append(1)
        try:
            return run(*args)
        finally:
            inside.pop()

    slam.fused.run = run_
    slam._adjust_scale = lambda *a: None if inside else adjust(*a)


def depth_scaled(slam):
    """The depth head's metric depth is 1% too large."""
    forward = slam.depth_head.forward
    slam.depth_head.forward = lambda x: forward(x) * 1.01


@pytest.mark.parametrize("fault", [seg_after_update, scale_left_out, depth_scaled])
def test_a_broken_cdvopp_step_is_not_correct(fault):
    result, checks = _run(fault)
    assert checks["missing_samples"]["value"] == 0
    assert not result["correct"], checks


# ---------------------------------------------------------------------------
def test_the_dynamic_share_rule_on_the_first_view():
    from portbench.drivers import stream_heads
    from portbench.yardstick.render import PlaneScene, loop_path, render_batch
    ht, wd = 224, 336
    tr = cell.load_json(cell.BENCH / "traffic" / "euroc-stream-heads.json")
    seeds = cell.derive_seeds(SEED)
    intr = np.asarray(tr["intrinsics"]) * np.array([wd / tr["source_wd"], ht / tr["source_ht"]] * 2)
    scene = PlaneScene(intr, ht, wd, tex_size=tr["tex_size"], extent=tr["extent"],
                       seed=seeds["texture"])
    first = render_batch(scene, loop_path(1, tr["period"]), "cpu")[0]
    _, _, c, share = stream_heads.seeded_heads(seeds["weights"], first, "cpu")
    assert abs(share - 0.20) <= 0.02, (c, share)


# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_every_cdvopp_key_replays_as_its_eager_body_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    slam = _slam(device="cuda")
    replay, checked = slam.fused.replay, {}

    def held(g):
        key = next(k for k, v in slam.fused.graphs.items() if v is g)
        if key in checked:
            return replay(g)
        st, inp = _clone(slam.pg.state()), fused.FrameInputs(*(t.clone() for t in g.inputs))
        replay(g)
        slam.fused.off_path = True
        try:
            mm, dP = fused.fused_body(slam, st, inp, key)
        finally:
            slam.fused.off_path = False
        torch.cuda.synchronize()
        same = [torch.equal(st[k], v) for k, v in slam.pg.state().items()]
        same.append(torch.equal(mm, g.outputs[0]))
        checked[key] = all(same)

    slam.fused.replay = held
    _drive(slam, 24)
    assert checked and all(checked.values()), checked
    assert any(k.shift_span for k in checked) and all(k.iterations for k in checked)
    slam.terminate()
    assert slam.stats["scale_calls"] == slam.stats["updates"]
