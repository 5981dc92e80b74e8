"""The steady-state step (``cdvslam_tpu_torch/slam/fused.py``) on the CPU.

On the card each initialized frame is one CUDA graph replay of
``fused.fused_body`` over padded edges; on the CPU the same padded body
runs eagerly. Held here, on 64 x 96 frames with 8 patches a frame:
- the padded body at two buckets against the unpadded body (E_pad = E) on
  the same state and inputs: poses, patches, hidden state, target and
  weight, mm and the removed frame's dP. Padded edges read in-range rows,
  are masked out of every sum and start from zero hidden state, so every
  output is bitwise equal (measured: no difference at all; the CPU's
  matrix products give each row the same bits whatever the row count);
- ``SegmentPlan``'s run lengths (an integer ``scatter_add_``) against
  ``torch.bincount``, and its sums against the bincount plan's, bitwise, on
  random ids that include ids out of range;
- ``SLAM._prepare_update``'s cached rows against an uncached build at every
  update of two runs: one with keyframe removals, one with loop edges
  (every steady frame shifts the edge pattern by one frame);
- a CPU SLAM counts no launch of the segment-sum kernel or of the BA's
  kernels (``stats``);
- the keyframe shift: ``kernels.shift_rows`` at spans inside and outside
  the band the step carries (1 to KEYFRAME_INDEX + 2) against the slices
  the eager ``_kf_apply`` wrote before the shift moved into the step, and
  a run whose in-band shifts ride the step against a run that applies
  them eagerly first: bitwise;
- the body reads nothing back from the host (no ``.item()``, ``nonzero``,
  ``bincount``, boolean indexing or host constant), which a capture needs:
  a dispatch mode records every such operator while the body runs, under
  the main path, CDVO++ (SCORE, seg and depth heads, dynamic-class
  weights) and DPVO with GRADIENT_BIAS.
The test marked ``cuda`` captures the step on the card and holds each
key's first replay to the eager body on a copy of the same state and
inputs, bitwise; it skips without a card.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.lie import se3_exp, se3_inv, se3_mul
from cdvslam_tpu_torch.ops.scatter import SegmentPlan
from cdvslam_tpu_torch.slam import SLAM, fused
from cdvslam_tpu_torch.slam.kernels import SCALARS, shift_rows

torch.set_num_threads(2)
H, W, M = 64, 96, 8
INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
LOOP = {"LOOP_CLOSURE": True, "BACKEND_THRESH": 999.0, "KEYFRAME_THRESH": 0.0,
        "BUFFER_SIZE": 108}


def _slam(network="cdv", device="cpu", **overrides):
    cfg = get_cfg()
    cfg.PATCHES_PER_FRAME, cfg.BUFFER_SIZE = M, 64
    cfg.MOTION_PROBE_THR, cfg.MIXED_PRECISION = -1.0, False
    cfg.update(overrides)
    return SLAM(cfg, network, ht=H, wd=W, device=device)


def _frames(n):
    rng = np.random.RandomState(0)
    return [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(n)]


def _drive(slam, n):
    with torch.no_grad():
        for f, img in enumerate(_frames(n)):
            slam(f, img, INTR)


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


# ---------------------------------------------------------------------------
def _record_step(slam, nframes, at):
    """Drive ``slam``; return the step of frame ``at``: its key, inputs,
    edges and the state before it."""
    run, rec = slam.fused.run, {}

    def spy(key, frame, ints, floats):
        if slam.pg.counter - 1 == at:
            pg = slam.pg
            rec.update(key=key, frame=frame.clone(), ints=ints.copy(), floats=floats.copy(),
                       state=_clone(pg.state()),
                       edges=(pg.ii.copy(), pg.jj.copy(), pg.kk.copy(), pg.net_src.copy()))
        return run(key, frame, ints, floats)

    slam.fused.run = spy
    _drive(slam, nframes)
    return rec


def _body_at(slam, rec, E_pad):
    """fused_body on a copy of the recorded state with the edges padded to
    E_pad (E_pad = E: no padding)."""
    ii, jj, kk, src = rec["edges"]
    _, _, rows = slam._prepare_update(ii, jj, kk, E_pad, src)
    ints = np.concatenate([rows.reshape(-1), rec["ints"][-len(SCALARS):]])
    st = _clone(rec["state"])
    for name in ("net", "tw_buf"):
        short = E_pad - st[name].shape[0]
        if short > 0:
            st[name] = torch.cat([st[name], st[name].new_zeros((short, st[name].shape[1]))])
    inp = fused.FrameInputs(rec["frame"], torch.from_numpy(ints), torch.from_numpy(rec["floats"]))
    with torch.no_grad():
        mm, dP = fused.fused_body(slam, st, inp, rec["key"]._replace(E_pad=E_pad))
    return st, mm, dP


@pytest.mark.parametrize("network", ["cdv", "dpv"])
def test_padded_body_equals_the_unpadded_body(network):
    slam = _slam(network)
    rec = _record_step(slam, 18, at=17)
    assert rec["key"].shift_span > 0            # the step carries a keyframe shift
    E = len(rec["edges"][0])
    ref_st, ref_mm, ref_dP = _body_at(slam, rec, E)
    for E_pad in (slam.pg.bucket(E), slam.pg.bucket(E) + 1024):
        assert E_pad > E
        st, mm, dP = _body_at(slam, rec, E_pad)
        for name in ("poses_", "patches_", "intrinsics_", "colors_dev", "scale_", "imap_",
                     "gmap_", "fmap1_", "fmap2_"):
            assert torch.equal(st[name], ref_st[name]), (E_pad, name)
        for name in ("net", "tw_buf"):
            assert torch.equal(st[name][:E], ref_st[name][:E]), (E_pad, name)
        assert torch.equal(mm, ref_mm) and torch.equal(dP, ref_dP), E_pad


def test_segment_plan_counts_as_bincount_and_sums_bitwise():
    rng = np.random.default_rng(5)
    for n, S in ((1000, 37), (5000, 300), (7, 3), (0, 4)):
        ids = torch.from_numpy(rng.integers(-5, S + 5, n))
        vals = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
        clipped = torch.where((ids >= 0) & (ids < S), ids, torch.full_like(ids, S))
        lengths = torch.bincount(clipped, minlength=S + 1)
        plan = SegmentPlan(ids, S)
        assert torch.equal(plan.lengths, lengths)
        want = torch.segment_reduce(vals[torch.argsort(clipped, stable=True)], "sum",
                                    lengths=lengths, axis=0)[:S]
        assert torch.equal(plan.sum(vals), want)


def test_no_kernel_launch_is_counted_on_the_cpu():
    """A CPU SLAM's updates, its initialization's and ``terminate()``'s
    included, run the plain BA and sums: its launch counters stay 0."""
    slam = _slam()
    _drive(slam, 12)
    slam.terminate()
    assert slam.stats["updates"] > 12
    assert slam.stats["ba_edges_launches"] == slam.stats["segsum_launches"] == 0


@pytest.mark.parametrize("overrides", [{}, LOOP], ids=["removals", "loop_edges"])
def test_prepare_update_cache_matches_an_uncached_build(overrides):
    """At every update: the cached rows equal an uncached build. The
    removal run must serve an entry filled before a keyframe removal (the
    slot tables have moved since), the loop run must build rows with loop
    edges in the window."""
    slam = _slam(**overrides)
    prepare, filled = slam._prepare_update, {}
    seen = {"calls": 0, "hits": 0, "hits_across_removal": 0, "calls_with_loop_edges": 0}

    def checked(ii, jj, kk, E_pad, net_src):
        k0, KWIN = slam.patch_window(kk)
        key = (E_pad, KWIN, int(kk.min()) - k0,
               np.stack([ii - ii[0], jj - jj[0], kk - kk[0]]).tobytes())
        got = prepare(ii, jj, kk, E_pad, net_src)
        cache, slam._prep_cache = slam._prep_cache, {}
        try:
            want = prepare(ii, jj, kk, E_pad, net_src)
        finally:
            slam._prep_cache = cache
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        removals = slam.stats["keyframe_removals"]
        seen["calls"] += 1
        if key in filled:
            seen["hits"] += 1
            seen["hits_across_removal"] += removals > filled[key]
        else:
            filled[key] = removals
        seen["calls_with_loop_edges"] += bool(
            (ii < slam.pg.n - slam.cfg.REMOVAL_WINDOW - 1).any())
        return got

    slam._prepare_update = checked
    _drive(slam, 44 if overrides else 30)
    assert seen["hits"] > 0, seen
    if overrides:
        assert slam.stats["loop_edges"] > 0 and seen["calls_with_loop_edges"] > 0, seen
    else:
        assert seen["hits_across_removal"] > 0, seen


# ---------------------------------------------------------------------------
def _random_state(N=32, P=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"poses_": se3_exp(0.3 * torch.randn((N, 6), generator=g)),
            "patches_": torch.rand((N * M, 3, P, P), generator=g),
            "intrinsics_": torch.rand((N, 4), generator=g),
            "seg_": torch.randint(0, 150, (N, M), generator=g, dtype=torch.uint8),
            "colors_dev": torch.rand((N, M, 3), generator=g),
            "scale_": torch.rand(N, generator=g),
            "score_": torch.rand(N * M, generator=g)}


def _slices_shift(st, k, n):
    """The device rows as the eager ``_kf_apply`` moved them with slices
    (before the shift moved into the step), and its delta entry."""
    dP = se3_mul(st["poses_"][k], se3_inv(st["poses_"][k - 1]))
    for name in ("poses_", "intrinsics_", "seg_", "colors_dev", "scale_"):
        st[name][k:n - 1] = st[name][k + 1:n].clone()
    for name in ("patches_", "score_"):
        st[name][k * M:(n - 1) * M] = st[name][(k + 1) * M:n * M].clone()
    return dP


@pytest.mark.parametrize("span", [1, 5, 6, 9, 20], ids=lambda s: f"span{s}")
def test_shift_rows_matches_the_eager_slices(span):
    # the step carries spans 1 to KEYFRAME_INDEX + 2 = 6; others run eagerly
    st = _random_state()
    k = 3
    n = k + 1 + span
    want = _clone(st)
    dP_want = _slices_shift(want, k, n)
    dP = shift_rows(st, torch.tensor(k), span, M)
    assert torch.equal(dP, dP_want)
    for name in st:
        assert torch.equal(st[name], want[name]), name


def test_shift_inside_the_step_equals_the_eager_shift():
    a, b = _slam(), _slam()
    spans = []
    run = a.fused.run

    def logged(key, *args):
        spans.append(key.shift_span)
        return run(key, *args)

    a.fused.run = logged
    step = b._fused_frame_update

    def eager_shift_first(*args):
        b._apply_pending_shift()
        return step(*args)

    b._fused_frame_update = eager_shift_first
    _drive(a, 24)
    _drive(b, 24)
    assert a.stats["keyframe_removals"] == b.stats["keyframe_removals"] > 0
    assert any(spans)
    for name, buf in a.pg.state().items():
        assert torch.equal(buf, b.pg.state()[name]), name
    assert a.pg.delta.keys() == b.pg.delta.keys()
    for t, (t0, dP) in a.pg.delta.items():
        assert b.pg.delta[t][0] == t0 and torch.equal(b.pg.delta[t][1], dP)


# ---------------------------------------------------------------------------
class HostReads(TorchDispatchMode):
    """Records the operators that read the device back to the host or copy
    a host constant up (each would stop a CUDA graph capture)."""
    NAMES = {"_local_scalar_dense", "nonzero", "bincount", "_unique2", "unique_dim",
             "unique_consecutive", "masked_select", "lift_fresh", "lift_fresh_copy",
             "isin", "equal", "is_nonzero", "allclose"}

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        bad = name in self.NAMES
        bad |= name == "segment_reduce" and not kwargs.get("unsafe", False)
        bad |= name == "repeat_interleave" and kwargs.get("output_size") is None
        if name in ("index", "index_put", "index_put_"):
            bad |= any(i is not None and i.dtype == torch.bool for i in args[1])
        if bad:
            self.seen.add(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("network, overrides", [
    ("cdv", {}),
    ("cdv", {"CENTROID_SEL_STRAT": "SCORE", "SEG_HEAD": "random", "DEPTH_HEAD": "random",
             "FILTER_DYNAMIC_CLASS": True}),
    ("dpv", {"CENTROID_SEL_STRAT": "GRADIENT_BIAS"}),
], ids=["main", "cdvo_pp", "dpvo_gradient_bias"])
def test_the_step_reads_nothing_from_the_host(monkeypatch, network, overrides):
    slam = _slam(network, **overrides)
    body, guard, steps = fused.fused_body, HostReads(), []

    def guarded(*args):
        steps.append(args[3])
        with guard:
            return body(*args)

    monkeypatch.setattr(fused, "fused_body", guarded)
    _drive(slam, 14)
    assert len(steps) == 6 and any(k.shift_span for k in steps)
    assert not guard.seen, guard.seen


# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_replay_equals_the_eager_body_on_the_card():
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
        mm, dP = fused.fused_body(slam, st, inp, key)
        torch.cuda.synchronize()
        same = [torch.equal(st[k], v) for k, v in slam.pg.state().items()]
        same.append(torch.equal(mm, g.outputs[0]))
        checked[key] = all(same)

    slam.fused.replay = held
    _drive(slam, 24)
    assert checked and all(checked.values()), checked
