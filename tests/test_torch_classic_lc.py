"""The port's classical loop closure (``loop/long_term.py``) against the
JAX package's.

- ``lc_callback``'s delta-chain rescale (a port of
  ``test_classic_lc.py::test_lc_callback_rescales_delta_chain``).
- ``close_loop`` on one patch-graph state in both SLAMs: 64 keyframes of
  an overhead camera circling a rendered textured plane
  (``render_plane``), with a seeded drift (rotation, translation and a
  growing scale) on the ground-truth poses, the true inverse depths of
  the patches, a delta chain, and the ORB index of the loop triplets
  (58 revisits 2). Both run under ``CLASSIC_LOOP_SYNC``. The JAX Sim3 PGO
  is patched to solve in float64, as the port's does (``pgo_in_float64``;
  the last test shows the JAX float32 solve unpatched). Tolerances: the
  PGO's inputs (the Sim3 measurement dS, the loop rows, the pose
  snapshot) 1e-4; the corrected poses, patch depths and delta chain
  after ``normalize()`` 1e-4 (they agree to 2e-7).
"""
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cdvslam_tpu.loop.long_term as jax_long_term  # noqa: E402
from cdvslam_tpu.ba import pgo as jax_pgo  # noqa: E402
from cdvslam_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from cdvslam_tpu.slam import SLAM as JaxSLAM  # noqa: E402
from cdvslam_tpu_torch.config import get_cfg  # noqa: E402
from cdvslam_tpu_torch.lie import se3_exp, se3_inv, se3_mul  # noqa: E402
from cdvslam_tpu_torch.loop import long_term  # noqa: E402
from cdvslam_tpu_torch.slam import SLAM  # noqa: E402
from render_plane import PlaneScene, overhead_loop_poses  # noqa: E402
from torch_slam_pair import pgo_in_float64  # noqa: E402

torch.set_num_threads(2)

F, M, P = 64, 24, 3
HT, WD = 192, 256                  # the rendered frames (ORB needs the size)
INTR = np.array([220.0, 220.0, 128.0, 96.0], np.float32)
LOOP = (58, 2)                     # frame 58 revisits frame 2


def test_lc_callback_rescales_delta_chain():
    """Applying a Sim3 PGO correction also rescales the RELATIVE poses of
    removed (non-keyframe) frames: each delta chain walks to its live root
    keyframe and its translation scales with that keyframe's correction."""
    cfg = get_cfg()
    cfg.PATCHES_PER_FRAME = 8
    cfg.BUFFER_SIZE = 16
    slam = SLAM(cfg, network="dpv", ht=64, wd=64, device="cpu")
    pg = slam.pg
    n = 4
    pg.n = n
    pg.tstamps_[:n] = [0, 2, 4, 6]
    # uniform disparity 0.5 so the post-callback normalize() is a pure
    # gauge fix (scales 2.0 below bring mean disparity to 1.0)
    pg.patches_[: n * slam.M, 2] = 0.5
    pg.poses_[:n] = torch.tensor([0, 0, 0, 0, 0, 0, 1.0])
    # delta chains: frame 1 hangs off keyframe 0; frame 5 hangs off the
    # REMOVED frame 3 which hangs off keyframe 2
    dP = torch.tensor([1.0, 2.0, 3.0, 0, 0, 0, 1])
    pg.delta = {1: (0, dP.clone()), 3: (2, dP.clone()), 5: (3, dP.clone())}

    lc = long_term.LongTermLoopClosure(cfg, slam)
    # corrected Sim3 world->cam poses: identity SE3, scale 2 everywhere
    corrected = torch.zeros((n, 8), dtype=torch.float64)
    corrected[:, 6] = 1.0
    corrected[:, 7] = 2.0
    lc.result_q.put((n, corrected, None))
    lc.lc_callback()

    # scales (world->cam) = 2 -> translations of deltas scale by 1/2
    for t in (1, 3, 5):
        t0, d = pg.delta[t]
        np.testing.assert_allclose(d[:3].numpy(), dP[:3].numpy() * 0.5, rtol=1e-5,
                                   err_msg=f"delta {t} not rescaled")
        assert torch.equal(d[3:], dP[3:])
    # depths were multiplied by the Sim3 scale
    assert torch.allclose(pg.patches_[0, 2, 0, 0], torch.tensor(1.0))
    assert slam.stats["lc_applied"] == 1 and lc.lc_count == 1


def _state():
    """The shared patch-graph state (float64 numpy) and the gray frames of
    the loop triplets."""
    scene = PlaneScene(INTR, HT, WD, seed=3)
    gt = torch.tensor(overhead_loop_poses(F), dtype=torch.float64)
    rng = np.random.RandomState(0)
    est = [gt[0]]
    for k in range(1, F):
        rel = se3_mul(gt[k], se3_inv(gt[k - 1])).clone()
        rel[:3] *= np.exp(0.01 * k)                     # scale drift
        rel = se3_mul(se3_exp(torch.tensor(0.005 * rng.randn(6))), rel)
        est.append(se3_mul(rel, est[-1]))
    patches = np.zeros((F * M, 3, P, P))
    for f in range(F):
        px = rng.uniform(2, WD / 4 - 2, M)
        py = rng.uniform(2, HT / 4 - 2, M)
        rows = slice(f * M, (f + 1) * M)
        for c, v in enumerate((px, py, scene.true_inv_depth(gt[f].numpy(), px, py))):
            patches[rows, c] = v[:, None, None]
    gray = {f: cv2.cvtColor(scene.render(gt[f].numpy()), cv2.COLOR_RGB2GRAY)
            for i in LOOP for f in (i - 1, i, i + 1)}
    dP = np.array([0.3, -0.2, 0.1, 0.0, 0.0, 0.0, 1.0])
    delta = {F: (5, dP), F + 1: (F, dP), F + 2: (60, dP)}   # chains to rows 5 and 60
    return torch.stack(est).numpy(), patches, gray, delta


def _cfg(make):
    cfg = make()
    cfg.PATCHES_PER_FRAME = M
    cfg.BUFFER_SIZE = 96
    cfg.CLASSIC_LOOP_CLOSURE = True
    cfg.CLASSIC_LOOP_SYNC = True
    return cfg


def _fill(slam, state, put):
    poses, patches, gray, delta = state
    pg = slam.pg
    pg.n, pg.m, pg.counter = F, F * M, F + 3
    pg.tstamps_[:F] = np.arange(F)
    pg.poses_ = put(pg.poses_, poses)
    pg.patches_ = put(pg.patches_, patches)
    pg.intrinsics_ = put(pg.intrinsics_, np.tile(INTR / 4, (F, 1)))
    pg.delta = {t: (t0, put(None, dP)) for t, (t0, dP) in delta.items()}
    for f, g in gray.items():
        slam.long_term_lc.retrieval.insert_image(g, f)


def _jax_put(a, v):
    if a is None:
        return np.asarray(v, np.float32)
    return a.at[: len(v)].set(jnp.asarray(v, a.dtype))


def _port_put(a, v):
    if a is None:
        return torch.tensor(v, dtype=torch.float32)
    a = a.clone()
    a[: len(v)] = torch.as_tensor(v, dtype=a.dtype)
    return a


def _record_pgo_inputs(monkeypatch, module, log):
    run = module.run_pgo

    def recorded(*args, **kwargs):
        log.append([a.numpy() if torch.is_tensor(a) else np.asarray(a) for a in args])
        return run(*args, **kwargs)
    monkeypatch.setattr(module, "run_pgo", recorded)


@pytest.fixture(scope="module")
def closed():
    """close_loop(58, 2) + lc_callback on a JAX SLAM (float64 PGO) and a
    port SLAM filled with the same state: {side: (slam, PGO inputs)}."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BA_ASSEMBLY", "scatter")
        pgo_in_float64(mp)
        state = _state()
        out = {}
        for side, make, build, put, module in (
                ("jax", jax_get_cfg, lambda c: JaxSLAM(c, "dpv", ht=64, wd=64), _jax_put,
                 jax_long_term),
                ("port", get_cfg, lambda c: SLAM(c, "dpv", ht=64, wd=64, device="cpu"),
                 _port_put, long_term)):
            slam = build(_cfg(make))
            _fill(slam, state, put)
            log = []
            _record_pgo_inputs(mp, module, log)
            slam.long_term_lc.close_loop(*LOOP)
            slam.long_term_lc.lc_callback()
            out[side] = (slam, log)
        yield out


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_close_loop_measures_the_same_sim3(closed):
    (js, jlog), (ts, tlog) = closed["jax"], closed["port"]
    assert len(jlog) == len(tlog) == 1
    (jposes, jdS, jii, jjj), (tposes, tdS, tii, tjj) = jlog[0], tlog[0]
    np.testing.assert_array_equal(jii, [LOOP[0]])
    np.testing.assert_array_equal(tii, jii)
    np.testing.assert_array_equal(tjj, jjj)
    np.testing.assert_allclose(tposes, jposes, rtol=0, atol=1e-6)
    # the Sim3 between the loop frames: scale about 0.51 (the drift)
    np.testing.assert_allclose(tdS, jdS, rtol=0, atol=1e-4)
    assert 0.4 < float(tdS[0, 7]) < 0.6


def test_close_loop_applies_the_same_correction(closed):
    (js, _), (ts, _) = closed["jax"], closed["port"]
    for key in ("lc_attempts", "lc_applied"):
        assert js.stats[key] == ts.stats[key] == 1, key
    assert js.long_term_lc.loop_pairs == ts.long_term_lc.loop_pairs == [LOOP]
    np.testing.assert_allclose(_np(ts.pg.poses_[:F]), _np(js.pg.poses_[:F]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(ts.pg.patches_[: F * M, 2]), _np(js.pg.patches_[: F * M, 2]),
                               rtol=0, atol=1e-4)
    assert set(ts.pg.delta) == set(js.pg.delta)
    for t, (t0, dP) in ts.pg.delta.items():
        assert t0 == js.pg.delta[t][0]
        np.testing.assert_allclose(_np(dP), _np(js.pg.delta[t][1]), rtol=0, atol=1e-4)
    # normalize() ran after the correction
    assert float(ts.pg.patches_[: F * M, 2].mean()) == pytest.approx(1.0, abs=1e-5)


def test_jax_float32_pgo_stalls_on_the_loop(closed):
    """The fault ``pgo_in_float64`` patches (ROADMAP Queue 3): on this
    loop's PGO inputs the JAX float32 LM rejects its first 23 steps and
    ends with a mean squared residual of 5.9e-4 (1.1e-3 at the start); in
    float64 it accepts its 9th step and ends at 2.1e-5, more than 10x
    lower."""
    poses, dS, ii, jj = closed["jax"][1][0]
    hist = {}
    for x64 in (False, True):
        log = []
        step = jax_pgo._pgo_step

        def logged(*a, **k):
            out = step(*a, **k)
            log.append(float(out[1]))
            return out
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(x64):
            mp.setattr(jax_pgo, "_pgo_step", logged)
            dt = np.float64 if x64 else np.float32
            jax_pgo.perform_updates(poses.astype(dt), dS.astype(dt), ii, jj)
        hist[x64] = log
    assert hist[False][-1] > 10 * hist[True][-1], hist
