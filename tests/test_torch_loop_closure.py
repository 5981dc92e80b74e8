"""Proximity loop closure: the port's ``loop.proximity`` and the whole SLAM
with LOOP_CLOSURE=True against the JAX package.

- ``reduce_edges`` and ``edges_loop``: the same (kk, jj) exactly; the
  candidate flows within 1e-5 relative (float32 flow of 1x1 patches,
  computed in another order), and inf at the same pairs.
- Whole SLAM, no keyframe removal: 44 random 64 x 96 frames with
  KEYFRAME_THRESH=0 (so n reaches the 36 keyframes loop edges need),
  BACKEND_THRESH=999 (random frames predict little common motion),
  BUFFER_SIZE=108 (frames + 64: the JAX update's window clamp never
  triggers, see test_torch_window_clamp.py). Loop edges and global BAs
  fire on both sides with equal counts; poses within 1e-4 per component
  after terminate() (measured 2.1e-5), the inactive edge stores equal in
  their indices and within 5e-3 in their targets and weights (measured
  2.4e-3 on targets near 17 px: the update operator's outputs after 40
  recurrent updates carry more float32 rounding than the BA's poses).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

from cdvslam_tpu.config import get_cfg as jax_get_cfg
from cdvslam_tpu.loop import proximity as jprox
from cdvslam_tpu_torch.lie import se3_exp
from cdvslam_tpu_torch.loop import proximity
from torch_slam_pair import run_pair

torch.set_num_threads(2)

LC = {"LOOP_CLOSURE": True, "BACKEND_THRESH": 999.0}


def test_reduce_edges_matches_jax():
    rng = np.random.RandomState(0)
    ii = rng.randint(0, 40, 3000)
    jj = ii + rng.randint(20, 45, 3000)
    mags = rng.uniform(0, 1200, 3000)
    for cap in (1000, 25):
        want = jprox.reduce_edges(mags, ii, jj, max_num_edges=cap, nms=1)
        got = proximity.reduce_edges(mags, ii, jj, max_num_edges=cap, nms=1)
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


def _graph(n=60, M=8, N=80):
    """A patch graph at n keyframes: a loop of 48 frames with small
    rotations (frames 48 on revisit the start), frames 50-52 turned around
    (their candidates are invalid), random patch centers and depths."""
    rng = np.random.RandomState(1)
    xi = np.zeros((N, 6))
    theta = 2 * np.pi * np.arange(n) / 48
    xi[:n, 0], xi[:n, 2] = 0.5 * np.sin(theta), 0.5 * (1 - np.cos(theta))
    xi[:n, 3:] = 0.01 * rng.randn(n, 3)
    xi[50:53, 4] = np.pi
    poses = se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
    patches = np.zeros((N * M, 3, 3, 3), np.float32)
    patches[:, 0] = rng.uniform(0, 24, N * M)[:, None, None]
    patches[:, 1] = rng.uniform(0, 16, N * M)[:, None, None]
    patches[:, 2] = rng.uniform(0.2, 1.5, N * M)[:, None, None]
    intr = np.tile(np.array([20.0, 20.0, 12.0, 8.0], np.float32), (N, 1))
    return n, M, poses, patches, intr


def test_edges_loop_matches_jax():
    n, M, poses, patches, intr = _graph()
    cfg = jax_get_cfg()
    jpg = SimpleNamespace(M=M, n=n, poses_=jnp.asarray(poses), patches_=jnp.asarray(patches),
                          intrinsics_=jnp.asarray(intr))
    tpg = SimpleNamespace(M=M, n=n, poses_=torch.tensor(poses), patches_=torch.tensor(patches),
                          intrinsics_=torch.tensor(intr))
    # the candidate flows: pairs of (old patch frame, recent frame)
    l = n - cfg.REMOVAL_WINDOW
    jj_c, kk_c = (a.reshape(-1) for a in np.meshgrid(
        np.arange(n - cfg.GLOBAL_OPT_FREQ, n - cfg.KEYFRAME_INDEX), np.arange(l * M),
        indexing="ij"))
    want = np.asarray(jprox._candidate_flow(
        jpg.poses_, jpg.patches_[:, :, 1:2, 1:2], jpg.intrinsics_, jnp.asarray(kk_c // M),
        jnp.asarray(jj_c), jnp.asarray(kk_c), jnp.ones(len(kk_c), bool), M=M))
    got = proximity.candidate_flow(
        tpg.poses_, tpg.patches_[:, :, 1:2, 1:2], tpg.intrinsics_, torch.tensor(kk_c // M),
        torch.tensor(jj_c), torch.tensor(kk_c), M).numpy()
    assert np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)

    # a gate that keeps about half of the valid pairs
    cfg.BACKEND_THRESH = float(np.median(want[fin]))
    jkk, jjj = jprox.edges_loop(jpg, cfg)
    tkk, tjj = proximity.edges_loop(tpg, cfg)
    assert len(jkk) > 0 and len(jkk) % M == 0
    np.testing.assert_array_equal(tkk, jkk)
    np.testing.assert_array_equal(tjj, jjj)


def test_slam_with_loop_closure_matches_jax(monkeypatch):
    nframes = 44
    js, ts, (jp, jt), (tp, tt) = run_pair(
        monkeypatch, keyframe_thresh=0.0, nframes=nframes,
        overrides=dict(LC, BUFFER_SIZE=nframes + 64))
    for key in ("updates", "loop_edges", "global_ba", "keyframe_removals"):
        assert ts.stats[key] == js.stats[key], key
    assert ts.stats["loop_edges"] > 0 and ts.stats["global_ba"] > 0
    assert ts.pg.n == js.pg.n
    np.testing.assert_array_equal(tt, jt)
    assert tp.shape == jp.shape == (nframes, 7)
    np.testing.assert_allclose(tp, jp, atol=1e-4, rtol=0)
    for name in ("ii_inac", "jj_inac", "kk_inac"):
        np.testing.assert_array_equal(getattr(ts.pg, name), getattr(js.pg, name), name)
    jtw = np.concatenate([js.pg.target_inac, js.pg.weight_inac], 1)
    np.testing.assert_allclose(ts.pg.tw_inac.numpy(), jtw, atol=5e-3, rtol=0)
