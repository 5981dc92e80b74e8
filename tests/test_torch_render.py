"""The port's JAX-free plane renderer (``cdvslam_tpu_torch.data.render``)
against the JAX test renderer (``tests/render_plane.py``) and the proof
tool (``tools/train_e2e_proof.py``, imported by path).

Tolerances: the textures equal; images within one intensity level
everywhere and unequal on at most 0.1% of the values (the JAX renderer
inverts the pose in float32, the port in float64; measured: a maximum of
one level on at most 5.3e-5 of the values over seeds 0, 3 and 11 at
192 x 256); true inverse depths within 1e-5 relative (measured 9.0e-8);
``overhead_loop_poses`` and ``random_walk_poses`` within 1e-6 (float32
quaternion products on the JAX side; measured 4.8e-7); the proof's
``make_clip`` against the tool's from the same ``RandomState``: images by
the image rule, poses within 1e-5 and disparities within 1e-5 relative
(the tool normalizes float32 disparities, the port float64: measured
2.8e-7 and 4.6e-7), the same intrinsics, and the generators left in the
same state; and the clip's ground truth is what the rollout needs: a
patch centre reprojected by ``geom.transform`` with the normalized poses
and the inverse depth sampled from the disparities lands within 0.1 px
(quarter resolution) of the plane point's true projection (measured on
its 1,024 edges: 0.0070 median, 0.080 at most; the disparities are
sampled at pixel centres + 0.5). ``chip_smoke.py``'s renders (phases "6-classic" and 10,
``tests/test_torch_cuda.py``: ``PlaneScene(EUROC_INTR, 480, 752,
seed=3)`` on ``loop_path(120, 100)``) are the ones its own renderer drew
before it moved here: stored SHA-256 prefixes of three frames."""
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cv2")

import torch  # noqa: E402

import render_plane as jax_render  # noqa: E402
from cdvslam_tpu_torch.data import render  # noqa: E402
from cdvslam_tpu_torch.geom import transform  # noqa: E402
from cdvslam_tpu_torch.lie import SE3  # noqa: E402
from cdvslam_tpu_torch.models.patchifier import coords_grid_with_index  # noqa: E402
from cdvslam_tpu_torch.ops.patchify import patchify  # noqa: E402
from cdvslam_tpu_torch.train import e2e_proof  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
INTR = np.array([220.0, 220.0, 128.0, 96.0])
EUROC_INTR = (458.654, 457.296, 367.215, 248.375)


def _tool():
    spec = importlib.util.spec_from_file_location("train_e2e_proof",
                                                  ROOT / "tools" / "train_e2e_proof.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _images_agree(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.shape == b.shape and d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_plane_scene_matches_the_jax_renderer(seed):
    poses = np.concatenate([np.asarray(jax_render.overhead_loop_poses(12)),
                            _tool().random_walk_poses(np.random.RandomState(seed), 8)])
    want = jax_render.PlaneScene(INTR, 192, 256, seed=seed)
    got = render.PlaneScene(INTR, 192, 256, seed=seed)
    assert np.array_equal(got.tex, want.tex)
    _images_agree(np.stack([got.render(p) for p in poses]),
                  np.stack([want.render(p) for p in poses]))
    rng = np.random.RandomState(seed)
    px, py = rng.uniform(0, 64, 50), rng.uniform(0, 48, 50)
    for p in poses:
        np.testing.assert_allclose(got.true_inv_depth(p, px, py),
                                   want.true_inv_depth(p, px, py, res=4), rtol=1e-5)


def test_pose_paths_match_the_jax_versions():
    for F, kw in ((48, {}), (40, {"height": 1.6, "radius": 0.7})):
        np.testing.assert_allclose(render.overhead_loop_poses(F, **kw),
                                   np.asarray(jax_render.overhead_loop_poses(F, **kw)), atol=1e-6)
    tool = _tool()
    for seed in range(3):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_allclose(render.random_walk_poses(a, 8), tool.random_walk_poses(b, 8),
                                   atol=1e-6)
        assert a.randint(1 << 30) == b.randint(1 << 30)


def test_make_clip_matches_the_tools():
    tool = _tool()
    a, b = np.random.RandomState(0), np.random.RandomState(0)
    want = tool.make_clip(jax_render.PlaneScene(tool.INTR, tool.HT, tool.WD, seed=0), a)
    got = e2e_proof.make_clip(render.PlaneScene(e2e_proof.INTR, e2e_proof.HT, e2e_proof.WD,
                                                seed=0), b)
    _images_agree(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])
    assert a.randint(1 << 30) == b.randint(1 << 30)


def test_make_clip_ground_truth_reprojects_onto_the_plane():
    scene = render.PlaneScene(e2e_proof.INTR, e2e_proof.HT, e2e_proof.WD, seed=0)
    images, poses, disps, intr = e2e_proof.make_clip(scene, np.random.RandomState(0))
    F, M = len(poses), 16
    rng = np.random.RandomState(1)
    c = torch.tensor(np.stack([rng.uniform(2, 77, (F, M)), rng.uniform(2, 57, (F, M))], -1))
    patches = patchify(coords_grid_with_index(torch.tensor(disps)[None])[0], c, 1,
                       mode="bilinear").reshape(F * M, 3, 3, 3)
    ii = torch.arange(F).repeat_interleave(F * M)
    jj = torch.arange(F).repeat_interleave(M).repeat(F)
    kk = ii * M + torch.arange(M).repeat(F * F)
    got = transform(SE3(torch.tensor(poses)[None]), patches[None],
                    torch.tensor(intr / 4).expand(1, F, 4), ii, jj, kk)[0][:, 1, 1].numpy()
    # the truth: the ray from frame i to the plane z = 0 (the normalization
    # scales the world about its origin, which keeps the plane), projected
    # into frame j
    fx, fy, cx, cy = intr / 4
    for e in range(len(ii)):
        i, j, k = int(ii[e]), int(jj[e]), int(kk[e])
        x, y = patches[k, 0, 1, 1].item(), patches[k, 1, 1, 1].item()
        Ri, Rj = render._qmat(poses[i, 3:]), render._qmat(poses[j, 3:])
        d = np.array([(x - cx) / fx, (y - cy) / fy, 1.0]) @ Ri
        C = -Ri.T @ poses[i, :3]
        X = C - C[2] / d[2] * d
        Xc = Rj @ X + poses[j, :3]
        err = np.hypot(fx * Xc[0] / Xc[2] + cx - got[e, 0], fy * Xc[1] / Xc[2] + cy - got[e, 1])
        assert err <= 0.1, (e, err)


def test_chip_smoke_renders_are_unchanged():
    scene = render.PlaneScene(EUROC_INTR, 480, 752, seed=3)
    poses = render.loop_path(120, 100)
    digests = {f: hashlib.sha256(scene.render(poses[f]).tobytes()).hexdigest()[:16]
               for f in (0, 57, 119)}
    assert digests == {0: "f6049ef994e40df1", 57: "9fa3e5be07a130ec", 119: "3eba196feec27902"}
