"""The port's evaluation harness (``eval.harness.run_sequence``) over the
JAX SLAM pair's frames: 16 rendered frames at 64 x 96 (a camera circling
a textured plane, ``render_plane``), written as PNGs with the exactly
representable calibration 80 80 48 32. ``run_pair`` drives the JAX and
the port SLAMs directly (the JAX weights and draws; the harness's usual
64 x 96, 8 patches, MIXED_PRECISION off and the halved delta head); then
``run_sequence(device="cpu", state_dict=..., patch_sampler=...)`` reads
the PNGs through the reader thread and the BGR -> RGB flip into a second
port SLAM with the same weights and draws. Tolerances: the harness's
poses equal the directly driven port SLAM's bitwise, and lie within 1e-4
of the JAX SLAM's (run_pair's rule); the patch colours ``pg.colors_``
within one uint8 level of the JAX SLAM's, with keyframe removals among
the frames; ``points()`` on the JAX SLAM's state within 1e-4 (relative
and absolute) of the JAX ``points()``. On each run's own state the points
differ by up to 4e-3 relative (0.28 absolute at 9,660 units): the BA's
float32 rounding moves the inverse depths by up to 3e-4 relative, and a
patch at the 1e-4 inverse-depth clamp multiplies the poses' 1.7e-5 by
1e4."""
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from render_plane import PlaneScene, overhead_loop_poses  # noqa: E402
from torch_slam_pair import _cfg, jax_patch_sampler, run_pair  # noqa: E402

from cdvslam_tpu_torch.config import get_cfg  # noqa: E402
from cdvslam_tpu_torch.eval.harness import run_sequence  # noqa: E402
from cdvslam_tpu_torch.models.convert import load_flax_params  # noqa: E402

torch.set_num_threads(2)

HT, WD, F = 64, 96, 16
INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    d = tmp_path_factory.mktemp("harness")
    scene = PlaneScene(INTR, HT, WD, seed=5)
    gt = overhead_loop_poses(F)
    images = [scene.render(gt[f]) for f in range(F)]
    (d / "images").mkdir()
    for f, img in enumerate(images):
        cv2.imwrite(str(d / "images" / f"{f:06d}.png"), img[..., ::-1])
    (d / "calib.txt").write_text(" ".join(str(float(x)) for x in INTR) + "\n")
    return images, str(d / "images"), str(d / "calib.txt")


def test_harness_equals_the_direct_port_slam_and_holds_to_jax(monkeypatch, rendered):
    images, imagedir, calib = rendered
    js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, images=images, intrinsics=INTR,
                                          nframes=F)
    cfg = _cfg(get_cfg, None, -1.0)
    sink = []
    hp, ht = run_sequence(cfg, imagedir, calib, device="cpu", slam_sink=sink,
                          state_dict=load_flax_params(js.params),
                          patch_sampler=jax_patch_sampler("cdv", cfg.CENTROID_SEL_STRAT,
                                                          cfg.PATCHES_PER_FRAME, HT, WD))
    hs = sink[0]
    assert hs.stats == ts.stats and ts.stats["keyframe_removals"] > 0, ts.stats
    assert ts.stats["keyframe_removals"] == js.stats["keyframe_removals"]
    np.testing.assert_array_equal(ht, tt)
    np.testing.assert_array_equal(hp, tp)
    np.testing.assert_array_equal(hs.points(), ts.points())
    np.testing.assert_array_equal(hs.pg.colors_, ts.pg.colors_)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)

    n, m = ts.pg.n, ts.pg.m
    assert js.pg.n == n and js.pg.m == m
    assert ts.points().shape == (m, 3) and np.isfinite(ts.points()).all()
    tc, jc = ts.pg.colors_[:n].astype(int), js.pg.colors_[:n].astype(int)
    assert np.abs(tc - jc).max() <= 1
    assert tc.std() > 10           # the plane's texture, not a constant

    # points() on the JAX SLAM's state: the two runs' states differ by the
    # BA's float32 rounding (inverse depths by up to 3e-4 relative), and
    # patches at the 1e-4 inverse-depth clamp sit 1e4 units away, where
    # the poses' 1.7e-5 becomes 0.2
    for name in ("poses_", "patches_", "intrinsics_"):
        setattr(ts.pg, name, torch.from_numpy(np.array(getattr(js.pg, name))))
    np.testing.assert_allclose(ts.points(), js.points(), rtol=1e-4, atol=1e-4)


def test_harness_wants_a_card_unless_told(monkeypatch, rendered):
    """It raises before the reader reads a frame."""
    _, imagedir, calib = rendered
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sequence(_cfg(get_cfg, None, -1.0), imagedir, calib)


def test_a_missing_network_checkpoint_raises(rendered, tmp_path):
    """The JAX harness runs random weights when ``network`` is not a file."""
    _, imagedir, calib = rendered
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        run_sequence(_cfg(get_cfg, None, -1.0), imagedir, calib, device="cpu",
                     network=str(tmp_path / "missing.pth"))
