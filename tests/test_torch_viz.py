"""The port's viewers and writers: the web viewer on a CPU SLAM at 64 x 96
(the page and ``state.json`` fetched over loopback, with the assertions of
``test_web_viewer.py``), its frustum segments within 1e-6 of the JAX
viewer's on the same poses, the snapshot viewer's PNGs, and the TUM, PLY
and COLMAP writers, whose text equals the JAX writers' from the same
arrays."""
import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cdvslam_tpu.viz.plot as jax_plot  # noqa: E402
import cdvslam_tpu.viz.web_viewer as jax_web  # noqa: E402
from cdvslam_tpu_torch.config import get_cfg  # noqa: E402
from cdvslam_tpu_torch.slam import SLAM  # noqa: E402
from cdvslam_tpu_torch.viz import plot, web_viewer  # noqa: E402

torch.set_num_threads(2)
HT, WD = 64, 96
INTR = np.array([50.0, 50.0, 48.0, 32.0], np.float32)


def _slam(network, viz, frames=8, **kw):
    cfg = get_cfg()
    cfg.PATCHES_PER_FRAME = 8
    cfg.BUFFER_SIZE = 32
    cfg.MOTION_PROBE_THR = -1.0
    slam = SLAM(cfg, network=network, ht=HT, wd=WD, viz=viz, device="cpu", **kw)
    rng = np.random.RandomState(0)
    for f in range(frames):
        slam(f, (rng.rand(HT, WD, 3) * 255).astype(np.uint8), INTR)
    return slam


@pytest.mark.parametrize("network", ["cdv", "dpv"])
def test_web_viewer_serves_live_state(network):
    slam = _slam(network, True, frames=12, viewer_port=0)
    viewer = slam.viewer
    assert isinstance(viewer, web_viewer.WebViewer) and viewer.port != 0
    viewer.refresh()
    base = f"http://127.0.0.1:{viewer.port}"
    page = urllib.request.urlopen(base + "/", timeout=5).read().decode()
    assert "three" in page and "OrbitControls" in page
    assert page == jax_web._PAGE
    state = json.loads(urllib.request.urlopen(base + "/state.json", timeout=5).read())
    assert state.keys() == {"n", "points", "colors", "traj", "frustum", "kf_frustums",
                            "weights", "segcolors", "segclass", "image"}
    assert state["n"] >= 2
    assert len(state["points"]) % 3 == 0 and len(state["points"]) > 0
    assert len(state["colors"]) == len(state["points"])
    assert len(state["weights"]) == len(state["points"]) // 3
    assert len(state["traj"]) == state["n"] * 3
    assert len(state["frustum"]) == 8 * 2 * 3
    assert len(state["kf_frustums"]) == state["n"] * 8 * 2 * 3
    assert state["image"]                        # the camera pane's JPEG
    # the last update's weights reached the per-patch weights
    assert slam.pg.weight is not None and min(state["weights"]) < 1.0
    poses, _ = slam.terminate()
    assert np.isfinite(poses).all()
    with pytest.raises(OSError):                 # join() stopped and closed the server
        urllib.request.urlopen(base + "/state.json", timeout=2)


def test_a_viewer_that_cannot_start_raises():
    """The JAX SLAM falls back to snapshots with a warning."""
    first = _slam("cdv", True, frames=0, viewer_port=0)
    with pytest.raises(OSError):
        _slam("cdv", True, frames=0, viewer_port=first.viewer.port)
    first.viewer.server.server_close()


def test_frustums_match_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    inv = np.concatenate([rng.standard_normal((9, 3)).astype(np.float32), q], 1)
    got, want = web_viewer._frustums_all(inv), jax_web._frustums_all(inv)
    assert len(got) == len(want) == 9 * 8 * 2 * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for pose in inv[:3]:
        got, want = web_viewer._frustum_segments(pose), jax_web._frustum_segments(pose)
        assert len(got) == 48
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_snapshot_viewer_writes_pngs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    slam = _slam("cdv", "snapshot", frames=12)
    assert (tmp_path / "viewer_out" / "frame_00010.png").stat().st_size > 1000
    slam.terminate()
    assert (tmp_path / "viewer_out" / "final.png").stat().st_size > 1000


def _fakes(rng, n=6, M=4):
    """A JAX-style and a port-style SLAM holding the same arrays."""
    poses = rng.standard_normal((n + 3, 7)).astype(np.float32)
    pts = rng.standard_normal((n * M, 3)).astype(np.float32) * 3
    pts[5] = np.nan                         # dropped from the PLY
    colors = rng.integers(0, 256, (n + 3, M, 3)).astype(np.uint8)

    def make(poses_buf):
        return SimpleNamespace(points=lambda: pts, ht=64, wd=96,
                               pg=SimpleNamespace(n=n, poses_=poses_buf, colors_=colors))
    return make(poses), make(torch.from_numpy(poses))


def test_writers_match_jax_text(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    jax_slam, port_slam = _fakes(rng)
    traj = (rng.standard_normal((10, 7)), np.arange(10) * 0.1)
    plot.save_trajectory_tum_format(traj, "port.txt")
    jax_plot.save_trajectory_tum_format(traj, "jax.txt")
    plot.save_ply("port", port_slam)
    jax_plot.save_ply("jax", jax_slam)
    plot.save_output_for_COLMAP("port_colmap", port_slam, 50.0, 51.0, 48.0, 32.0)
    jax_plot.save_output_for_COLMAP("jax_colmap", jax_slam, 50.0, 51.0, 48.0, 32.0)
    for a, b in [("port.txt", "jax.txt"), ("port.ply", "jax.ply")] + [
            (f"port_colmap/{f}", f"jax_colmap/{f}")
            for f in ("cameras.txt", "images.txt", "points3D.txt")]:
        text = (tmp_path / a).read_text()
        assert text == (tmp_path / b).read_text(), a
        assert len(text) > 30
    assert "element vertex 23" in (tmp_path / "port.ply").read_text()
    plot.plot_trajectory(traj, title="t", filename="port.pdf", gt_traj=traj)
    assert (tmp_path / "port.pdf").read_bytes()[:4] == b"%PDF"
