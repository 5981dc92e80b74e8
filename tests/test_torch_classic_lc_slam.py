"""The JAX SLAM and the port's with the classical loop closure
(``CLASSIC_LOOP_CLOSURE``, ``CLASSIC_LOOP_SYNC``), side by side through
``torch_slam_pair`` on 40 rendered frames at 128 x 160 (ORB finds too few
keypoints at the harness's 64 x 96): an overhead camera circling a
textured plane (``render_plane``), ``LOOP_RETR_RADIUS`` 10,
``LOOP_RETR_THRESH`` 0.2 (the plane's views are self-similar, as in
``test_classic_lc.py``), the halved delta head and the JAX draws of the
other parity tests. The JAX Sim3 PGO solves in float64, as the port's
(``pgo_in_float64``, ROADMAP Queue 3). Both sides index the same frames,
make the same retrieval hits, closure attempts (4) and closures (1), and
give poses within 1e-4 per component after terminate()."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from render_plane import PlaneScene, overhead_loop_poses  # noqa: E402
from torch_slam_pair import pgo_in_float64, run_pair  # noqa: E402


HT, WD, F = 128, 160, 40
INTR = np.array([136.0, 136.0, 80.0, 64.0], np.float32)
CLASSIC = {"CLASSIC_LOOP_CLOSURE": True, "CLASSIC_LOOP_SYNC": True, "LOOP_RETR_RADIUS": 10,
           "LOOP_RETR_THRESH": 0.2, "BUFFER_SIZE": 64}


def test_classic_loop_closure_whole_slam_pair(monkeypatch):
    scene = PlaneScene(INTR, HT, WD, seed=3)
    gt = overhead_loop_poses(F)
    images = [scene.render(gt[f]) for f in range(F)]
    pgo_in_float64(monkeypatch)
    js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, overrides=CLASSIC, images=images,
                                          intrinsics=INTR, nframes=F)
    jlc, tlc = js.long_term_lc, ts.long_term_lc
    assert sorted(tlc.retrieval.kps) == sorted(jlc.retrieval.kps) == list(range(F))
    assert tlc.retrieval.hit_history == jlc.retrieval.hit_history
    for key in ("lc_attempts", "lc_applied", "updates", "keyframe_removals"):
        assert js.stats[key] == ts.stats[key], key
    assert ts.stats["lc_attempts"] > 0 and ts.stats["lc_applied"] > 0, ts.stats
    assert tlc.loop_pairs == jlc.loop_pairs
    assert js.pg.n == ts.pg.n
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
