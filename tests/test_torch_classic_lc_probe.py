"""Frames the motion probe drops before initialization, with the
classical backend on: both SLAMs (``torch_slam_pair``, 14 random frames
at 64 x 96) index every frame under its own id, the dropped ones too,
and ask the retrieval for a loop only for kept frames: ``pg.counter - 1``
is read right after a kept frame (the 8th keyframe's initialization and
each steady-state frame, and terminate()), never after a dropped one. The probe is
scripted on both sides (frames 2 and 3 dropped)."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cdvslam_tpu.loop.retrieval import RetrievalBoW as JaxRetrievalBoW  # noqa: E402
from cdvslam_tpu.slam import SLAM as JaxSLAM  # noqa: E402
from cdvslam_tpu_torch.loop.retrieval import RetrievalBoW  # noqa: E402
from cdvslam_tpu_torch.slam import SLAM  # noqa: E402
from torch_slam_pair import FRAMES, run_pair  # noqa: E402

DROPPED = (2, 3)


def test_dropped_frames_are_indexed_and_never_queried(monkeypatch):
    queried = {"jax": [], "port": []}
    for cls, side in ((JaxRetrievalBoW, "jax"), (RetrievalBoW, "port")):
        def logged(self, frame_id, thresh=None, detect=cls.detect_loop, log=queried[side]):
            log.append(frame_id)
            return detect(self, frame_id, thresh)
        monkeypatch.setattr(cls, "detect_loop", logged)
    for cls in (JaxSLAM, SLAM):
        monkeypatch.setattr(cls, "motion_probe",
                            lambda self: 0.0 if self.pg.counter - 1 in DROPPED else 1.0)
    js, ts, (jp, jt), (tp, tt) = run_pair(monkeypatch, motion_probe_thr=0.5,
                                          overrides={"CLASSIC_LOOP_CLOSURE": True,
                                                     "CLASSIC_LOOP_SYNC": True})
    kept = [f for f in range(FRAMES) if f not in DROPPED]
    for slam in (js, ts):
        assert sorted(slam.long_term_lc.retrieval.kps) == list(range(FRAMES))
        assert sorted(slam.pg.delta)[:2] == list(DROPPED)
    # the first query is the initialization's (the 8th kept frame), then
    # one per frame, and terminate()'s last attempt asks for the last again
    assert queried["port"] == queried["jax"] == kept[7:] + kept[-1:]
    assert ts.stats["lc_attempts"] == js.stats["lc_attempts"] == 0
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
