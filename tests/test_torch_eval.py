"""The port's evaluation pieces against the JAX package's, on seeded
inputs: the ATE (Umeyama alignment, ATE RMSE, timestamp association), the
harness's summary and its ATE against a TUM-format ground-truth file,
within 1e-12; the image-directory reader on rendered PNGs under a
4-number and an 8-number calibration and under ``crop_border``, and the
video reader on an MJPG ``.avi`` written by cv2, every (t, image,
intrinsics) bitwise equal; the reader's failures raised in the consumer;
and the tracer's host spans on the CPU (``utils.trace``, which replaced the
section timer)."""
import queue
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import cdvslam_tpu.eval.ate as jax_ate  # noqa: E402
import cdvslam_tpu.eval.harness as jax_harness  # noqa: E402
import cdvslam_tpu.slam.stream as jax_stream  # noqa: E402
from cdvslam_tpu_torch.eval import ate, harness  # noqa: E402
from cdvslam_tpu_torch.slam import stream  # noqa: E402
from cdvslam_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)


def _traj(rng, n=60):
    """A seeded (n, 7) trajectory and a scaled, rotated, noisy copy."""
    x = np.cumsum(rng.standard_normal((n, 3)) * 0.1, 0)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    y = 2.5 * x @ R.T + np.array([1.0, -2.0, 0.5]) + rng.standard_normal((n, 3)) * 0.01
    q = np.tile([0, 0, 0, 1.0], (n, 1))
    return np.concatenate([x, q], 1), np.concatenate([y, q], 1)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_and_ate_match_jax(with_scale):
    rng = np.random.default_rng(0)
    est, gt = _traj(rng)
    for a, b in zip(ate.umeyama_alignment(est[:, :3].T, gt[:, :3].T, with_scale),
                    jax_ate.umeyama_alignment(est[:, :3].T, gt[:, :3].T, with_scale)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for align in (True, False):
        got = ate.ate_rmse(est, gt, align=align, correct_scale=with_scale)
        want = jax_ate.ate_rmse(est, gt, align=align, correct_scale=with_scale)
        assert abs(got - want) <= 1e-12 and got > 0


def test_associate_timestamps_matches_jax():
    rng = np.random.default_rng(1)
    ta = np.sort(rng.uniform(0, 10, 80))
    tb = np.sort(rng.uniform(0, 10, 120))
    for max_diff in (0.01, 0.08, 0.5):
        got, want = ate.associate_timestamps(ta, tb, max_diff), \
            jax_ate.associate_timestamps(ta, tb, max_diff)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_summarize_and_tum_gt_ate_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    results = {f"scene{i}": list(rng.uniform(0, 1.5, 3)) for i in range(4)}
    got, want = harness.summarize(results), jax_harness.summarize(results)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k
    est, gt = _traj(rng, 50)
    t = np.arange(50) * 0.05
    gt_file = tmp_path / "gt.txt"
    np.savetxt(gt_file, np.concatenate([(t + 1e-3)[:, None], gt], 1))
    for max_diff in (0.08, 1e-4):
        g = harness.evaluate_against_tum_gt(est, t, gt_file, max_diff=max_diff)
        w = jax_harness.evaluate_against_tum_gt(est, t, gt_file, max_diff=max_diff)
        assert g == w if np.isinf(w) else abs(g - w) <= 1e-12
    g = harness.evaluate_against_pose_array(est, gt[:40])
    assert abs(g - jax_harness.evaluate_against_pose_array(est, gt[:40])) <= 1e-12


def _drain(reader, *args, **kwargs):
    q = queue.Queue()
    reader(q, *args, **kwargs)
    out = []
    while not q.empty():
        out.append(q.get())
    return out


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """Ten seeded 70 x 100 frames (not multiples of 16: the reader crops)."""
    d = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(4)
    for f in range(10):
        img = cv2.GaussianBlur((rng.rand(70, 100, 3) * 255).astype(np.uint8), (5, 5), 1.0)
        cv2.imwrite(str(d / f"{1000 + 7 * f}.png"), img)
    return d


@pytest.mark.parametrize("calib, kwargs", [
    ("60.0 61.0 50.0 35.0", {}),
    ("60.0 61.0 50.0 35.0 -0.28 0.07 0.0002 0.00002", {}),
    ("60.0 61.0 50.0 35.0 -0.28 0.07 0.0002 0.00002", {"crop_border": (8, 16), "stride": 2,
                                                       "skip": 1}),
    ("60.0 61.0 50.0 35.0", {"use_tstamp_names": True}),
])
def test_image_stream_matches_jax_bitwise(png_dir, tmp_path, calib, kwargs):
    cfile = tmp_path / "calib.txt"
    cfile.write_text(calib + "\n")
    kwargs = dict(kwargs)
    args = (str(png_dir), str(cfile), kwargs.pop("stride", 1), kwargs.pop("skip", 0))
    got = _drain(stream.image_stream, *args, **kwargs)
    want = _drain(jax_stream.image_stream, *args, **kwargs)
    assert len(got) == len(want) >= 5
    for (tg, ig, kg), (tw, iw, kw) in zip(got, want):
        assert tg == tw and type(tg) is type(tw)
        assert ig.shape == iw.shape and ig.shape[0] % 16 == 0 and ig.shape[1] % 16 == 0
        np.testing.assert_array_equal(ig, iw)
        np.testing.assert_array_equal(kg, kw)


def test_video_stream_matches_jax_bitwise(tmp_path):
    path = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (200, 140))
    rng = np.random.RandomState(5)
    for _ in range(12):
        writer.write(cv2.GaussianBlur((rng.rand(140, 200, 3) * 255).astype(np.uint8), (5, 5), 1))
    writer.release()
    cfile = tmp_path / "calib.txt"
    cfile.write_text("100.0 100.0 100.0 70.0\n")
    got = _drain(stream.video_stream, str(path), str(cfile), 2, 1)
    want = _drain(jax_stream.video_stream, str(path), str(cfile), 2, 1)
    assert len(got) == len(want) == 5 + 1            # (12 - 1) // 2 frames and the end marker
    assert got[-1][0] == -1
    for (tg, ig, kg), (tw, iw, kw) in zip(got[:-1], want[:-1]):
        assert tg == tw and ig.shape == (64, 96, 3)   # half of 140 x 200, cropped to 16
        np.testing.assert_array_equal(ig, iw)
        np.testing.assert_array_equal(kg, kw)
    np.testing.assert_array_equal(got[0][2], [50.0, 50.0, 50.0, 35.0])


def test_reader_failures_raise_in_the_consumer(tmp_path):
    """The JAX reader dies in its thread and its consumer waits forever;
    the port's ``read_frames`` raises what the thread raised."""
    cfile = tmp_path / "calib.txt"
    cfile.write_text("60.0 61.0 50.0 35.0\n")
    empty = tmp_path / "empty"
    empty.mkdir()
    q, th = stream.start_reader(stream.image_stream, str(empty), str(cfile))
    with pytest.raises(RuntimeError, match="reader failed") as err:
        list(stream.read_frames(q))
    assert isinstance(err.value.__cause__, FileNotFoundError)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "000000.png").write_bytes(b"not a png")
    q, th = stream.start_reader(stream.image_stream, str(bad), str(cfile))
    with pytest.raises(RuntimeError, match="reader failed") as err:
        list(stream.read_frames(q))
    assert "cannot decode" in str(err.value.__cause__)
    th.join(timeout=10)
    assert not th.is_alive()


def test_timer_on_the_cpu():
    """Two spans of one name on the host clock, their count and lengths;
    a record that is off (``SLAM(trace=False)``) times nothing."""
    owner = torch.nn.Module()
    rec = trace.new_record(owner, torch.device("cpu"))
    with rec.span("sleep"):
        time.sleep(0.02)
    with trace.OFF.span("sleep"):
        time.sleep(0.01)
    with rec.span("sleep"):
        time.sleep(0.01)
    got = [(e[3] - e[2]) / 1e9 for e in trace.raw_spans(rec, "sleep")]
    assert rec.totals["sleep"][0] == len(got) == 2
    assert 0.02 <= got[0] < 1.0 and 0.01 <= got[1] < 1.0
    assert rec.totals["sleep"][1] == sum(e[3] - e[2] for e in trace.raw_spans(rec, "sleep"))
