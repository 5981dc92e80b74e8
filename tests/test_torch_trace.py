"""The port's tracer on the CPU (``cdvslam_tpu_torch.utils.trace``).

The tracer alone: spans nest with their parents and frames, self time is
the span less its children, counts and the steady frames' sums, one
shared no-op span when a record is off, the bound of the raw ring, a span
from a second thread, and the records kept after ``terminate()``. A SLAM
at 64 x 96 with 8 patches: each steady frame is one ``frame`` span with
``keyframe`` (and its ``wait`` once decisions are queued), ``prepare``,
``launch`` and ``after``; its device row's stages in stamp order sum to no
more than the frame span; the counters' identities; ``trace=False`` gives
bitwise the same poses and records nothing. The reader thread's spans.
A traced run of the benchmark's cell on the CPU returns the twelve
per-layer metrics that read the tracer, each finite. The card's stamps are
tested on the card (``test_torch_cuda.py``)."""
import threading
import time

import numpy as np
import pytest
import torch

from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.slam import SLAM
from cdvslam_tpu_torch.utils import trace

torch.set_num_threads(2)
H, W, FRAMES = 64, 96, 16
INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)
READERS = ("span_host_ms_per_frame", "span_wait_ms_per_frame", "keyframe_ms_per_frame",
           "prepare_ms_per_frame", "launch_ms_per_frame", "prep_cache_hit_share",
           "eager_shift_share", "terminate_s", "features_device_ms", "update_device_ms",
           "ba_device_ms", "device_gap_ms_per_frame")


class _Owner:
    """Stands for a SLAM: a record keeps only a weak reference to it."""


def _frames(n=FRAMES):
    rng = np.random.RandomState(0)
    return [(rng.rand(H, W, 3) * 255).astype(np.uint8) for _ in range(n)]


def _run(frames, **kwargs):
    cfg = get_cfg()
    cfg.update(PATCHES_PER_FRAME=8, BUFFER_SIZE=32, MOTION_PROBE_THR=-1.0)
    slam = SLAM(cfg, "cdv", ht=H, wd=W, device="cpu", seed=0, **kwargs)
    for f, img in enumerate(frames):
        if f + 1 < len(frames):
            slam.prefetch(frames[f + 1])
        slam(f, img, INTR)
    poses, _ = slam.terminate()
    return slam, poses


@pytest.fixture(scope="module")
def traced():
    calls = []
    orig = SLAM._prepare_update

    def counted(self, *args):
        calls.append(1)
        return orig(self, *args)

    SLAM._prepare_update = counted
    try:
        slam, poses = _run(_frames())
    finally:
        SLAM._prepare_update = orig
    return slam, poses, len(calls)


def test_spans_nest_with_parents_self_time_and_counts():
    owner = _Owner()
    rec = trace.new_record(owner, torch.device("cpu"))
    with rec.span("frame", frame=7, steady=False) as fr:
        with rec.span("keyframe"):
            with rec.span("wait"):
                time.sleep(0.004)
            time.sleep(0.002)
        with rec.span("launch"):
            time.sleep(0.003)
        fr.set(steady=True)
    with rec.span("keyframe"):
        pass
    spans = {e[1]: e for e in trace.raw_spans(rec) if e[5] == 7}
    assert spans["wait"][4] == spans["keyframe"][0] and spans["launch"][4] == spans["frame"][0]
    assert spans["frame"][4] is None and all(e[6] == rec.id for e in spans.values())
    assert spans["frame"][8]["steady"] is True
    assert rec.totals["keyframe"][0] == 2 and rec.totals["wait"][0] == 1
    count, total, own = rec.steady["keyframe"]
    assert count == 1 and own == total - rec.steady["wait"][1] and own >= 2e6
    frame = rec.steady["frame"]
    assert frame[2] == frame[1] - rec.steady["keyframe"][1] - rec.steady["launch"][1]
    assert rec.steady_frames == 1 and frame[1] >= 9e6


def test_off_is_one_shared_no_op():
    before = len(trace.TRACER.spans)
    a, b = trace.OFF.span("frame", frame=1), trace.OFF.span("keyframe")
    assert a is b is trace.NOSPAN
    with a as s:
        s.set(steady=True)
        s.rename("x")
        trace.OFF.stamp(0, advance=True)
        trace.OFF.row_done("replay")
    assert len(trace.TRACER.spans) == before and not trace.OFF.on


def test_the_raw_ring_is_bounded():
    rec = trace.new_record(_Owner(), None)
    for i in range(trace.RING_SPANS + 10):
        with rec.span("tick", frame=i):
            pass
    assert len(trace.TRACER.spans) == trace.RING_SPANS == trace.TRACER.spans.maxlen
    kept = trace.raw_spans(rec, "tick")
    assert kept[0][5] == 10 and kept[-1][5] == trace.RING_SPANS + 9
    assert rec.totals["tick"][0] == trace.RING_SPANS + 10


def test_a_span_from_a_second_thread():
    owner = _Owner()
    rec = trace.new_record(owner, None)
    seen = {}

    def work():
        with rec.span("prefetch"):
            seen["tid"] = threading.get_ident()

    with rec.span("frame", frame=1, steady=True):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    pre = trace.raw_spans(rec, "prefetch")[0]
    frame = trace.raw_spans(rec, "frame")[0]
    assert pre[4] is None and pre[7] == seen["tid"] != frame[7]
    assert "prefetch" not in rec.steady and rec.totals["prefetch"][0] == 1


def test_ended_records_outlive_their_owner_up_to_the_cap():
    owners = [_Owner() for _ in range(trace.KEEP_ENDED + 3)]
    recs = [trace.new_record(o, None) for o in owners]
    for r in recs:
        r.end()
    gone = trace.new_record(_Owner(), None)     # its owner is freed at once
    del owners
    trace.new_record(_Owner(), None)
    ended = trace.ended()
    assert len(ended) == trace.KEEP_ENDED and ended[-1] is recs[-1]
    assert trace.ended(2) == recs[-2:] and gone not in trace.TRACER.records()
    assert trace.ended(trace.KEEP_ENDED + 5) == ended and trace.ended(0) == []


def test_each_steady_frame_has_its_spans_and_its_stages(traced):
    slam, poses, _ = traced
    rec = slam.trace
    spans = trace.raw_spans(rec)
    frames = [e for e in spans if e[1] == "frame" and e[8].get("steady")]
    assert len(frames) == rec.steady_frames == FRAMES - 8
    rows = {r.frame: r for r in trace.raw_rows(rec, "replay")}
    for i, fr in enumerate(frames):
        kids = [e for e in spans if e[4] == fr[0]]
        assert sorted(e[1] for e in kids) == ["after", "keyframe", "launch", "prepare"]
        kf = next(e for e in kids if e[1] == "keyframe")
        waits = [e for e in spans if e[4] == kf[0] and e[1] == "wait"]
        assert len(waits) == (1 if i >= 2 else 0)
        assert fr[8]["E"] > 0 and fr[8]["E_pad"] >= fr[8]["E"]
        row = rows[fr[5]]
        assert row.steady
        st = row.stages
        order = [st[k] for k in ("shift", "features", "patches", "update", "ba")]
        assert min(order) >= 0 and st["upload"] >= 0
        assert sum(order) == row.end_ns - row.start_ns <= fr[3] - fr[2]
        assert fr[2] <= row.start_ns and row.end_ns <= fr[3]
    assert rec.stages["features"][0] == rec.replay[0] == FRAMES - 8
    assert rec.gap[0] == FRAMES - 9 and sum(v[0] for v in rec.gaps.values()) == rec.gap[0]
    assert rec.ended and rec.lost_rows == 0 and rec.totals["terminate"][0] == 1
    assert [r.kind for r in trace.raw_rows(rec)].count("update") == 24
    assert np.isfinite(poses).all()


def test_counter_identities(traced):
    slam, _, prepares = traced
    s = slam.stats
    assert s["prep_cache_hits"] + s["prep_cache_misses"] == prepares > 0
    assert s["shifts_eager"] + s["shifts_deferred"] == s["keyframe_removals"] > 0
    assert slam.trace.stats is s


def test_trace_off_gives_the_same_poses_and_records_nothing(traced):
    _, poses, _ = traced
    before = trace.TRACER.spans[-1], trace.TRACER.rows[-1]
    slam, off = _run(_frames(), trace=False)
    assert slam.trace is trace.OFF
    assert np.array_equal(off, poses)
    assert (trace.TRACER.spans[-1], trace.TRACER.rows[-1]) == before
    assert not any(r.owner() is slam for r in trace.TRACER.records() if r.owner)


def test_the_reader_threads_spans(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from cdvslam_tpu_torch.slam import stream
    rng = np.random.RandomState(1)
    for f in range(5):
        cv2.imwrite(str(tmp_path / f"{f:06d}.png"), (rng.rand(32, 48, 3) * 255).astype(np.uint8))
    (tmp_path / "calib.txt").write_text("40.0 40.0 24.0 16.0\n")
    proc = trace.TRACER.process
    decoded = proc.totals.get("reader.decode", [0])[0]
    waited = proc.totals.get("reader.wait", [0])[0]
    q, th = stream.start_reader(stream.image_stream, str(tmp_path), str(tmp_path / "calib.txt"))
    got = list(stream.read_frames(q))
    th.join(timeout=10)
    assert not th.is_alive() and len(got) == 5
    assert proc.totals["reader.decode"][0] == decoded + 5
    assert proc.totals["reader.wait"][0] == waited + 6
    tids = {e[7] for e in trace.raw_spans(proc, "reader.decode")[-5:]}
    assert tids == {th.ident} and th.ident != threading.get_ident()


def test_a_traced_cell_run_reads_the_twelve_metrics():
    from portbench import cell
    from portbench.tests.test_portbench_correct import SEED, SHRINK
    result, _ = cell.run("dpvo.euroc-stream", SEED, 0.1, 1, device="cpu", shrink=SHRINK,
                         log=lambda obj: None)
    got = result["metrics"]
    for name in READERS:
        assert name in got and np.isfinite(got[name]["value"]), name
    assert 0 < got["prep_cache_hit_share"]["value"] <= 1
    assert 0 <= got["eager_shift_share"]["value"] <= 1


def test_the_heads_stages_lie_inside_features_and_after_ba(traced):
    """A SLAM with the seg and depth heads (SCORE, FILTER_DYNAMIC_CLASS)
    stamps ``select`` (SCORE's selection, then the chosen patches' seg
    class) and ``depth`` inside ``features``, and ``scale`` after ``ba``
    up to the step's end; the main path's rows (``traced``) have none of
    them and keep their stages."""
    cfg = get_cfg()
    cfg.update(PATCHES_PER_FRAME=8, BUFFER_SIZE=32, MOTION_PROBE_THR=-1.0,
               CENTROID_SEL_STRAT="SCORE", SEG_HEAD="random", DEPTH_HEAD="random",
               FILTER_DYNAMIC_CLASS=True)
    slam = SLAM(cfg, "cdv", ht=H, wd=W, device="cpu", seed=0)
    for f, img in enumerate(_frames()):
        slam(f, img, INTR)
    rec = slam.trace
    rows = trace.raw_rows(rec, "replay")
    assert len(rows) == FRAMES - 8 and rec.stages["scale"][0] == FRAMES - 8
    for row in rows:
        st = row.stages
        assert set(st) == {"shift", "features", "patches", "update", "ba", "scale", "upload",
                           "select", "depth"}
        order = [st[k] for k in ("shift", "features", "patches", "update", "ba", "scale")]
        assert min(order) >= 0 and sum(order) == row.end_ns - row.start_ns
        assert 0 <= st["select"] and 0 <= st["depth"] and st["select"] + st["depth"] <= st["features"]
    # the last replay's stamps in the CPU ring, in order: after the shift
    # (1), SCORE (8-9), the seg class (10-11), the depth head (12-13), the
    # networks' end (2); the update operator's end (4), the scale start
    # (14), the step's end (5)
    t = rec._dev.ring[(rec._dev.cursor - 1) % trace.RING_DEVICE]
    assert list(t[[1, 8, 9, 10, 11, 12, 13, 2]]) == sorted(t[[1, 8, 9, 10, 11, 12, 13, 2]])
    assert t[4] <= t[14] <= t[5]
    inserts = trace.raw_rows(rec, "insert")
    assert inserts and all("select" in r.stages and "scale" not in r.stages for r in inserts)
    main = traced[0].trace
    for kind, stages in (("replay", ("shift", "features", "patches", "update", "ba", "upload")),
                         ("insert", ("features", "patches", "upload")), ("update", ("update", "ba"))):
        assert all(set(r.stages) == set(stages) for r in trace.raw_rows(main, kind)), kind
    assert not {"select", "depth", "scale"} & set(main.stages)
