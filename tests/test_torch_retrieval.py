"""The port's ORB + BoW retrieval (``loop/retrieval.py`` over its own copy
of ``native/retrieval.cpp``): ports of ``test_retrieval.py``, and the
JAX package's library on the same images giving exactly the same query
ids, scores and matches."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cdvslam_tpu.loop.retrieval import RetrievalBoW as JaxRetrievalBoW  # noqa: E402
from cdvslam_tpu_torch.loop import retrieval  # noqa: E402
from cdvslam_tpu_torch.loop.retrieval import RetrievalBoW  # noqa: E402


def _textured(seed, H=240, W=320):
    rng = np.random.RandomState(seed)
    img = (rng.rand(H // 8, W // 8) * 255).astype(np.uint8)
    img = cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)
    img = cv2.GaussianBlur(img, (5, 5), 1.0)
    return img


def _two_passes(r):
    """12 scenes, then the same 12 shifted by (3, 2) pixels."""
    scenes = [_textured(s) for s in range(12)]
    fid = 0
    for rep in range(2):
        for img in scenes:
            if rep == 1:
                M = np.float32([[1, 0, 3], [0, 1, 2]])
                img = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))
            r.insert_image(img, fid)
            fid += 1


def test_library_builds_from_the_ports_source_into_build():
    path = retrieval.build()
    assert path.parent == retrieval.BUILD_DIR and path.exists()
    assert retrieval.BUILD_DIR.parts[-2:] == ("build", "native")
    assert retrieval.SOURCE.parent.parent.name == "cdvslam_tpu_torch"
    assert "cdvslam_tpu/" not in str(retrieval._load_lib()._name)


def test_insert_query_roundtrip():
    r = RetrievalBoW(rad=5, thresh=0.0, train_threshold=2000)
    _two_passes(r)
    assert r.trained
    hits = 0
    for s in range(12):
        q = r.query(12 + s, topk=4)
        if any(j == s for j, _ in q):
            hits += 1
    assert hits >= 9, f"only {hits}/12 revisits retrieved"


def test_match_pair():
    r = RetrievalBoW(rad=1, train_threshold=10**9)
    img = _textured(0)
    M = np.float32([[1, 0, 5], [0, 1, 3]])
    img2 = cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))
    r.insert_image(img, 0)
    r.insert_image(img2, 1)
    a, b = r.match(0, 1)
    assert len(a) >= 20
    # matched keypoints should differ by ~the shift
    d = b - a
    med = np.median(d, axis=0)
    assert abs(med[0] - 5) < 1.5 and abs(med[1] - 3) < 1.5


def test_queries_and_matches_equal_the_jax_librarys():
    sides = [cls(rad=5, thresh=0.0, train_threshold=2000)
             for cls in (JaxRetrievalBoW, RetrievalBoW)]
    for r in sides:
        _two_passes(r)
    assert all(r.trained for r in sides)
    for fid in range(24):
        assert sides[0].query(fid) == sides[1].query(fid), fid
        np.testing.assert_array_equal(sides[0].kps[fid], sides[1].kps[fid])
    for i, j in ((12, 0), (13, 1), (5, 17), (3, 4)):
        for a, b in zip(sides[0].match(i, j), sides[1].match(i, j)):
            np.testing.assert_array_equal(a, b)
    hits = [[r.detect_loop(fid, thresh=0.05) for fid in range(12, 24)] for r in sides]
    assert hits[0] == hits[1]


def test_a_repeated_query_completes_the_repetition_check():
    """A fault of the JAX backend that the port keeps (ROADMAP Queue 3):
    ``LongTermLoopClosure.terminate`` queries the newest frame a second
    time, and its hit enters the 3-hit repetition check twice, so two
    frames pass it; the loop frame it returns is the middle entry, the
    newest frame, which has no frame after it for its triplet."""
    for cls in (JaxRetrievalBoW, RetrievalBoW):
        r = cls(rad=5, thresh=0.0, train_threshold=2000)
        _two_passes(r)
        assert r.detect_loop(22) is None and r.detect_loop(23) is None
        hit = r.detect_loop(23)
        assert hit is not None and hit[0] == 23 == max(r.kps), (cls, hit)
