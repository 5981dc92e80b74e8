"""The six dataset evaluations of the port (``cdvslam_tpu_torch.eval.<name>``)
against the JAX scripts (``evaluate_<name>.py`` at the repo root, their
``main()`` with ``sys.argv`` patched), on the tiny trees of
test_torch_datasets.py. In each module the ``run_sequence`` it imports
from its harness is replaced by a recorder: it runs that side's own
``image_stream`` on the arguments it was handed and returns one seeded
trajectory with the frame stamps, shared by both sides. Held equal: the
scenes visited in order, the config, the calibration handed over (by the
values in the file), stride, skip, crop and the other arguments, the
frames the reader yields from them (stamps, images bitwise,
intrinsics), and the summaries to 1e-12 (so TartanAir's NED permutation
of the ground truth, KITTI's P0 conversion, nuScenes' half-resolution
intrinsics and TUM's crop enter both sides alike). The deliberate
differences are asserted as such: the JAX EuRoC script associates
seconds with the ground truth's nanoseconds and reports an infinite ATE
where the port's is finite, and the port writes its derived calibrations
to results/calib/ where the JAX scripts write calib/. Each case runs in a
temporary working directory holding copies of calib/ and config/ (the
JAX KITTI and nuScenes scripts write into calib/), and the repo's calib/
is checked unchanged."""
import hashlib
import importlib.util
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cv2")

import cdvslam_tpu.slam.stream as jax_stream  # noqa: E402
import cdvslam_tpu_torch.slam.stream as port_stream  # noqa: E402
from test_torch_datasets import _euroc, _icl, _kitti, _nuscene, _tartan, _tum  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPTS = ["--opts", "PATCHES_PER_FRAME", "8", "BUFFER_SIZE", "64"]
SCRIPTS = {"euroc": "evaluate_euroc.py", "tum": "evaluate_tum.py",
           "tartan": "evaluate_tartan.py", "kitti": "evaluate_kitti.py",
           "icl_nuim": "evaluate_icl_nuim.py", "nuscene": "evaluate_nuscene.py"}


class _Frames(list):
    """A queue for ``image_stream`` that keeps what it is given."""

    def put(self, item):
        self.append(item)


def _trajectory(n):
    """The shared trajectory: a seeded walk of n poses (identity rotations)."""
    xyz = np.cumsum(np.random.RandomState(n).standard_normal((n, 3)) * 0.05, 0)
    return np.concatenate([xyz, np.tile([0, 0, 0, 1.0], (n, 1))], 1)


def _recorder(stream, calls):
    def run_sequence(cfg, imagedir, calib, stride=1, skip=0, version="cdv", network="",
                     viz=False, crop_border=None, **rest):
        frames = _Frames()
        stream.image_stream(frames, imagedir, calib, stride, skip, crop_border=crop_border)
        frames = [f for f in frames if f[0] >= 0]
        calls.append({"cfg": dict(cfg), "imagedir": str(Path(imagedir).resolve()),
                      "calib": str(calib), "calib_values": np.loadtxt(calib),
                      "args": (stride, skip, version, network, viz, crop_border),
                      "frames": frames, "rest": rest})
        return _trajectory(len(frames)), np.arange(len(frames), dtype=np.float64)
    return run_sequence


def _calib_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "calib").iterdir())}


@pytest.mark.parametrize("make", [_euroc, _tum, _tartan, _kitti, _icl, _nuscene],
                         ids=list(SCRIPTS))
def test_evaluation_matches_the_jax_script(tmp_path, monkeypatch, make):
    before = _calib_digest()
    module, args, scene = make(tmp_path / "data")
    name = module.__name__.rsplit(".", 1)[1]
    work = tmp_path / "work"
    work.mkdir()
    for d in ("calib", "config"):
        shutil.copytree(ROOT / d, work / d)
    gt = work / "datasets" / "euroc_groundtruth"
    gt.mkdir(parents=True)
    shutil.copy(ROOT / "datasets" / "euroc_groundtruth" / "MH_01_easy.txt", gt)
    monkeypatch.chdir(work)

    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / SCRIPTS[name])
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jax_calls, port_calls, jax_summary = [], [], []
    monkeypatch.setattr(script, "run_sequence", _recorder(jax_stream, jax_calls))
    monkeypatch.setattr(module, "run_sequence", _recorder(port_stream, port_calls))
    summarize = script.summarize
    monkeypatch.setattr(script, "summarize", lambda r: jax_summary.append(summarize(r)) or
                        jax_summary[-1])
    monkeypatch.setattr(sys, "argv", [SCRIPTS[name], *args, *OPTS])
    script.main()
    summary = module.main(args + OPTS + ["--device", "cpu"])

    assert len(jax_calls) == len(port_calls) == 1
    (j,), (p,) = jax_calls, port_calls
    assert p["imagedir"] == j["imagedir"]
    assert p["cfg"] == j["cfg"]
    assert p["args"] == j["args"]
    assert j["rest"] == {} and p["rest"] == {"device": "cpu"}
    np.testing.assert_array_equal(p["calib_values"], j["calib_values"])
    assert len(p["frames"]) == len(j["frames"]) > 0
    for (pt, pim, pk), (jt, jim, jk) in zip(p["frames"], j["frames"]):
        assert pt == jt and np.array_equal(pim, jim)
        np.testing.assert_array_equal(pk, jk)
    assert list(summary) == list(jax_summary[0]) == [scene, "AVG", "AUC"]

    if name == "euroc":      # seconds against nanoseconds: no pair, an infinite ATE
        assert jax_summary[0][scene] == float("inf") and np.isfinite(summary[scene])
    else:
        for k, v in summary.items():
            assert abs(v - jax_summary[0][k]) <= 1e-12 * max(1.0, abs(v)), (k, v, jax_summary)
    if name in ("kitti", "nuscene"):   # the derived calibration: results/calib/ here
        stem = Path(j["calib"]).name
        assert j["calib"] == f"calib/{stem}" and p["calib"] == str(Path("results/calib") / stem)
    if name == "tum":
        assert p["args"][-1] == (8, 16)
    if name == "tartan":
        assert module.NED_PERM == script.NED_PERM
    assert _calib_digest() == before
