"""The six dataset evaluations (``python -m cdvslam_tpu_torch.eval.<name>``)
on the CPU, each on a tiny tree in its dataset's own layout (24 seeded
frames at 64 x 96, run at the evaluation's stride, 8 patches,
MOTION_PROBE_THR -1 so the random network initializes): each reads its
scene, runs the harness, finds its ground truth and returns a finite ATE
for the scene in its summary, and writes results/ in the working
directory (derived calibrations under results/calib/). The EuRoC case
uses the shipped ground truth of MH_01_easy (nanosecond stamps) and also
shows the JAX script's association: image stamps in seconds against the
ground truth's nanoseconds, which matches nothing (an infinite ATE)."""
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import cdvslam_tpu.eval.harness as jax_harness  # noqa: E402
from cdvslam_tpu_torch.eval import euroc, icl_nuim, kitti, nuscene, tartan, tum  # noqa: E402
from cdvslam_tpu_torch.eval.harness import evaluate_against_tum_gt, repo_path  # noqa: E402

torch.set_num_threads(2)
NF = 24
COMMON = ["--device", "cpu", "--opts", "MOTION_PROBE_THR", "-1", "PATCHES_PER_FRAME", "8",
          "BUFFER_SIZE", "64"]


def _images(d, names):
    d.mkdir(parents=True)
    rng = np.random.RandomState(2)
    for name in names:
        img = cv2.GaussianBlur((rng.rand(64, 96, 3) * 255).astype(np.uint8), (3, 3), 1.0)
        cv2.imwrite(str(d / f"{name}.png"), img)


def _tum_rows(t):
    """TUM rows (t x y z qx qy qz qw) of a slow seeded walk."""
    xyz = np.cumsum(np.random.RandomState(3).standard_normal((len(t), 3)) * 0.02, 0)
    return np.concatenate([np.asarray(t, np.float64)[:, None], xyz,
                           np.tile([0, 0, 0, 1.0], (len(t), 1))], 1)


def _euroc(root):
    gt = np.loadtxt(repo_path("datasets/euroc_groundtruth/MH_01_easy.txt"))[:NF, 0]
    _images(root / "MH_01_easy" / "mav0" / "cam0" / "data", [f"{int(t)}" for t in gt])
    return euroc, ["--eurocdir", str(root)], "MH_01_easy"


def _tum(root):
    t = 1305031102.175304 + 0.03 * np.arange(NF)
    seq = root / "rgbd_dataset_freiburg1_desk"
    _images(seq / "rgb", [f"{x:.6f}" for x in t])
    np.savetxt(seq / "groundtruth.txt", _tum_rows(t + 0.005))
    return tum, ["--tumdir", str(root)], "desk"


def _tartan(root):
    scene = root / "mono" / "ME003"
    _images(scene / "image_left", [f"{i:06d}_left" for i in range(NF)])
    np.savetxt(scene / "pose_left.txt", _tum_rows(np.arange(NF))[:, 1:], delimiter=" ")
    return tartan, ["--datapath", str(root), "--split", "test"], "data_mono_ME003"


def _kitti(root):
    seq = root / "sequences" / "04"
    _images(seq / "image_0", [f"{i:06d}" for i in range(NF)])
    (seq / "calib.txt").write_text("P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n")
    (root / "poses").mkdir()
    walk = _tum_rows(np.arange(NF))[:, 1:4]
    rows = [np.concatenate([np.eye(3), x[:, None]], 1).reshape(-1) for x in walk]
    np.savetxt(root / "poses" / "04.txt", np.asarray(rows))
    # the KITTI default (default_cdvslam++.yaml) names head checkpoints that
    # are not in the repo, which the port refuses
    return kitti, ["--kittidir", str(root), "--config", "config/default_cdvo.yaml"], "04"


def _icl(root):
    scene = root / "traj2_frei_png"
    _images(scene / "rgb", [f"{i}" for i in range(NF)])
    np.savetxt(scene / "groundtruth.txt", _tum_rows(np.arange(NF) + 0.2))
    return icl_nuim, ["--icldir", str(root)], "traj2_frei_png"


def _nuscene(root):
    scene = root / "scene-0061"
    _images(scene / "CAM_FRONT", [f"{i:06d}" for i in range(NF)])
    np.savetxt(scene / "poses.txt", _tum_rows(np.arange(NF))[:, 1:])
    return nuscene, ["--nuscdir", str(root)], "scene-0061"


@pytest.mark.parametrize("make", [_euroc, _tum, _tartan, _kitti, _icl, _nuscene],
                         ids=["euroc", "tum", "tartan", "kitti", "icl_nuim", "nuscene"])
def test_dataset_evaluation_runs_on_a_tiny_tree(tmp_path, monkeypatch, make):
    module, args, scene = make(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    summary = module.main(args + COMMON)
    assert set(summary) == {scene, "AVG", "AUC"}
    assert np.isfinite(summary[scene]) and summary[scene] >= 0
    assert list((tmp_path / "results").glob("*.txt"))
    if module in (kitti, nuscene):
        assert len(list((tmp_path / "results" / "calib").glob("*.txt"))) == 1


def test_euroc_stamps_are_associated_in_nanoseconds():
    gt_file = repo_path("datasets/euroc_groundtruth/MH_01_easy.txt")
    gt = np.loadtxt(gt_file)[:40:2]
    tstamps = gt[:, 0] / 1e9                         # the images' stamps, in seconds
    traj = np.concatenate([gt[:, 1:4] * 0.5, np.tile([0, 0, 0, 1.0], (20, 1))], 1)
    assert jax_harness.evaluate_against_tum_gt(traj, tstamps, gt_file) == float("inf")
    ate = evaluate_against_tum_gt(traj, tstamps, gt_file, t_scale=1e9, max_diff=0.08e9)
    assert ate < 1e-6                                # a scaled copy aligns exactly
