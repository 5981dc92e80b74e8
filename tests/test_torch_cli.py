"""The port's entry points on the CPU: ``python -m cdvslam_tpu_torch.demo
--device cpu`` on a rendered image directory in a temporary working
directory (its trajectory, plot, PLY and COLMAP files and its ``--timeit``
summary of the tracer's spans, counters and stages), the demo and the dataset evaluations refusing to run without a
card unless told, and the trainer's in-training validation: ``train.cli``
with ``--eval_every 1`` calls ``eval.tartan.evaluate`` with the weights
under training (the call recorded), and the validation itself on a small
TartanAir-format tree. It also shows the JAX validation's glob finding no
scene in the trainer's own layout."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from cdvslam_tpu_torch.data.tartan import build_scene_info  # noqa: E402
from cdvslam_tpu_torch.eval import tartan  # noqa: E402
from cdvslam_tpu_torch.train import cli  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", **extra)
    return env


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(1)
    (d / "imgs").mkdir()
    for f in range(12):
        img = cv2.GaussianBlur((rng.rand(64, 96, 3) * 255).astype(np.uint8), (3, 3), 1.0)
        cv2.imwrite(str(d / "imgs" / f"{f:06d}.png"), img)
    (d / "calib.txt").write_text("80.0 80.0 48.0 32.0\n")
    return d


def test_demo_writes_its_files_on_the_cpu(image_dir, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "cdvslam_tpu_torch.demo", "--device", "cpu",
         "--imagedir", str(image_dir / "imgs"), "--calib", str(image_dir / "calib.txt"),
         "--stride", "1", "--name", "run", "--save_trajectory", "--plot", "--save_ply",
         "--save_colmap", "--timeit", "--opts", "MOTION_PROBE_THR", "-1",
         "PATCHES_PER_FRAME", "8", "BUFFER_SIZE", "64"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for span in ("frame", "insert", "update", "keyframe", "prepare", "launch", "after",
                 "terminate", "reader.decode", "reader.wait"):
        assert f"span {span}: " in r.stdout and " median " in r.stdout, span
    for line in ("steady frames: ", "counters: updates", "device stages (ms per steady replay",
                 "device gaps (ms per steady frame"):
        assert line in r.stdout, line
    traj = np.loadtxt(tmp_path / "saved_trajectories" / "run.txt")
    assert traj.shape == (12, 8) and np.isfinite(traj).all()
    assert (tmp_path / "trajectory_plots" / "run.pdf").read_bytes()[:4] == b"%PDF"
    ply = (tmp_path / "run.ply").read_text()
    assert ply.startswith("ply\n") and int(ply.split("element vertex ")[1].split()[0]) > 0
    colmap = tmp_path / "colmap_saving" / "run"
    assert (colmap / "cameras.txt").read_text() == "1 PINHOLE 96 64 80.0 80.0 48.0 32.0\n"
    assert len((colmap / "images.txt").read_text().split("\n\n")) > 8
    assert len((colmap / "points3D.txt").read_text().splitlines()) > 8


@pytest.mark.parametrize("module", ["cdvslam_tpu_torch.demo", "cdvslam_tpu_torch.eval.tartan"])
def test_entry_points_want_a_card_unless_told(image_dir, tmp_path, module):
    args = (["--imagedir", str(image_dir / "imgs"), "--calib", str(image_dir / "calib.txt")]
            if module.endswith("demo") else ["--datapath", str(tmp_path)])
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=tmp_path,
                       env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _tree(root, nframes, ht=64, wd=80):
    scene = root / "office" / "office" / "Easy" / "P001"
    (scene / "image_left").mkdir(parents=True)
    (scene / "depth_left").mkdir(parents=True)
    rng = np.random.RandomState(0)
    poses = []
    for i in range(nframes):
        img = cv2.GaussianBlur((rng.rand(ht, wd, 3) * 255).astype(np.uint8), (3, 3), 1.0)
        cv2.imwrite(str(scene / "image_left" / f"{i:06d}_left.png"), img)
        np.save(str(scene / "depth_left" / f"{i:06d}_left_depth.npy"),
                4.0 + rng.rand(ht, wd).astype(np.float32))
        poses.append([0.02 * i, 0.0, 0.01 * i, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(str(scene / "pose_left.txt"), np.asarray(poses), delimiter=" ")
    build_scene_info(str(root), str(root / "scene_info.pickle"))
    return root


def test_training_validates_with_the_weights_under_training(tmp_path, monkeypatch):
    root = _tree(tmp_path / "TartanAir", 70)
    calls, states = [], []
    monkeypatch.setattr(tartan, "evaluate", lambda datapath, cfg, args, trials=1,
                        split="validation", **kw: calls.append((datapath, cfg, args, kw))
                        or {"AVG": 0.5, "AUC": 0.5})
    recs = cli.main(["cdv", "--device", "cpu", "--datapath", str(root),
                     "--scene_info", str(root / "scene_info.pickle"),
                     "--eval_datapath", str(root / "office"),
                     "--outdir", str(tmp_path / "ck"), "--logdir", str(tmp_path / "runs"),
                     "--crop_size", "48", "64", "--n_frames", "4", "--iter", "2",
                     "--schedule", "sparse,sparse", "--steps", "200", "--eval_every", "1"],
                    on_step=lambda rec, state: states.append(
                        {k: v.detach().clone() for k, v in state.params.items()}))
    assert len(recs) == 2 and len(calls) == 2
    for (datapath, cfg, args, kw), params in zip(calls, states):
        assert datapath == str(root / "office") and args.device == "cpu"
        assert args.config == "config/default_cdvo.yaml" and cfg.PATCHES_PER_FRAME == 96
        weights = kw["state_dict"]
        assert params.keys() <= weights.keys()
        for k, v in params.items():
            assert torch.equal(weights[k], v), k
    # the weights moved between the two validations
    assert any(not torch.equal(calls[0][3]["state_dict"][k], calls[1][3]["state_dict"][k])
               for k in states[0])


def test_the_validation_runs_on_the_trainers_tree(tmp_path, monkeypatch):
    """``validate`` on a 12-frame tree (its config with MOTION_PROBE_THR -1
    and PATCHES_PER_FRAME 16: the random network's motion probe would keep
    no frame): the trainer's
    layout puts scenes at
    root/scene/scene/Easy/P, so the validation glob (``*/Easy/*``) finds
    them under root/scene, which ``--eval_datapath`` names; under the
    trainer's ``--datapath`` itself the JAX validation (and the port's
    glob) finds no scene."""
    import evaluate_tartan as jax_eval_tartan
    root = _tree(tmp_path / "TartanAir", 12)
    assert jax_eval_tartan.validation_scenes(str(root)) == []
    assert tartan.validation_scenes(str(root)) == []
    assert len(tartan.validation_scenes(str(root / "office"))) == 1
    monkeypatch.chdir(tmp_path)
    args = cli.parser().parse_args(["cdv", "--datapath", str(root),
                                    "--eval_datapath", str(root / "office")])
    evaluate = tartan.evaluate

    def evaluate_random_network(datapath, cfg, eargs, **kw):
        cfg.update(MOTION_PROBE_THR=-1.0, PATCHES_PER_FRAME=16)
        return evaluate(datapath, cfg, eargs, **kw)
    monkeypatch.setattr(tartan, "evaluate", evaluate_random_network)
    logged = []
    logger = type("L", (), {"write_dict": lambda self, r: logged.append(r)})()
    torch.manual_seed(0)
    from cdvslam_tpu_torch.models import CDVNet
    summary = cli.validate(args, CDVNet().eval(), torch.device("cpu"), logger)
    assert logged == [summary]
    assert set(summary) == {"office_Easy_P001", "AVG", "AUC"}
    assert np.isfinite(summary["office_Easy_P001"])
    assert (tmp_path / "results" / "tartan_.txt").exists()
    args.eval_datapath = str(tmp_path / "missing")
    assert cli.validate(args, CDVNet().eval(), torch.device("cpu"), logger) is None
    # a validation set without a scene fails before the first training step
    with pytest.raises(FileNotFoundError, match="no validation scene"):
        cli.main(["cdv", "--device", "cpu", "--datapath", str(root), "--scene_info",
                  str(root / "scene_info.pickle"), "--schedule", "sparse", "--eval_every", "1"])
