"""The port's data pipeline (a copy of the JAX package's numpy + cv2
reader) against the JAX package's on tests/test_data.py's synthetic
TartanAir-format scene tree: the same scene info and frame graph, and the
same clips and batches for the same seed, value for value. The copy must
import nothing of the JAX package, not even inside a function."""
import pickle
import re
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cdvslam_tpu.data import formats as jax_formats  # noqa: E402
from cdvslam_tpu.data.tartan import TartanAirDataset as JaxDataset  # noqa: E402
from cdvslam_tpu.data.tartan import build_scene_info as jax_build  # noqa: E402
from cdvslam_tpu_torch.data import formats  # noqa: E402
from cdvslam_tpu_torch.data.tartan import TartanAirDataset, build_scene_info  # noqa: E402

NFRAMES = 70


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tartan")
    scene = root / "office" / "office" / "Easy" / "P001"
    (scene / "image_left").mkdir(parents=True)
    (scene / "depth_left").mkdir(parents=True)
    rng = np.random.RandomState(0)
    poses = []
    for i in range(NFRAMES):
        cv2.imwrite(str(scene / "image_left" / f"{i:06d}_left.png"),
                    (rng.rand(64, 80, 3) * 255).astype(np.uint8))
        np.save(str(scene / "depth_left" / f"{i:06d}_left_depth.npy"),
                4.0 + rng.rand(64, 80).astype(np.float32))
        poses.append([0.02 * i, 0.0, 0.01 * i, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(str(scene / "pose_left.txt"), np.asarray(poses), delimiter=" ")
    port = build_scene_info(str(root), str(root / "port.pickle"))
    ref = jax_build(str(root), str(root / "jax.pickle"))
    return root, port, ref


def test_scene_info_matches_jax(tree):
    _, port, ref = tree
    assert list(port) == list(ref) and len(port) == 1
    for scene in port:
        a, b = port[scene], ref[scene]
        assert a["images"] == b["images"] and a["depths"] == b["depths"]
        np.testing.assert_array_equal(a["poses"], b["poses"])
        assert len(a["graph"]) == len(b["graph"]) == NFRAMES
        for i in a["graph"]:
            np.testing.assert_array_equal(a["graph"][i][0], b["graph"][i][0])
            np.testing.assert_array_equal(a["graph"][i][1], b["graph"][i][1])


@pytest.mark.parametrize("seed,aug", [(3, True), (4, False)])
def test_clips_and_batches_match_jax(tree, seed, aug):
    root = tree[0]
    kw = dict(n_frames=5, crop_size=(48, 64), fmin=0.001, fmax=75.0, aug=aug, seed=seed)
    port = TartanAirDataset(str(root), scene_info_path=str(root / "port.pickle"), **kw)
    ref = JaxDataset(str(root), scene_info_path=str(root / "jax.pickle"), **kw)
    assert len(port) == len(ref) > 0
    for a, b in zip(port[2], ref[2]):
        np.testing.assert_array_equal(a, b)
    for pb, rb in zip(port.batches(2, 3), ref.batches(2, 3)):
        assert pb.keys() == rb.keys()
        for k in pb:
            np.testing.assert_array_equal(pb[k], rb[k])
        hw = (48, 64) if aug else (64, 80)    # without augmentation, no crop
        assert pb["images"].shape == (2, 5, *hw, 3)
        assert pb["disps"].shape == (2, 5, hw[0] // 4, hw[1] // 4)


def test_format_readers_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    flow = rng.randn(12, 17, 2).astype(np.float32)
    formats.write_flow(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(formats.read_flow(str(tmp_path / "a.flo")),
                                  jax_formats.read_flow(str(tmp_path / "a.flo")))
    data = rng.rand(9, 7).astype(np.float32)
    with open(tmp_path / "d.pfm", "wb") as f:
        f.write(b"Pf\n7 9\n-1.0\n")
        np.flipud(data).astype("<f").tofile(f)
    np.testing.assert_array_equal(formats.read_pfm(str(tmp_path / "d.pfm")), data)


def test_pickles_hold_the_same_scene_info(tree):
    root = tree[0]
    with open(root / "port.pickle", "rb") as f:
        (port,) = pickle.load(f)
    assert list(port) == list(tree[2])


def test_data_modules_import_nothing_of_the_jax_package():
    pkg = Path(__file__).resolve().parents[1] / "cdvslam_tpu_torch" / "data"
    bad = re.compile(r"^\s*(from|import)\s+(jax|flax|cdvslam_tpu\b|\.\.)", re.M)
    for path in pkg.glob("*.py"):
        assert not bad.search(path.read_text()), path


def test_training_cli_runs_on_the_cpu(tree, tmp_path):
    """The training entry point on the synthetic tree: two sparse CDV steps
    and one DPVO step at 48 x 64, a checkpoint after the second CDV step.
    The in-training validation after it is skipped (``--eval_datapath``
    not a directory); ``test_torch_cli.py`` runs it."""
    import torch
    from cdvslam_tpu_torch.train import cli
    from cdvslam_tpu_torch.train.checkpoint import load_checkpoint
    from cdvslam_tpu_torch.train.trainer import init_train_state, make_optimizer
    root = tree[0]
    common = ["--device", "cpu", "--datapath", str(root), "--scene_info",
              str(root / "port.pickle"), "--n_frames", "4", "--iter", "2", "--crop_size",
              "48", "64", "--outdir", str(tmp_path), "--logdir", str(tmp_path / "runs"),
              "--eval_every", "2", "--eval_datapath", str(tmp_path / "no_validation")]
    recs = cli.main(["cdv", "--schedule", "sparse,sparse", "--steps", "200", *common])
    assert [r["mode"] for r in recs] == ["sparse", "sparse"]
    assert all(np.isfinite(r["loss"]) and r["nan_skip"] == 0.0 for r in recs)
    from cdvslam_tpu_torch.models import CDVNet
    opt, _ = make_optimizer()
    state = load_checkpoint(tmp_path / "cdv_000002.pt", init_train_state(CDVNet(), opt))
    assert state.step == 2 and state.opt_state.count == 2
    recs = cli.main(["dpv", "--schedule", "sparse", "--steps", "200", *common])
    assert len(recs) == 1 and np.isfinite(recs[0]["loss"]) and recs[0]["nan_skip"] == 0.0
    with pytest.raises(ValueError, match="schedule"):
        cli.main(["dpv", "--schedule", "dense", *common])
    assert torch.isfinite(state.params["patchify.dino.pos_embed"]).all()
