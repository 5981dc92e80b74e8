"""The end-to-end proof (``python -m cdvslam_tpu_torch.train.e2e_proof``) on
the CPU at 48 x 64: two training steps of its recipe on a pool of two
rendered clips give finite losses, the checkpoint comes back bitwise as
the weights the SLAM loads, the evaluation (10 held-out frames and two
SLAM seeds here, 40 and five in the proof) returns the tool's keys with
finite ATEs and each seed's ATEs, the ATE and
path-length arithmetic equals the tool's ``run_slam`` lines (JAX
``se3_inv`` and ``ate_rmse``, in float64) to 1e-12, and the module wants
a card unless ``--device cpu``. The training step's loss is held to
JAX's in test_torch_e2e_proof_jax.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdvslam_tpu.eval import ate_rmse as jax_ate_rmse
from cdvslam_tpu.lie import se3_inv as jax_se3_inv
from cdvslam_tpu_torch.data.render import overhead_loop_poses
from cdvslam_tpu_torch.train import e2e_proof

torch.set_num_threads(2)
HT, WD = 48, 64


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("proof") / "proof.pt"
    model, _, records = e2e_proof.train(2, "cpu", ckpt=str(ckpt), ht=HT, wd=WD, pool=2)
    return model, records, ckpt


def test_two_training_steps_give_finite_losses(trained):
    _, records, _ = trained
    assert [r["step"] for r in records] == [0, 1]
    for r in records:
        assert all(np.isfinite(r[k]) for k in ("loss", "px1", "tr", "ro", "ms")), r


def test_the_checkpoint_round_trip_is_bitwise(trained):
    model, _, ckpt = trained
    weights = e2e_proof.load_weights(ckpt)
    want = model.state_dict()
    assert list(weights) == list(want)
    assert all(torch.equal(weights[k], want[k]) for k in want)
    fresh = e2e_proof.new_model("cpu").state_dict()     # training moved the weights
    assert not all(torch.equal(fresh[k], want[k]) for k in want)


def test_the_evaluation_returns_the_tools_keys(trained):
    _, _, ckpt = trained
    sink = []
    out = e2e_proof.evaluate(e2e_proof.load_weights(ckpt), "cpu", HT, WD, frames=10,
                             seeds=(0, 1), sink=sink)
    seeds = {"ate_trained_seeds", "ate_random_seeds"}
    assert set(out) == {"ate_trained", "ate_random", "path_len", "trained_pct_of_path",
                        "improvement"} | seeds
    assert all(np.isfinite(v) for k, v in out.items() if k not in seeds)
    assert out["path_len"] > 0 and len(sink) == 4
    # the tool's figures are the first seed's; every seed's ATE is finite
    assert out["ate_trained_seeds"][0] == out["ate_trained"]
    assert out["ate_random_seeds"][0] == out["ate_random"]
    assert all(len(out[k]) == 2 and np.isfinite(out[k]).all() for k in seeds)


def test_ate_and_path_equal_the_tools_arithmetic():
    gt = overhead_loop_poses(40, height=1.6, radius=0.7).astype(np.float64)
    rng = np.random.RandomState(4)
    poses = np.concatenate([rng.standard_normal((40, 3)), np.tile([0, 0, 0, 1.0], (40, 1))], 1)
    with jax.enable_x64(True):
        gt_wc = np.asarray(jax_se3_inv(jnp.asarray(gt)))
        ate = float(jax_ate_rmse(poses[:40, :3], gt_wc[:40, :3]))
    path = float(np.linalg.norm(np.diff(gt_wc[:40, :3], axis=0), axis=-1).sum())
    got = e2e_proof.ate_and_path(poses, gt)
    assert abs(got[0] - ate) <= 1e-12 * ate and abs(got[1] - path) <= 1e-12 * path, (got, ate, path)


def test_the_proof_wants_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e_proof.main(["--steps", "1"])
