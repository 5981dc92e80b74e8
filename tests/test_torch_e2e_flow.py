"""The proof's training loop with the flow term alone, on the CPU at 48 x 64:
one clip and one fixed draw (``train(..., pool=1, rollout=..., key=7)``),
so the rollout sees the same input at every step. Its first AdamW step
lowers the flow loss and raises px1 (measured 0.895 to 0.550, px1 0.345
to 0.484): the flow term's gradient reaches the weights through the
features, corr, update and BA. On the card the same run at 240 x 320
fits the clip (px1 0.026 to 0.98 in 200 steps, PERF.md)."""
import torch

from cdvslam_tpu_torch.train import e2e_proof

torch.set_num_threads(2)


def test_flow_only_training_on_one_fixed_draw_descends(tmp_path):
    flow_only = e2e_proof.rollout_config()._replace(pose_weight=0.0)
    _, _, records = e2e_proof.train(2, "cpu", ckpt=str(tmp_path / "flow.pt"), ht=48, wd=64,
                                    pool=1, rollout=flow_only, key=7)
    first, second = records
    assert second["loss"] < first["loss"], records
    assert second["px1"] > first["px1"], records
