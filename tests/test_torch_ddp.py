"""Data-parallel training over two processes (gloo on the CPU), the
counterpart of tests/test_multichip.py's sharded step, through the port's
dry run (``cdvslam_tpu_torch.parallel.dryrun``): the gradient summed over
two processes, each running one clip of a batch of two, equals the
gradient of the single process that runs both, and so does the loss.
Rank 1 starts from other weights, which ``replicate`` overwrites with rank
0's. Tolerance: each leaf within 1e-5 of its max |gradient| (the two runs
add the two clips' gradients in another order), the loss within 1e-6
relative; both runs finite with no NaN flagged; the two single-process
runs are bitwise equal on the CPU, so the dry run's allowance for their
spread adds nothing."""
import torch

from cdvslam_tpu_torch.parallel import dryrun


def test_two_process_gradient_equals_single_process(tmp_path):
    assert dryrun.run(2, "cpu", tmp_path) == 0
    ok, worst, loss_use = dryrun.compare(*(tmp_path / f for f in (
        "single.pt", "single2.pt", "group.pt")))
    assert ok and worst <= 1 and loss_use <= 1, (worst, loss_use)
    a, a2 = torch.load(tmp_path / "single.pt"), torch.load(tmp_path / "single2.pt")
    assert a["loss"] == a2["loss"]
    assert all(torch.equal(g, a2["grads"][k]) for k, g in a["grads"].items())
    nonzero = sum(g.abs().max().item() > 0 for g in a["grads"].values())
    assert nonzero > 0.9 * len(a["grads"])
