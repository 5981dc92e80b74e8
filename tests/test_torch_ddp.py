"""Data-parallel training over two processes (gloo on the CPU), the
counterpart of tests/test_multichip.py's sharded step: the gradient summed
over two processes, each running one clip of a batch of two, equals the
gradient of the single process that runs both, and so does the loss.
Rank 1 starts from other weights, which ``replicate`` overwrites with rank
0's. Tolerance: each leaf within 1e-5 of its max |gradient| (the two runs
add the two clips' gradients in another order), the loss within 1e-6
relative; both runs finite with no NaN flagged."""
import socket
import subprocess
import sys
from pathlib import Path

import torch

WORKER = Path(__file__).resolve().parent / "torch_ddp_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gradient_equals_single_process(tmp_path):
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2", str(port),
                               str(tmp_path / "ddp.pt")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    single = subprocess.run([sys.executable, str(WORKER), "0", "1", "0",
                             str(tmp_path / "single.pt")], capture_output=True, text=True,
                            timeout=300)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert single.returncode == 0, single.stdout + single.stderr
    assert all(p.returncode == 0 for p in procs), logs
    a, b = torch.load(tmp_path / "single.pt"), torch.load(tmp_path / "ddp.pt")
    assert not a["any_nan"] and not b["any_nan"]
    assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(a["loss"]) and a["loss"] > 0
    assert a["grads"].keys() == b["grads"].keys()
    nonzero = 0
    for k, g in a["grads"].items():
        scale = g.abs().max().item()
        assert torch.isfinite(g).all(), k
        assert (g - b["grads"][k]).abs().max().item() <= 1e-5 * max(scale, 1e-12), k
        nonzero += scale > 0
    assert nonzero > 0.9 * len(a["grads"])
