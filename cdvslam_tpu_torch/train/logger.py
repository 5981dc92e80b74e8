"""Training logger (copy of ``cdvslam_tpu.train.logger``; reference:
cdvslam/logger.py): TensorBoard writer with 100-step running means; falls
back to stdout when tensorboard is absent."""
from __future__ import annotations

from collections import defaultdict

SUM_FREQ = 100


class Logger:
    def __init__(self, name, scheduler=None, logdir="runs"):
        self.name = name
        self.scheduler = scheduler
        self.total_steps = 0
        self.running = defaultdict(float)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(f"{logdir}/{name}")
        except Exception:
            self.writer = None

    def _print(self, metrics):
        out = f"[{self.name} step {self.total_steps}] " + " ".join(
            f"{k}={v:.5f}" for k, v in metrics.items()
        )
        print(out)

    def push(self, metrics):
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] += float(v)
        if self.total_steps % SUM_FREQ == 0:
            means = {k: v / SUM_FREQ for k, v in self.running.items()}
            self._print(means)
            if self.writer is not None:
                for k, v in means.items():
                    self.writer.add_scalar(k, v, self.total_steps)
            self.running.clear()

    def write_dict(self, results):
        self._print(results)
        if self.writer is not None:
            for k, v in results.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(k, v, self.total_steps)
