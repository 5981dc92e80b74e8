"""Closed-loop camera streams through a CDVO++ SLAM: ``stream.py``'s
driver with the semantic and depth heads.

Set-up draws the two heads from a sub-seed of the weights' seed by
``ref/weights.py``'s rules (the seg head's BatchNorm at mean 0 and
variance 1, its linear layer and the depth head's uniform in
+-1/sqrt(fan_in)), then raises the seg head's bias of the dynamic ADE20K
classes by one constant, found by bisection on the reference's float32
tokens of the first rendered view, so that DYNAMIC_SHARE of them take a
dynamic class: of the two constants the bisection ends between, the one
whose share lies nearer (tokens of one uniform patch of the view tie, so
the share moves in steps). It writes both as
reference-format ``.pth`` files under the configuration's ``SEG_HEAD`` and
``DEPTH_HEAD`` names in a directory of its own under ``build/portbench``,
and the program loads them through its own checkpoint path. Everything
else is ``stream.Session``'s; each sequence's line also gives the heads'
counters (``SLAM.stats``: tokens of a dynamic class, edges down-weighted,
scale-gate openings) where the program keeps them, and the window's line
their shares. ``check()`` holds the sampled steps to ``ref/check_heads.py``,
after it has run the program's own frame insert of each sampled step
again, eagerly, on a new SLAM with the run's weights and heads (and the
run's ``slam_hook``): no state
keeps the new frame's initial patch row (the BA overwrites its depths),
which the reference's BA stage starts from.
"""
from __future__ import annotations

import gc
import importlib.util
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location("portbench_drivers_stream",
                                               Path(__file__).with_name("stream.py"))
stream = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(stream)

DYNAMIC_SHARE = 0.20
COUNTERS = ("tokens", "dynamic_tokens", "edges", "edges_downweighted", "scale_calls",
            "scale_gate_open")


def head_seeds(weights_seed):
    """Sub-seeds (63 bits) of the seg and the depth head."""
    s = np.random.SeedSequence([weights_seed, 20]).generate_state(4, dtype=np.uint32)
    s = s.astype(np.int64)
    return int(s[0] << 31 | s[1] >> 1), int(s[2] << 31 | s[3] >> 1)


def dynamic_bias(logits, filt, share=DYNAMIC_SHARE, iterations=60):
    """The constant c added to the logits of the classes ``filt`` such that
    the share of the rows of ``logits`` (L, classes) whose argmax is in
    ``filt`` lies nearest ``share``: bisection ends between a constant
    below ``share`` and one at or above it, and the nearer wins (ties: the
    upper). Returns (c, the share at c)."""
    onehot = torch.zeros(logits.shape[1], dtype=logits.dtype, device=logits.device)
    onehot[filt] = 1.0

    def at(c):
        return float((logits + c * onehot).argmax(-1)[:, None].eq(filt).any(-1).double().mean())

    lo, hi = -1.0, 1.0
    while at(lo) >= share:
        lo *= 2
    while at(hi) < share:
        hi *= 2
    for _ in range(iterations):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if at(mid) >= share else (mid, hi)
    below, above = at(lo), at(hi)
    return (lo, below) if share - below < above - share else (hi, above)


def seeded_heads(weights_seed, first_view, device):
    """(seg, depth) heads' float32 state dicts on ``device`` and the seg
    bias constant and the dynamic share it gives on ``first_view`` (H, W, 3)
    uint8: see the module docstring."""
    from portbench.ref.check import reference_model
    from portbench.ref.models.heads import DepthHeadFlatten, SegHeadFlatten
    from portbench.ref.slam.step import precision
    from portbench.ref.slam.step_heads import ADE20K_INDEX_FILT
    from portbench.ref.weights import meta_model, state_dict
    seg_seed, depth_seed = head_seeds(weights_seed)
    seg_sd = state_dict(meta_model(SegHeadFlatten), seg_seed, device)
    depth_sd = state_dict(meta_model(DepthHeadFlatten), depth_seed, device)
    head = SegHeadFlatten()
    head.load_state_dict(seg_sd)
    head = head.to(device).eval()
    filt = torch.tensor(ADE20K_INDEX_FILT, device=device)
    with torch.no_grad(), precision(False):
        model = reference_model("cdv", weights_seed, device)
        view = torch.as_tensor(np.asarray(first_view), device=device).float()
        tokens = model.features_i_taps((view / 255.0)[None])[1][0]
        del model
        c, share = dynamic_bias(head(tokens), filt)
    seg_sd["linear.bias"][filt] += c
    return seg_sd, depth_sd, c, share


class Session(stream.Session):
    """``stream.Session`` with the heads."""

    def __init__(self, env):
        super().__init__(env)
        self.head_sds = None
        self.head_dir = None
        self.heads_log = {}
        self.tallies = None

    def new_slam(self):
        if self.head_sds is None:
            self._write_heads()
        super().new_slam()

    def _write_heads(self):
        """The heads from the seed, written where the configuration names
        them (the first view is rendered by now)."""
        env = self.env
        seg, depth, c, share = seeded_heads(env.seeds["weights"], self.frames[0], env.device)
        self.head_sds = (seg, depth)
        root = Path(stream.__file__).resolve().parents[2] / "build" / "portbench"
        root.mkdir(parents=True, exist_ok=True)
        self.head_dir = Path(tempfile.mkdtemp(prefix="heads-", dir=root))
        for name, sd in (("SEG_HEAD", seg), ("DEPTH_HEAD", depth)):
            path = self.head_dir / Path(str(self.cfg[name])).name
            torch.save({k: v.cpu() for k, v in sd.items()}, path)
            self.cfg[name] = str(path)
        self.heads_log = {"seg_bias": c, "first_view_dynamic_share": share}
        env.mark("heads")

    def setup(self):
        info = super().setup()
        return {**info, **self.heads_log}

    def end_slam(self):
        stats = self.slam.stats
        out = super().end_slam()
        self.tallies = {k: stats[k] for k in COUNTERS if k in stats} or None
        return out

    def sequence(self):
        super().sequence()
        self.sequences[-1]["heads"] = self.tallies

    def context(self):
        ctx = super().context()
        got = [s["heads"] for s in self.sequences if s.get("heads")]
        if got:
            tot = {k: sum(g[k] for g in got) for k in COUNTERS}
            ctx["log"].update(
                dynamic_token_share=tot["dynamic_tokens"] / max(tot["tokens"], 1),
                edges_downweighted_share=tot["edges_downweighted"] / max(tot["edges"], 1),
                scale_gate_open_share=tot["scale_gate_open"] / max(tot["scale_calls"], 1))
        return ctx

    def program_rows(self):
        """Each sampled step's initial patch row of its new frame (M, 3, P,
        P), as the program's eager step makes it: the keyframe shift, then
        ``SLAM._insert_frame`` on a copy of the state before the step."""
        from cdvslam_tpu_torch.slam import SLAM
        from cdvslam_tpu_torch.slam.fused import FrameInputs
        from cdvslam_tpu_torch.slam.kernels import SCALARS, shift_rows
        env, M = self.env, self.cfg.PATCHES_PER_FRAME
        dev = env.device
        slam = SLAM(self.cfg, self.network, self.ht, self.wd, seed=env.seeds["slam"],
                    state_dict=self.sd, device=dev, trace=False)
        if env.hook is not None:
            env.hook(slam)
        rows = []
        with torch.no_grad():
            for s in self.tap.samples:
                st = {k: v.to(dev, copy=True) for k, v in s["pre"].items()}
                ints = torch.as_tensor(s["ints"]).to(dev)
                tail = ints[len(ints) - len(SCALARS):].long()
                if s["key"][3]:
                    shift_rows(st, tail[SCALARS.index("shift_k")], s["key"][3], M)
                slam._insert_frame(st, FrameInputs(torch.as_tensor(s["image"]).to(dev), ints,
                                                   torch.as_tensor(s["floats"]).to(dev)), True)
                n = int(tail[SCALARS.index("n")])
                rows.append(st["patches_"][n * M:(n + 1) * M].float().cpu())
                del st
        del slam
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return rows

    def check(self, control=False):
        """``stream.Session.check``'s checks, the sampled steps held to the
        CDVO++ reference (``ref/check_heads.py``)."""
        from portbench.ref.check import BAD, index_numbers
        from portbench.ref.check_heads import check
        from portbench.ref.slam.step import Settings
        cfg, tr, env = self.cfg, self.traffic, self.env
        settings = Settings(self.network, cfg.PATCHES_PER_FRAME, self.ht, self.wd,
                            cfg.CENTROID_SAMPLE_STRAT == "UPPERLEFT", cfg.POSE_WINDOW)
        samples = self.tap.samples
        rows = self.program_rows()
        shutil.rmtree(self.head_dir, ignore_errors=True)
        args = (settings, env.seeds["weights"], self.head_sds, cfg.OPTIMIZATION_WINDOW, env.device)
        worst = check(samples, *args, rows=rows) if samples else {}
        worst.update(index_numbers(samples, settings))
        ctrl = check(samples, *args, control=True) if control and samples else None
        checks = {name: {"value": worst.get(name, BAD), "limit": lim}
                  for name, lim in env.cfgspec["limits"].items()}
        for name in ("aux_rows", "slot_rows", "net_src"):
            checks[name] = {"value": worst.get(name, BAD), "limit": 0}
        checks["missing_samples"] = {"value": tr["check_samples"] - len(samples), "limit": 0}
        checks["bad_trajectories"] = {"value": sum(not s["finite"] or s["poses"] != s["frames"]
                                                   for s in self.sequences), "limit": 0}
        return checks, worst, ctrl
