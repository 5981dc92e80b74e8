"""Closed-loop camera streams through ``SLAM.__call__``.

Frames are views of a seeded plane texture from a camera circling above it
(``yardstick.render``): ``period`` distinct views, rendered once on the
device, each copied into an array of its own in host memory (as the
program's reader hands frames over) and handed to the SLAM from there, each
upload started one frame ahead with ``SLAM.prefetch`` (``prefetch`` 1). A
sequence has ``sequence_frames`` frames on a new SLAM and ends with its
``terminate()``.

Set-up runs a sequence of ``warm_frames`` frames to its end (the
initialisation, the captures of the steady-state graphs, ``terminate()``).
The window runs whole sequences back to back, each from the SLAM's
construction to its ``terminate()``, until ``--seconds`` have passed, and
closes when the sequence then running ends: ``fps`` is all their frames
over all their time, so each sequence's start and end weigh as they do in a
recorded sequence of that length.

A traced run then starts one more SLAM, runs ``warm_frames`` frames and
profiles ``profile_frames`` frames after as many untraced ones.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch


class SyncClock:
    """Seconds the host spends blocked in ``torch.cuda.Event.synchronize``
    and ``torch.cuda.Stream.synchronize`` (the program's waits for the
    device; the steady-state frame waits on an earlier frame's event),
    while installed."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._orig = []

    def install(self):
        for cls in (torch.cuda.Event, torch.cuda.Stream):
            orig = cls.synchronize

            def synchronize(obj, _orig=orig):
                a = time.perf_counter()
                try:
                    return _orig(obj)
                finally:
                    self.seconds += time.perf_counter() - a
                    self.calls += 1
            self._orig.append((cls, orig))
            cls.synchronize = synchronize

    def remove(self):
        for cls, orig in self._orig:
            cls.synchronize = orig
        self._orig = []


class StepTap:
    """Copies of the program's state before and after the steady-state
    steps ``picks`` (indices of the window's steps, from 0), with the step's
    host inputs, the frame, the mm it returned and the int block of the
    SLAM's step before it: wrapped around the SLAM's ``fused.run``. On the
    card the copies go to pinned host memory without waiting; the buffers
    are made in set-up (``reserve``)."""

    def __init__(self, picks, device):
        self.picks = set(int(p) for p in picks)
        self.device = device
        self.calls = 0
        self.armed = False
        self.samples = []
        self.spare = []

    def _buffers(self, st):
        pin = self.device.type == "cuda"
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin) for k, v in st.items()}

    def reserve(self, st):
        self.spare = [self._buffers(st) for _ in range(2 * len(self.picks))]

    def _snap(self, st):
        buf = self.spare.pop() if self.spare and len(st) > 1 else None
        if buf is None or any(buf[k].shape != v.shape for k, v in st.items()):
            buf = self._buffers(st)
        for k, v in st.items():
            buf[k].copy_(v, non_blocking=True)
        return buf

    def install(self, slam):
        orig = slam.fused.run
        prev = {}

        def run(key, frame, ints, floats):
            take = self.armed and self.calls in self.picks
            self.calls += self.armed
            before = prev.get("ints")
            prev["ints"] = ints
            if not take:
                return orig(key, frame, ints, floats)
            pre = self._snap(slam.pg.state())
            image = self._snap({"image": frame})["image"]
            out = orig(key, frame, ints, floats)
            post = self._snap(slam.pg.state())
            mm = self._snap({"mm": out[0]})["mm"]
            self.samples.append({"key": tuple(key[:4]), "image": image, "ints": ints.copy(),
                                 "floats": floats.copy(), "pre": pre, "post": post,
                                 "mm": mm, "prev_ints": None if before is None
                                 else before.copy()})
            return out

        slam.fused.run = run


class Session:
    """The SLAMs of one run of a stream cell and how frames reach them."""

    def __init__(self, env):
        self.env = env
        self.traffic = env.traffic
        spec = env.cfgspec
        self.network, self.ht, self.wd = spec["network"], spec["ht"], spec["wd"]
        self.slam = None
        self.clock = SyncClock()
        self.tap = None
        self.frame_log = []         # (end, host span s, wait s, steady, edges, cpu s) per window frame
        self.sequences = []         # one dict per sequence of the window
        self.captures = 0           # graph captures of the window's SLAMs
        self.traced = None

    # ------------------------------------------------------------------
    def setup(self):
        """Weights and frames from the seed, made on the device; a warm
        sequence of ``warm_frames`` frames run to its end."""
        from cdvslam_tpu_torch.config import get_cfg
        from portbench.ref.models import CDVNet, VONet
        from portbench.ref.weights import meta_model, state_dict

        env, tr = self.env, self.traffic
        cfg = get_cfg()
        for k, v in env.cfgspec["settings"].items():
            cfg[k] = tuple(v) if isinstance(v, list) else v
        self.cfg = cfg
        self.sd = state_dict(meta_model(VONet if self.network == "dpv" else CDVNet),
                             env.seeds["weights"], env.device)
        env.mark("weights")
        self.render()
        env.mark("render")
        rng = np.random.default_rng(env.seeds["picks"])
        self.tap = StepTap(rng.choice(np.arange(*tr["check_steps"]), tr["check_samples"],
                                      replace=False), env.device)
        self.clock.install()
        self.new_slam()
        env.mark("slam")
        for pos in range(tr["warm_frames"]):
            self.frame(pos, tr["warm_frames"])
        self.keys = [list(map(str, k)) for k in self.slam.fused.graphs]
        self.tap.reserve(self.slam.pg.state())
        env.mark("warm_frames")
        self.end_slam()
        if env.device.type == "cuda":
            torch.cuda.synchronize()
        env.mark("warm_terminate")
        return {"frames": tr["warm_frames"], "graph_keys": self.keys}

    def render(self):
        """``frames``: the ``period`` views, rendered on the device by
        ``render_batch`` and each copied into a C-contiguous array of its
        own, as a reader hands frames over; and ``intr``, the intrinsics at
        the cell's size. ``render_batch``'s array keeps its frames
        interleaved pixel by pixel (its frame stride is one pixel), so a
        view of one frame is a gather over the whole array: ``SLAM.prefetch``
        of one took 2.3-3.9 ms a call on an H100's host, against 0.3-0.45 ms
        for a frame of its own, and a copy of each on the host 2-5 s in all.
        The array goes to the device once, in its own layout, and each frame
        is gathered there and copied back into an array of its own."""
        from portbench.yardstick.render import PlaneScene, loop_path, render_batch
        tr = self.traffic
        intr = np.asarray(tr["intrinsics"], np.float64) * np.array(
            [self.wd / tr["source_wd"], self.ht / tr["source_ht"]] * 2)
        scene = PlaneScene(intr, self.ht, self.wd, tex_size=tr["tex_size"],
                           extent=tr["extent"], seed=self.env.seeds["texture"])
        views = render_batch(scene, loop_path(tr["period"], tr["period"]), self.env.device)
        self.frames = []
        for view in torch.from_numpy(views).to(self.env.device):
            frame = np.empty(view.shape, views.dtype)
            torch.from_numpy(frame).copy_(view)
            self.frames.append(frame)
        self.intr = intr.astype(np.float32)

    def new_slam(self):
        from cdvslam_tpu_torch.slam import SLAM
        self.slam = SLAM(self.cfg, self.network, self.ht, self.wd, seed=self.env.seeds["slam"],
                         state_dict=self.sd, device=self.env.device)
        if self.env.hook is not None:
            self.env.hook(self.slam)
        self.tap.install(self.slam)

    def end_slam(self):
        """``terminate()`` and the SLAM freed; returns (poses, captures)."""
        poses, _ = self.slam.terminate()
        captures = self.slam.fused.captures
        self.slam = None
        gc.collect()
        return poses, captures

    def frame(self, pos, length):
        """Hand frame ``pos`` of a sequence of ``length`` frames over;
        returns (host seconds, seconds blocked on the device, steady): a
        steady frame is one of an initialised SLAM that captured no graph."""
        slam, frames = self.slam, self.frames
        img = frames[pos % len(frames)]
        steady = slam.is_initialized
        captures = slam.fused.captures
        w = self.clock.seconds
        a = time.perf_counter()
        with torch.profiler.record_function("portbench.frame"):
            if self.traffic["prefetch"]:
                if pos == 0:
                    slam.prefetch(img)
                if pos + 1 < length:
                    slam.prefetch(frames[(pos + 1) % len(frames)])
            slam(float(pos), img, self.intr)
        span = time.perf_counter() - a
        return span, self.clock.seconds - w, steady and slam.fused.captures == captures

    # ------------------------------------------------------------------
    def sequence(self):
        """One whole sequence on a new SLAM, into ``sequences``."""
        S = self.traffic["sequence_frames"]
        a = time.perf_counter()
        self.new_slam()
        start_s = time.perf_counter() - a
        steady_s = 0.0
        for pos in range(S):
            span, wait, steady = self.frame(pos, S)
            self.frame_log.append((time.perf_counter(), span, wait, steady, self.slam.pg.E,
                                   time.process_time()))
            steady_s += span * steady
        replays = {}
        for k, g in self.slam.fused.graphs.items():
            replays[str(k[0])] = replays.get(str(k[0]), 0) + g.replays
        b = time.perf_counter()
        poses, captures = self.end_slam()
        end = time.perf_counter()
        self.captures += captures
        self.sequences.append({"frames": S, "seconds": end - a, "start_s": start_s,
                               "terminate_s": end - b, "steady_s": steady_s,
                               "captures": captures, "replays_by_edge_pad": replays,
                               "poses": len(poses),
                               "finite": bool(np.isfinite(poses).all())})

    def window(self, seconds):
        """Whole sequences until ``seconds`` have passed, closing at the end
        of the one then running."""
        self.tap.armed = True
        t0, unix0 = time.perf_counter(), time.time()
        while True:
            self.sequence()
            if time.perf_counter() - t0 >= seconds:
                break
        if self.env.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        self.tap.armed = False
        frames = sum(s["frames"] for s in self.sequences)
        self.window_s, self.n_frames = window_s, frames
        bad = sum(s["frames"] for s in self.sequences
                  if not s["finite"] or s["poses"] != s["frames"])
        return {"attempted": frames, "failed": bad, "values": {"fps": frames / window_s},
                "log": {"seconds": window_s, "opened_unix": unix0, "frames": frames,
                        "captures": self.captures,
                        "sequences": self.sequences, "per_5s": self._chunks(t0),
                        "sync_calls": self.clock.calls}}

    def _chunks(self, t0, width=5.0):
        """Per ``width`` seconds of the window: frames, the host's and the
        waits' seconds in them (whether host or device held the pace), the
        mean number of edges and the process's CPU seconds."""
        out, cpu0 = {}, self.frame_log[0][5] if self.frame_log else 0.0
        for t, span, wait, _, edges, cpu in self.frame_log:
            c = out.setdefault(int((t - t0) // width), [0, 0.0, 0.0, 0, cpu0, cpu])
            c[0] += 1
            c[1] += span - wait
            c[2] += wait
            c[3] += edges
            c[5] = cpu
            cpu0 = cpu
        return [[n, round(h, 4), round(w, 4), round(e / n), round(c1 - c0, 4)]
                for _, (n, h, w, e, c0, c1) in sorted(out.items())]

    def trace(self):
        """A new SLAM, ``warm_frames`` frames, then ``profile_frames``
        untraced and as many traced; returns the profile's summary."""
        from portbench.yardstick.profile import traced_span
        tr = self.traffic
        S = tr["sequence_frames"]
        self.new_slam()
        pos = 0
        for pos in range(tr["warm_frames"]):
            self.frame(pos, S)
        state = {"pos": pos + 1}

        def advance(n):
            for _ in range(n):
                self.frame(state["pos"], S)
                state["pos"] += 1
        summary = traced_span(advance, tr["profile_frames"], self.env.device.type == "cuda")
        self.traced = self.slam
        return summary

    # ------------------------------------------------------------------
    def context(self):
        """What the per-layer readers and the window's line read."""
        slam = self.traced
        settings = self.env.cfgspec["settings"]
        heads = {"score": settings.get("CENTROID_SEL_STRAT") == "SCORE",
                 "seg": bool(settings.get("SEG_HEAD")), "depth": settings.get("DEPTH_HEAD")}
        ctx = {"cell": {"network": self.network, "ht": self.ht, "wd": self.wd,
                        "M": self.cfg.PATCHES_PER_FRAME,
                        "C": slam.DIMF if slam is not None else None, "heads": heads},
               "frames": self.n_frames, "window_s": self.window_s,
               "frame_log": [f[1:4] for f in self.frame_log],
               "sequences": self.sequences, "captures": self.captures, "last_update": None}
        if slam is not None:
            pg = slam.pg
            ctx["last_update"] = {
                "ii": pg.ii.copy(), "jj": pg.jj.copy(), "kk": pg.kk.copy(),
                "poses": pg.poses_.detach().float().cpu(),
                "patches": pg.patches_[: pg.m].detach().float().cpu(),
                "intrinsics": pg.intrinsics_.detach().float().cpu(),
                "gmap_shape": tuple(pg.gmap_.shape), "fmap1_shape": tuple(pg.fmap1_.shape),
                "fmap2_shape": tuple(pg.fmap2_.shape), "dtype": pg.gmap_.dtype}
        steady = [f for f in self.frame_log if f[3]]
        ctx["log"] = {"steady_frames": len(steady)}
        if steady:
            ctx["log"].update(
                host_ms_median=1e3 * statistics.median(f[1] - f[2] for f in steady),
                wait_ms_mean=1e3 * sum(f[2] for f in steady) / len(steady))
        return ctx

    def release(self):
        """The program's state goes before the reference runs."""
        self.clock.remove()
        self.slam = self.traced = None
        gc.collect()

    def check(self, control=False):
        """(checks, readings, control readings or None): the sampled steps
        against the reference, the steps' index rows against the
        reference's own, and every ended sequence's trajectory."""
        from portbench.ref.check import check, index_numbers
        from portbench.ref.slam.step import Settings
        cfg, tr, env = self.cfg, self.traffic, self.env
        M = cfg.PATCHES_PER_FRAME
        settings = Settings(self.network, M, self.ht, self.wd,
                            cfg.CENTROID_SAMPLE_STRAT == "UPPERLEFT", cfg.POSE_WINDOW)
        samples = self.tap.samples
        args = (self.network, settings, env.seeds["weights"], env.device)
        worst = check(samples, *args) if samples else {}
        worst.update(index_numbers(samples, settings))
        ctrl = check(samples, *args, control=True) if control and samples else None
        BAD = 1e30
        checks = {name: {"value": worst.get(name, BAD), "limit": lim}
                  for name, lim in env.cfgspec["limits"].items()}
        for name in ("aux_rows", "slot_rows", "net_src"):
            checks[name] = {"value": worst.get(name, BAD), "limit": 0}
        checks["missing_samples"] = {"value": tr["check_samples"] - len(samples), "limit": 0}
        checks["bad_trajectories"] = {"value": sum(not s["finite"] or s["poses"] != s["frames"]
                                                   for s in self.sequences), "limit": 0}
        return checks, worst, ctrl
