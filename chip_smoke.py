#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cdvslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # the smoke: every phase below
    python3 chip_smoke.py --profile DIR      # phase 0, then a profile only

Phases, each printing one JSON line; any failure exits non-zero:
  0  the card (nvidia-smi), torch and CUDA versions; builds both kernels
     with nvcc for sm_90a and prints the build time
  1  corr kernel (K1, both pyramid levels in one launch) against its plain
     version at the main-path shapes (E = 9600; level 2 at coords / 4) on
     the phase-1 draw, centers past every border, near-rigid patches and
     scattered patches (the global-memory branch), and at E = 0 and 777:
     f32 inputs within 1e-4 absolute; bf16 inputs within 5e-3 relative
     (max error over max |plain|) of the plain version evaluated in f32 on
     the same bf16 values, as the JAX kernel was held to its f32 oracle
  2  DINO flash-attention kernel (K2) against its plain version through the
     packed-qkv interface, bf16, 6 heads of 64, L in {1, 64, 65, 301, 1891}:
     max abs error <= 2e-2, relative Frobenius <= 1e-2
  3  bundle adjustment run twice at E = 9600, K = 2688: bitwise equal
  4  the main path: SLAM(get_cfg(), "cdv", 480, 752) with seeded random
     weights and 8 seeded random frames cycled, 60 warm-up frames, one
     100-frame timed window, terminate(); poses finite, corr launched
     once per update and flash attention 12 times per frame; the corr
     inputs of the last warm-up frame's update are captured
  5  K1 on those captured inputs: parity (bf16 rule above) and times
  6  the proximity loop-closure path: get_cfg() merged with
     config/default_cdvslam.yaml, CLASSIC_LOOP_CLOSURE=False,
     MOTION_PROBE_THR=-1 and KEYFRAME_THRESH=0 (a cut: with random weights
     every frame would otherwise be removed and n would never reach the 36
     keyframes loop edges need), the same weights and frames as phase 4,
     LC_FRAMES frames and terminate(); loop edges and global BAs fire,
     poses finite, one update and one corr launch per frame, 12 flash
     attention launches per frame; one global BA's inputs are captured and
     solved twice (bitwise equal), and the corr inputs of one update that
     holds loop edges are captured, checked (bf16 rule) and timed
  7  the CDVO++ path: get_cfg() merged with config/default_cdvo++.yaml
     (SCORE selection, linear seg and depth heads, FILTER_DYNAMIC_CLASS)
     with SEG_HEAD="random", DEPTH_HEAD="random" and MOTION_PROBE_THR=-1,
     the weights and frames of phase 4, 60 warm-up frames, one 100-frame
     timed window, terminate(); poses finite, corr launched once per update
     and flash attention 12 times per frame, the share of tokens of a
     dynamic class in (0, 1), a share of edges down-weighted to 1e-4 above
     0, no zero score among the selected patches, the scale adjustment's
     openings counted, scale_adjustment on a crafted pose pair on the card
     against the CPU; then 40 frames with DEPTH_HEAD="dpt_random": depths
     and poses finite, ms per frame insert (synchronize on each side)

Then a kernels line (a list of per-kernel records: launches on the main
path, max error, kernel / plain / library times and the roofline bound;
K1's record adds the phase-5 times as ms_main_path and friends and the
phase-6 times as ms_loop_update and friends; both records add
launches_loop_path and launches_cdvo_pp_path),
the nvidia-smi line, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

``--profile DIR`` runs phase 0 and then, instead of the smoke, 20
steady-state frames of the main path timed and 20 more under
torch.profiler: device busy time and idle share (busy over the untraced
wall time), launches per frame, the port's two kernels and the top
kernels by device time; then the same for the loop-closure path of
phase 6 after 100 warm-up frames and for the CDVO++ path of phase 7 after
60 (with the heads' device time and launches per frame). The full tables
go to DIR/profile_{main,loop,cdvo_pp}_path.txt. It prints neither the
kernels line nor the ok line.
It never imports JAX or the JAX package. Needs one CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS = 989e12           # dense bf16 tensor cores
F32_FLOPS = 67e12             # float32 outside the tensor cores

# main-path shapes at 480 x 752 (BUFFER ring of 36 frames, 96 patches)
K_CORR, C, NF, E = 36 * 96, 24, 36, 9600
LC_FRAMES = 120     # frames of the loop-closure path (phase 6)
LEVELS = {"level1": (120, 188), "level2": (30, 47)}
ATTN_SHAPE = (1, 6, 1891, 64)
HEAD_RANGES = ("seg_head", "depth_head")   # profiler ranges around the heads


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time(fn, reps, warmup=2):
    """Mean ms per call of fn() over reps calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase0():
    import torch
    from cdvslam_tpu_torch.ops import native
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    builds = native.build()
    wall = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in b["log"].splitlines()
                  if "registers" in ln or "spill" in ln or "(C75" in ln]
            for name, b in builds.items()}
    emit({"phase": 0, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_wall_s": round(wall, 3),
          "build_s": {k: round(v["seconds"], 3) for k, v in builds.items()},
          "ptxas": regs})
    return smi


def _corr_inputs(gen, dtype, E=E, layout="random"):
    """Inputs at the main-path shapes. layout: "random" (the phase-1 draw:
    pixels jittered +-1.5 px around random centers, 5% of the centers left
    of the image), "border" (centers past every border), "rigid" (3x3
    patches of 1 px spacing plus +-0.2 px jitter) or "scattered" (+-20 px
    jitter: the union box does not fit, the kernel reads global memory)."""
    import torch
    dev = "cuda"
    (H, W), (H2, W2) = LEVELS["level1"], LEVELS["level2"]
    gmap = torch.randn((K_CORR, C, 3, 3), generator=gen, device=dev).to(dtype)
    fmap1 = torch.randn((NF, H, W, C), generator=gen, device=dev).to(dtype)
    fmap2 = torch.randn((NF, H2, W2, C), generator=gen, device=dev).to(dtype)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    if layout == "random":
        inside = u(E) > 0.05
        cx = torch.where(inside, u(E) * W, -10 - 20 * u(E))
        cy = u(E) * H
    else:   # 12 px past every border
        cx, cy = u(E) * (W + 24) - 12, u(E) * (H + 24) - 12
    jit = {"random": 1.5, "border": 1.5, "rigid": 0.2, "scattered": 20.0}[layout]
    noise = (u(E, 2, 3, 3) * 2 - 1) * jit
    if layout == "rigid":
        d = torch.arange(3, device=dev, dtype=torch.float32) - 1
        noise = noise + torch.stack([d[None, :].expand(3, 3), d[:, None].expand(3, 3)])
    coords = torch.stack([cx[:, None, None].expand(E, 3, 3),
                          cy[:, None, None].expand(E, 3, 3)], 1) + noise
    ii = torch.randint(0, K_CORR, (E,), generator=gen, device=dev, dtype=torch.int32)
    jj = torch.randint(0, NF, (E,), generator=gen, device=dev, dtype=torch.int32)
    return gmap, fmap1, fmap2, coords.contiguous(), ii, jj


def _levels(coords):
    """The coordinates at pyramid levels 1 and 2."""
    return coords, coords / 4.0


def _box_share(coords):
    """Share of (edge, level) pairs whose 9 windows fit the kernel's 12 x 12
    staged box (the rest read global memory): the kernel's own rule."""
    import torch
    fits = []
    for c in _levels(coords):
        f = torch.floor(c).clamp(-2 ** 20, 2 ** 20).flatten(2)           # (E, 2, 9)
        fits.append(((f.amax(-1) - f.amin(-1)) <= 4).all(-1))
    return torch.cat(fits).float().mean().item() if coords.shape[0] else 1.0


def _corr_bytes(gmap, fmap1, fmap2, coords, ii, jj):
    """Bytes the call must move: output, coords, indices, and each gmap row
    and each fmap tap row of either level it touches, once."""
    import torch
    es = gmap.element_size()
    E_ = coords.shape[0]
    taps = 0
    for c, fmap in zip(_levels(coords), (fmap1, fmap2)):
        _, H, W, Cc = fmap.shape
        x0 = torch.floor(c[:, 0]).long()[..., None, None]             # (E,3,3,1,1)
        y0 = torch.floor(c[:, 1]).long()[..., None, None]
        d = torch.arange(8, device=c.device) - 3
        ys = (y0 + d[:, None]).expand(-1, -1, -1, 8, 8)
        xs = (x0 + d[None, :]).expand(-1, -1, -1, 8, 8)
        inb = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        f = jj.long()[:, None, None, None, None].expand_as(ys)
        taps += torch.unique(((f * H + ys) * W + xs)[inb]).numel() * Cc * es
    rows = torch.unique(ii).numel()
    return (E_ * 49 * 9 * 2 * es + coords.numel() * 4 + 2 * E_ * 4
            + rows * gmap.shape[1] * 9 * es + taps)


def _corr_check(args):
    """Max abs error and its share of max |plain| against the plain version
    evaluated in f32 on the same values."""
    import torch
    from cdvslam_tpu_torch.ops import corr_cuda
    from cdvslam_tpu_torch.ops.corr import corr_pyramid_plain
    g, f1, f2, c, ii, jj = args
    got = corr_cuda.corr_pyramid_cl(*args).float()
    want = corr_pyramid_plain(g.float(), f1.float(), f2.float(), c, ii, jj)
    torch.cuda.synchronize()
    if c.shape[0] == 0:
        return 0.0, 0.0, tuple(got.shape)
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30), tuple(got.shape)


def _corr_record(args):
    """Kernel time (median of 5 rounds of 20 calls), plain time, roofline
    bound and box share on args (bf16)."""
    from cdvslam_tpu_torch.ops import corr_cuda
    from cdvslam_tpu_torch.ops.corr import corr_pyramid_plain
    nbytes = _corr_bytes(*args)
    flops = args[3].shape[0] * 9 * 64 * C * 2 * 2
    rounds = [cuda_time(lambda: corr_cuda.corr_pyramid_cl(*args), 20) for _ in range(5)]
    return {"ms": statistics.median(rounds), "rounds_ms": rounds,
            "plain_ms": cuda_time(lambda: corr_pyramid_plain(*args), 3),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
            "bytes": nbytes, "box_share": _box_share(args[3])}


def phase1():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"phase": 1, "checks": {}}
    worst, ok = 0.0, True
    cases = [("random", E), ("border", E), ("rigid", E), ("scattered", E),
             ("random", 0), ("random", 777)]
    rec = None
    for layout, n in cases:
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = _corr_inputs(gen, dtype, n, layout)
            err, rel, shape = _corr_check(args)
            good = shape == (n, 7, 7, 3, 3, 2) and (err <= 1e-4 if name == "f32" else rel <= 5e-3)
            out["checks"][f"{layout}_E{n}_{name}"] = {
                "max_abs": err, "rel": rel, "box_share": _box_share(args[3]), "ok": good}
            ok = ok and good
            if name == "bf16":
                worst = max(worst, err)
            if layout == "random" and n == E and name == "bf16":
                rec = _corr_record(args)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("phase 1: corr disagrees with plain")
    rec["max_abs_err"] = worst
    return rec


def phase2():
    import torch
    import torch.nn.functional as F
    from cdvslam_tpu_torch.ops import flash_attn
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, h, L, d = ATTN_SHAPE
    out = {"phase": 2, "checks": {}}
    worst, ok = 0.0, True
    for n in (1, 64, 65, 301, L):
        qkv = torch.randn((B, n, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attn.flash_attention_qkv(qkv, h).float()
        want = flash_attn.attention_qkv_plain(qkv, h).float()
        torch.cuda.synchronize()
        max_abs = (got - want).abs().max().item()
        rel_fro = ((got - want).norm() / want.norm()).item()
        good = got.shape == (B, n, h * d) and max_abs <= 2e-2 and rel_fro <= 1e-2
        out["checks"][f"L{n}"] = {"max_abs": max_abs, "rel_fro": rel_fro, "ok": good}
        ok, worst = ok and good, max(worst, max_abs)
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("phase 2: flash attention disagrees with plain")
    # qkv of the main path's shape; SDPA reads the same packed tensor
    q, k, v = qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    flops = 4 * L * L * d * h * B
    nbytes = 4 * B * h * L * d * 2
    # kernel and SDPA in alternation, five rounds of 20 calls: medians
    rounds = {"ms": [], "library_ms": []}
    for _ in range(5):
        rounds["ms"].append(cuda_time(lambda: flash_attn.flash_attention_qkv(qkv, h), 20))
        rounds["library_ms"].append(
            cuda_time(lambda: F.scaled_dot_product_attention(q, k, v), 20))
    return {
        "max_abs_err": worst,
        "ms": statistics.median(rounds["ms"]),
        "plain_ms": cuda_time(lambda: flash_attn.attention_qkv_plain(qkv, h), 20),
        "library_ms": statistics.median(rounds["library_ms"]),
        "rounds": rounds,
        "bound": (flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3),
    }


def _ba_window(gen, NFw=28, M=96):
    import torch
    from cdvslam_tpu_torch.geom import transform
    from cdvslam_tpu_torch.lie import SE3, se3_exp
    dev = "cuda"
    K = NFw * M
    xi = 0.05 * torch.randn((NFw, 6), generator=gen, device=dev)
    xi[:, :3] += torch.arange(NFw, device=dev)[:, None] * torch.tensor([0.05, 0, 0], device=dev)
    poses = se3_exp(xi)
    patches = torch.zeros((K, 3, 3, 3), device=dev)
    patches[:, 0] = (torch.rand((K,), generator=gen, device=dev) * 180)[:, None, None]
    patches[:, 1] = (torch.rand((K,), generator=gen, device=dev) * 110)[:, None, None]
    patches[:, 2] = (0.5 + torch.rand((K,), generator=gen, device=dev))[:, None, None]
    intr = torch.tensor([115.0, 115.0, 94.0, 60.0], device=dev)
    kk = torch.randint(0, K, (E,), generator=gen, device=dev)
    ii = kk // M
    jj = (ii + torch.randint(-6, 7, (E,), generator=gen, device=dev)).clamp(0, NFw - 1)
    coords = transform(SE3(poses[None]), patches[None], intr.expand(1, NFw, 4), ii, jj, kk)
    target = coords[0, :, 1, 1] + torch.randn((E, 2), generator=gen, device=dev)
    weight = torch.rand((E, 2), generator=gen, device=dev)
    pert = se3_exp(0.01 * torch.randn((NFw, 6), generator=gen, device=dev))
    from cdvslam_tpu_torch.lie import se3_mul
    return se3_mul(pert, poses), patches, intr, target, weight, ii, jj, kk, K


def phase3():
    import torch
    from cdvslam_tpu_torch.ba import ba_solve
    gen = torch.Generator(device="cuda").manual_seed(3)
    poses, patches, intr, target, weight, ii, jj, kk, K = _ba_window(gen)
    runs = [ba_solve(poses, patches, intr, target, weight, ii, jj, kk, None, 12,
                     N=16, K=K, iterations=2) for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    moved = (runs[0][0] - poses).abs().max().item()
    finite = bool(torch.isfinite(runs[0][0]).all() and torch.isfinite(runs[0][1]).all())
    emit({"phase": 3, "E": E, "K": K, "bitwise_equal": same, "pose_step": moved,
          "finite": finite, "ok": same and finite and moved > 0})
    if not (same and finite and moved > 0):
        raise SystemExit("phase 3: BA is not bitwise repeatable (or did not move)")


def phase4(smi):
    """The main path; returns the launch counts and the corr kernel's inputs
    captured from the last warm-up frame's update."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.config import get_cfg
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import kernels as slam_kernels
    ht, wd, WARM, WIN = 480, 752, 60, 100
    cfg = get_cfg()
    cfg.MOTION_PROBE_THR = -1.0
    frames, intr = _frames(ht, wd)
    kernel = slam_kernels.corr_pyramid_cl
    captured = []

    def capture(*args):
        captured.append(tuple(a.clone() for a in args[:6]))   # the tensors
        return kernel(*args)

    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    slam = SLAM(cfg, network="cdv", ht=ht, wd=wd, seed=0)
    t_start = time.perf_counter()
    for f in range(WARM):
        if f == WARM - 1:
            slam_kernels.corr_pyramid_cl = capture
        try:
            slam(f, frames[f % 8], intr)
        finally:
            slam_kernels.corr_pyramid_cl = kernel
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    upd0, corr0, attn0 = slam.stats["updates"], corr_cuda.LAUNCHES.count, flash_attn.LAUNCHES.count
    t0 = time.perf_counter()
    for f in range(WARM, WARM + WIN):
        slam(f, frames[f % 8], intr)
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    win_updates = slam.stats["updates"] - upd0
    win_corr = corr_cuda.LAUNCHES.count - corr0
    win_attn = flash_attn.LAUNCHES.count - attn0
    edges = slam.pg.E
    poses, tstamps = slam.terminate()
    torch.cuda.synchronize()
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    frames_run = WARM + WIN
    checks = {
        "poses_shape": list(poses.shape) == [frames_run, 7],
        "poses_finite": bool(np.isfinite(poses).all()),
        "corr_1_per_update": counts["corr"] == slam.stats["updates"] and win_corr == win_updates,
        "attn_12_per_frame": counts["dino_flash_attn"] == 12 * frames_run and win_attn == 12 * WIN,
        "one_update_per_frame": win_updates == WIN,
        "corr_inputs_captured": len(captured) == 1,
        "no_inactive_store": slam.pg.tw is None and len(slam.pg.ii_inac) == 0,
    }
    ok = all(checks.values())
    emit({"phase": 4, "fps": WIN / win_s, "window_s": win_s, "warmup_s": warm_s,
          "frames": frames_run, "updates": slam.stats["updates"],
          "keyframe_removals": slam.stats["keyframe_removals"], "edges": edges,
          "launches": counts, "checks": checks, "card": smi,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 4: main path checks failed: {checks}")
    return counts, captured[0]


def corr_on_captured(phase, args):
    """K1 on one update's own inputs, captured from a path's run: phase 5
    (a steady main-path update) and phase "6-corr" (an update with loop
    edges)."""
    err, rel, _ = _corr_check(args)
    rec = _corr_record(args)
    ok = rel <= 5e-3
    emit({"phase": phase, "E": args[3].shape[0], "max_abs": err, "rel": rel,
          "box_share": rec["box_share"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
          "bound_ms": rec["bound_ms"], "ok": ok})
    if not ok:
        raise SystemExit(f"phase {phase}: corr disagrees with plain on the captured inputs")
    return rec


def _loop_cfg():
    """get_cfg() merged with config/default_cdvslam.yaml (its "KEY: value"
    lines; no yaml module needed), proximity backend only, no motion probe,
    KEYFRAME_THRESH=0."""
    from cdvslam_tpu_torch.config import get_cfg
    preset = (ROOT / "config" / "default_cdvslam.yaml").read_text().splitlines()
    cfg = get_cfg().merge_from_list(
        [t.strip() for ln in preset if ":" in ln for t in ln.split(":", 1)])
    cfg.CLASSIC_LOOP_CLOSURE = False
    cfg.MOTION_PROBE_THR = -1.0
    cfg.KEYFRAME_THRESH = 0.0
    return cfg


def _frames(ht=480, wd=752):
    """The 8 seeded random frames every path cycles, and the intrinsics."""
    import numpy as np
    rng = np.random.RandomState(0)
    return ([(rng.rand(ht, wd, 3) * 255).astype(np.uint8) for _ in range(8)],
            np.array([458.654, 457.296, 367.215, 248.375], np.float32))


def phase6(smi):
    """The proximity loop-closure path at 480 x 752; returns the launch
    counts of its run and the corr inputs of one update with loop edges."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import kernels as slam_kernels
    from cdvslam_tpu_torch.slam import runtime
    cfg = _loop_cfg()
    frames, intr = _frames()
    slam = SLAM(cfg, network="cdv", ht=480, wd=752, seed=0)

    kernel, solve, run_gba = slam_kernels.corr_pyramid_cl, runtime.global_ba_solve, slam._run_global_ba
    build, loop = runtime.build_global_indices, runtime.edges_loop
    captured, gba_ms, index_ms, detections = {}, [], [], []

    def capture_corr(*args):
        pg = slam.pg
        if "corr" not in captured and (pg.ii < pg.n - cfg.REMOVAL_WINDOW - 1).any():
            captured["corr"] = tuple(a.clone() for a in args[:6])
        return kernel(*args)

    def capture_solve(*args, **kwargs):       # keeps the run's last global BA
        captured["gba"] = ([a.clone() if torch.is_tensor(a) else a for a in args],
                           dict(kwargs))
        return solve(*args, **kwargs)

    def timed_gba():
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_gba()
        torch.cuda.synchronize()
        gba_ms.append((time.perf_counter() - t) * 1e3)

    def timed_build(*args):                    # host only: no sync needed
        t = time.perf_counter()
        out = build(*args)
        index_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def counted_loop(*args):
        kk, jj = loop(*args)
        if len(kk):
            detections.append(len(kk))
        return kk, jj

    slam_kernels.corr_pyramid_cl, runtime.global_ba_solve = capture_corr, capture_solve
    runtime.build_global_indices, runtime.edges_loop = timed_build, counted_loop
    slam._run_global_ba = timed_gba
    torch.cuda.reset_peak_memory_stats()
    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    frame_ms, with_gba, peak_E = [], [], 0
    try:
        for f in range(LC_FRAMES):
            g0 = slam.stats["global_ba"]
            t = time.perf_counter()
            slam(f, frames[f % 8], intr)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            with_gba.append(slam.stats["global_ba"] > g0)
            peak_E = max(peak_E, slam.pg.E)
        runtime.global_ba_solve, runtime.edges_loop = solve, loop   # the run's only
        run_updates, run_gbas = slam.stats["updates"], slam.stats["global_ba"]
        poses, _ = slam.terminate()
        torch.cuda.synchronize()
    finally:
        slam_kernels.corr_pyramid_cl, runtime.global_ba_solve = kernel, solve
        runtime.build_global_indices, runtime.edges_loop = build, loop
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}

    # the captured global BA, solved twice
    same, gba_solve_ms = False, None
    if "gba" in captured:
        args, kwargs = captured["gba"]
        runs = [solve(*args, **kwargs) for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        gba_solve_ms = cuda_time(lambda: solve(*args, **kwargs), 5, warmup=1)
        gba_shape = {"E": int(args[5].ii.shape[0]), "G": int(args[5].g_i.shape[0]),
                     "C": int(args[5].combo_g1.shape[0]), "N": kwargs["N"],
                     "K": int(args[1].shape[0])}
    steady = [(ms, g) for f, (ms, g) in enumerate(zip(frame_ms, with_gba)) if f >= 8]
    fps = {name: (len(sel) / (sum(sel) / 1e3) if sel else None, len(sel)) for name, sel in (
        ("with_global_ba", [ms for ms, g in steady if g]),
        ("without_global_ba", [ms for ms, g in steady if not g]))}
    checks = {
        "loop_edges": slam.stats["loop_edges"] > 0,
        "global_ba": slam.stats["global_ba"] > 0,
        "poses_shape": list(poses.shape) == [LC_FRAMES, 7],
        "poses_finite": bool(np.isfinite(poses).all()),
        "corr_1_per_update": counts["corr"] == slam.stats["updates"],
        "one_update_per_frame": run_updates == 12 + (LC_FRAMES - 8),
        "attn_12_per_frame": counts["dino_flash_attn"] == 12 * LC_FRAMES,
        "global_ba_bitwise_equal": same,
        "loop_corr_inputs_captured": "corr" in captured,
    }
    ok = all(checks.values())
    emit({"phase": 6, "frames": LC_FRAMES, "keyframes": slam.pg.n,
          "loop_edges": slam.stats["loop_edges"], "global_ba": slam.stats["global_ba"],
          "global_ba_in_run": run_gbas, "updates": slam.stats["updates"],
          "loop_detections": len(detections), "loop_edges_per_detection": detections,
          "peak_active_edges": peak_E, "inactive_edges": len(slam.pg.ii_inac),
          "global_ba_ms_median": statistics.median(gba_ms) if gba_ms else None,
          "global_ba_ms_max": max(gba_ms) if gba_ms else None,
          "global_ba_solve_ms": gba_solve_ms,
          "index_build_ms_median": statistics.median(index_ms) if index_ms else None,
          "global_ba_captured": gba_shape if "gba" in captured else None,
          "fps_frames": {k: {"fps": v, "frames": n} for k, (v, n) in fps.items()},
          "launches": counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "checks": checks, "card": smi,
          "cuts": {"KEYFRAME_THRESH": 0.0, "weights": "random (seed 0)",
                   "frames": LC_FRAMES}, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 6: loop-closure path checks failed: {checks}")
    return counts, captured["corr"]


def _cdvo_pp_cfg(depth_head="random"):
    """get_cfg() merged with config/default_cdvo++.yaml, random seeded heads,
    no motion probe."""
    from cdvslam_tpu_torch.config import get_cfg
    preset = (ROOT / "config" / "default_cdvo++.yaml").read_text().splitlines()
    cfg = get_cfg().merge_from_list(
        [t.strip() for ln in preset if ":" in ln for t in ln.split(":", 1)])
    cfg.SEG_HEAD, cfg.DEPTH_HEAD = "random", depth_head
    cfg.MOTION_PROBE_THR = -1.0
    return cfg


def _scale_adjustment_on_card():
    """scale_adjustment on a crafted window whose last two poses turn by
    0.1 rad (the gate opens), on the card against the CPU: max abs
    difference of poses and depths, and the rate."""
    import torch
    from cdvslam_tpu_torch.lie import se3_exp
    from cdvslam_tpu_torch.slam.kernels import scale_adjustment
    g = torch.Generator().manual_seed(7)
    N, M, t0, n = 32, 96, 3, 13
    xi = 0.05 * torch.randn((N, 6), generator=g)
    xi[n - 1, 3:] = xi[n - 2, 3:] + torch.tensor([0.1, 0.0, 0.0])
    poses = se3_exp(xi)
    patches = 0.2 + torch.rand((N * M, 3, 3, 3), generator=g)
    scale = 0.3 + torch.rand((N,), generator=g)
    want = scale_adjustment(poses.clone(), patches.clone(), scale, t0, n, 0.2, M)
    got = scale_adjustment(poses.cuda(), patches.cuda(), scale.cuda(), t0, n, 0.2, M)
    torch.cuda.synchronize()
    return {"poses": (got[0].cpu() - want[0]).abs().max().item(),
            "depths": (got[1].cpu() - want[1]).abs().max().item(),
            "rate": float(got[2]), "rate_cpu": float(want[2])}


def phase7(smi):
    """The CDVO++ path at 480 x 752 and a DPT sub-run; returns the launch
    counts of the 160-frame run."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import runtime
    WARM, WIN = 60, 100
    frames, intr = _frames()
    slam = SLAM(_cdvo_pp_cfg(), network="cdv", ht=480, wd=752, seed=0)
    # device-side tallies of what the heads did; read once after the run
    tally = {k: torch.zeros((), dtype=torch.float64, device=slam.device) for k in (
        "tokens", "dynamic_tokens", "edges", "down_weighted", "selected", "zero_scores",
        "adjustments", "openings")}

    def add(key, value):
        tally[key] += value

    filt_mask, dcw = slam.seg_head.filt_mask, runtime.dynamic_class_weight
    sel, adj = runtime.select_score, runtime.scale_adjustment

    def counted_filt_mask(x, filt_index):
        mask = filt_mask(x, filt_index)
        add("tokens", mask.numel())
        add("dynamic_tokens", mask.sum())
        return mask

    def counted_dcw(*args):
        mul = dcw(*args)
        add("edges", mul.shape[0])
        add("down_weighted", (mul[:, 0] < 1).sum())
        return mul

    def counted_select(*args):
        coords, scores = sel(*args)
        add("selected", scores.numel())
        add("zero_scores", (scores == 0).sum())
        return coords, scores

    def counted_adjust(*args):
        poses, patches, rate = adj(*args)
        add("adjustments", 1)
        add("openings", rate != 1)
        return poses, patches, rate

    slam.seg_head.filt_mask = counted_filt_mask
    runtime.dynamic_class_weight, runtime.select_score = counted_dcw, counted_select
    runtime.scale_adjustment = counted_adjust
    torch.cuda.reset_peak_memory_stats()
    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    try:
        t_start = time.perf_counter()
        for f in range(WARM):
            slam(f, frames[f % 8], intr)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t_start
        upd0, corr0, attn0 = (slam.stats["updates"], corr_cuda.LAUNCHES.count,
                              flash_attn.LAUNCHES.count)
        t0 = time.perf_counter()
        for f in range(WARM, WARM + WIN):
            slam(f, frames[f % 8], intr)
        torch.cuda.synchronize()
        win_s = time.perf_counter() - t0
        win = {"updates": slam.stats["updates"] - upd0,
               "corr": corr_cuda.LAUNCHES.count - corr0,
               "attn": flash_attn.LAUNCHES.count - attn0}
        edges = slam.pg.E
        poses, _ = slam.terminate()
        torch.cuda.synchronize()
    finally:
        runtime.dynamic_class_weight, runtime.select_score = dcw, sel
        runtime.scale_adjustment = adj
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    t = {k: v.item() for k, v in tally.items()}
    frames_run, M = WARM + WIN, slam.M
    shares = {"dynamic_tokens": t["dynamic_tokens"] / max(t["tokens"], 1),
              "down_weighted_edges": t["down_weighted"] / max(t["edges"], 1)}
    crafted = _scale_adjustment_on_card()
    checks = {
        "poses_shape": list(poses.shape) == [frames_run, 7],
        "poses_finite": bool(np.isfinite(poses).all()),
        "corr_1_per_update": counts["corr"] == slam.stats["updates"] and win["corr"] == win["updates"],
        "attn_12_per_frame": counts["dino_flash_attn"] == 12 * frames_run and win["attn"] == 12 * WIN,
        "one_update_per_frame": win["updates"] == WIN,
        "dynamic_token_share_in_0_1": 0 < shares["dynamic_tokens"] < 1,
        "down_weighted_edges": t["down_weighted"] > 0,
        "no_zero_selected_score": t["zero_scores"] == 0 and t["selected"] == M * frames_run,
        "scale_adjustment_card_matches_cpu": (crafted["rate"] != 1.0
                                             and crafted["poses"] <= 1e-5
                                             and crafted["depths"] <= 1e-5),
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dict(slam.stats)
    del slam
    torch.cuda.empty_cache()
    dpt = _dpt_subrun(frames, intr)
    checks.update(dpt.pop("checks"))
    ok = all(checks.values())
    emit({"phase": 7, "fps": WIN / win_s, "window_s": win_s, "warmup_s": warm_s,
          "frames": frames_run, "updates": stats["updates"],
          "keyframe_removals": stats["keyframe_removals"], "edges": edges,
          "shares": shares, "tally": t, "scale_adjustment_crafted": crafted,
          "launches": counts, "checks": checks, "card": smi, "peak_mem_gb": peak_gb,
          "dpt_subrun": dpt,
          "cuts": {"weights": "random (seed 0), heads random (seeds 14 and 12)",
                   "frames": frames_run}, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 7: CDVO++ path checks failed: {checks}")
    return counts


def _dpt_subrun(frames, intr, nframes=40):
    """DEPTH_HEAD="dpt_random" for nframes frames: ms per frame insert (a
    synchronize on each side) and the checks."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.ops import flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    slam = SLAM(_cdvo_pp_cfg("dpt_random"), network="cdv", ht=480, wd=752, seed=0)
    insert, insert_ms = slam._insert_frame, []

    def timed_insert(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        insert(*args)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t) * 1e3)

    slam._insert_frame = timed_insert
    torch.cuda.reset_peak_memory_stats()
    attn0 = flash_attn.LAUNCHES.count
    for f in range(nframes):
        slam(f, frames[f % 8], intr)
    n, M = slam.pg.n, slam.M
    depths = slam.pg.patches_[: n * M, 2]
    depths_ok = bool(torch.isfinite(depths).all() and (depths > 0).all()
                     and torch.isfinite(slam.pg.scale_[:n]).all())
    poses, _ = slam.terminate()
    torch.cuda.synchronize()
    steady = insert_ms[8:]
    return {"frames": nframes, "insert_ms_median": statistics.median(steady),
            "insert_ms_min": min(steady), "insert_ms_max": max(steady),
            "depth_range": [depths.min().item(), depths.max().item()],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "checks": {"dpt_depths_finite": depths_ok,
                       "dpt_poses_finite": bool(np.isfinite(poses).all()),
                       "dpt_attn_12_per_frame":
                           flash_attn.LAUNCHES.count - attn0 == 12 * nframes}}


def _tree_kernels(event):
    """Device time (us) and launches of the kernels under a profiler event."""
    us = sum(k.duration for k in event.kernels)
    n = len(event.kernels)
    for child in event.cpu_children:
        c_us, c_n = _tree_kernels(child)
        us, n = us + c_us, n + c_n
    return us, n


def _label_heads(slam):
    """Wrap each head's forward in a profiler range named after it."""
    import torch
    for name in HEAD_RANGES:
        head = getattr(slam, name, None)
        if head is not None:
            def forward(*args, _f=head.forward, _name=name):
                with torch.profiler.record_function(_name):
                    return _f(*args)
            head.forward = forward


def _profile_window(slam, frames, intr, start, win, table_path):
    """win frames timed, then win more under torch.profiler: device busy
    time and idle share (busy over the untraced wall time), launches per
    frame, the port's two kernels, the heads' ranges (see _label_heads) and
    the top kernels and host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # the same number of frames unprofiled first: the profiler's own host
    # cost inflates the traced window's wall time
    t0 = time.perf_counter()
    for f in range(start, start + win):
        slam(f, frames[f % 8], intr)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in range(start + win, start + 2 * win):
            slam(f, frames[f % 8], intr)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in HEAD_RANGES]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ours = {name: {"ms_per_frame": sum(e.self_device_time_total for e in kernels
                                       if name in e.key) / 1e3 / win,
                   "calls_per_frame": sum(e.count for e in kernels if name in e.key) / win}
            for name in ("corr_pyramid_kernel", "flash_qkv_kernel")}
    heads = {}
    for e in prof.events():
        if e.name in HEAD_RANGES and e.device_type == torch.autograd.DeviceType.CPU:
            us, n = _tree_kernels(e)
            h = heads.setdefault(e.name, {"device_ms_per_frame": 0.0, "launches_per_frame": 0.0})
            h["device_ms_per_frame"] += us / 1e3 / win
            h["launches_per_frame"] += n / win
    for h in heads.values():
        h["share_of_device_time"] = h["device_ms_per_frame"] / (busy_ms / win)
    table_path.write_text(events.table(sort_by="self_device_time_total", row_limit=60))
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    return {"frames": win, "wall_ms_per_frame": wall_ms / win,
            "traced_wall_ms_per_frame": traced_ms / win,
            "device_busy_ms_per_frame": busy_ms / win,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches_per_frame": launches / win,
            "port_kernels": ours, "heads": heads,
            "top_kernels_ms_per_frame": {e.key[:60]: e.self_device_time_total / 1e3 / win
                                         for e in top},
            "top_host_ops_ms_per_frame": {e.key[:60]: e.self_cpu_time_total / 1e3 / win
                                          for e in ops}}


def profile_paths(out_dir):
    """The main path (60 warm-up frames), the loop-closure path (100
    warm-up frames: about 78 keyframes past the first loop detection) and
    the CDVO++ path (60 warm-up frames), 20 frames timed and 20 traced
    each."""
    import torch
    from cdvslam_tpu_torch.config import get_cfg
    from cdvslam_tpu_torch.slam import SLAM
    frames, intr = _frames()
    out_dir.mkdir(parents=True, exist_ok=True)
    main_cfg = get_cfg()
    main_cfg.MOTION_PROBE_THR = -1.0
    for path, cfg, warm in (("main", main_cfg, 60), ("loop", _loop_cfg(), 100),
                            ("cdvo_pp", _cdvo_pp_cfg(), 60)):
        slam = SLAM(cfg, network="cdv", ht=480, wd=752, seed=0)
        _label_heads(slam)
        for f in range(warm):
            slam(f, frames[f % 8], intr)
        torch.cuda.synchronize()
        g0 = slam.stats["global_ba"]
        rec = _profile_window(slam, frames, intr, warm, 20,
                              out_dir / f"profile_{path}_path.txt")
        emit({"phase": "profile", "path": path, **rec, "edges": slam.pg.E,
              "keyframes": slam.pg.n, "global_ba_in_windows": slam.stats["global_ba"] - g0})
        del slam
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="run phase 0 and the profiles of the main, the loop-closure and "
                         "the CDVO++ path only; the tables go to "
                         "DIR/profile_{main,loop,cdvo_pp}_path.txt")
    args = ap.parse_args()
    if not (ROOT / "cdvslam_tpu_torch").is_dir():
        print("chip_smoke.py: cdvslam_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase0()
    if args.profile is not None:
        profile_paths(ROOT / args.profile)
        return 0
    corr_rec = phase1()
    attn_rec = phase2()
    phase3()
    counts, captured = phase4(smi)
    main_rec = corr_on_captured(5, captured)
    lc_counts, lc_captured = phase6(smi)
    loop_rec = corr_on_captured("6-corr", lc_captured)
    pp_counts = phase7(smi)

    ops_ms, bytes_ms = attn_rec["bound"]
    kernels = [
        {"name": "corr", "route": "cuda", "source": "cdvslam_tpu_torch/csrc/corr.cu",
         "replaces": "cdvslam_tpu/ops/corr_pallas.py:457",
         "launches": counts["corr"], "max_abs_err": corr_rec["max_abs_err"],
         "ms": corr_rec["ms"], "plain_ms": corr_rec["plain_ms"],
         "bound_ms": corr_rec["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "per": "one update: both levels in one launch, bf16, E=9600, phase-1 inputs; "
                "ms is the median of 5 rounds of 20 calls",
         "rounds_ms": corr_rec["rounds_ms"],
         "bytes": corr_rec["bytes"], "box_share": corr_rec["box_share"],
         "ms_main_path": main_rec["ms"], "plain_ms_main_path": main_rec["plain_ms"],
         "bound_ms_main_path": main_rec["bound_ms"],
         "box_share_main_path": main_rec["box_share"],
         "launches_loop_path": lc_counts["corr"],
         "launches_cdvo_pp_path": pp_counts["corr"],
         "E_loop_update": lc_captured[3].shape[0], "ms_loop_update": loop_rec["ms"],
         "plain_ms_loop_update": loop_rec["plain_ms"],
         "bound_ms_loop_update": loop_rec["bound_ms"],
         "box_share_loop_update": loop_rec["box_share"]},
        {"name": "dino_flash_attn", "route": "cuda",
         "source": "cdvslam_tpu_torch/csrc/flash_attn.cu",
         "replaces": "cdvslam_tpu/models/dinov2.py:53",
         "launches": counts["dino_flash_attn"], "max_abs_err": attn_rec["max_abs_err"],
         "ms": attn_rec["ms"], "plain_ms": attn_rec["plain_ms"],
         "bound_ms": max(ops_ms, bytes_ms),
         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
         "library_ms": attn_rec["library_ms"],
         "launches_loop_path": lc_counts["dino_flash_attn"],
         "launches_cdvo_pp_path": pp_counts["dino_flash_attn"],
         "per": "one call, packed qkv (1, 1891, 1152) bf16 -> (1, 1891, 384); ms and "
                "library_ms are medians of 5 alternating rounds of 20 calls",
         "rounds": attn_rec["rounds"]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
