#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cdvslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py                    # the smoke: every phase below
    python3 chip_smoke.py --profile DIR      # phase 0, then a profile only

Phases, each printing one JSON line; any failure exits non-zero:
  0  the card (nvidia-smi), torch and CUDA versions; builds both kernels
     with nvcc for sm_90a and prints the build time, ptxas's register and
     spill lines, and the HGMMA instructions of each bf16 K2 kernel and of
     the float32 forward in the built library (cuobjdump -sass): fails if
     either bf16 backward kernel or the float32 forward has none
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
  2-train  K2 for training: the float32 forward (output and log-sum-exp)
     within 1e-5 of max |plain|, the bf16 forward with the log-sum-exp by
     phase 2's rule and its log-sum-exp within 1e-3, the backward kernels
     within 1e-4 (float32) and 1e-2 (bf16) of max |plain| (the plain
     backward from the plain output and log-sum-exp) and bitwise
     repeatable, the float32 forward's call with the log-sum-exp bitwise
     equal to its call without and to a second call, at L in {1, 7, 9, 63,
     65, 127, 129, 1000, 1891} (B 1) and the sparse training shape (B 15,
     L 1611); then times at the training shape against the plain versions,
     SDPA's forward and backward, and the bounds, each backward kernel's
     and both together's, and the float32 forward at the SLAM shape (B 1,
     L 1891) against SDPA's float32 forward ("2-train-times"). Float32
     bounds: three TF32 passes on the tensor cores, the FP32-FMA figure
     beside it
  3  bundle adjustment run twice at E = 9600, K = 2688: bitwise equal
  4  the main path: SLAM(get_cfg(), "cdv", 480, 752) with seeded random
     weights and 8 seeded random frames cycled, each prefetched one frame
     ahead (SLAM.prefetch), 60 warm-up frames, one 100-frame timed
     window, then 20 blocks of 20 frames without and with the prefetch
     (plain, prefetched, prefetched, plain, ...; the prefetched blocks'
     median time no more than the others' median plus their
     interquartile range), the upload timed over the blocks (device: the
     plain copy and the wait on a prefetched upload, CUDA events; host:
     the prefetch() call and the plain upload; the median wait below the
     median copy), terminate(); poses finite, corr launched once per update and flash
     attention 12 times per frame; the corr inputs of the last warm-up
     frame's update are captured
  4-f32  40 frames of the main path with MIXED_PRECISION=False: FPS, poses
     finite, 12 float32 K2 launches per frame and no bf16 one
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
  6-classic  the published config/default_cdvslam.yaml with its classical
     backend (ORB + BoW retrieval, triplet triangulation, Sim3 PGO in a
     worker thread) and the proximity backend on, phase 6's cut,
     LC_FRAMES frames of a camera circling a rendered textured plane
     (PlaneScene; frame 100 + k revisits frame k): FPS beside phase 4's
     (with and without a PGO worker running), retrieval ms per frame,
     lc_attempts (must be above 0) and lc_applied, ms per PGO; then
     close_loop on a known state of 1,000 keyframes (classic_state: the
     path's true poses with a seeded drift, the plane's true inverse
     depths) under CLASSIC_LOOP_SYNC on the card and in a float64 CPU run
     of the port: a correction applied within 1e-3 of the CPU run per pose
     component, ms per close_loop and per run_pgo
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
  8  the DPVO path ("8-corr" first: K1 at C = 128 on the phase-1 layouts,
     the same rules, times at E = 9600): get_cfg() merged with
     config/default_dpvo.yaml (RANDOM selection), SLAM(cfg, "dpv", 480,
     752), MOTION_PROBE_THR=-1, seeded random weights and phase 4's frames,
     60 warm-up frames, one 100-frame timed window, terminate(); poses
     finite, corr launched once per update and always at C = 128, flash
     attention never; then 40 frames with GRADIENT_BIAS (poses finite,
     every selected centre inside [1, dim - 1)) and a DPV-SLAM run
     (LOOP_CLOSURE=True with phase 6's cut KEYFRAME_THRESH=0, LC_FRAMES
     frames: loop edges and global BAs fire, poses finite); K1 is checked
     and timed on the last warm-up update's inputs ("8-update") and on the
     first update with loop edges ("8-loop-update")
  9  training (``cdvslam_tpu_torch.train.cli``) on a synthetic TartanAir
     tree at 480 x 640 with seeded random weights: 3 sparse and 2 dense
     CDVNet steps in float32, two bf16 sparse steps and a DPVO step; ms
     per step, peak memory, K2 launches against 12 blocks x 2 forward (the
     checkpointed extractor runs again in the backward) and 12 of each
     backward kernel per step, a nonzero gradient in every parameter group
     and every DINO block's qkv; one small step, twice on the card, held
     leaf by leaf to float32 and float64 CPU runs of the port; the float32
     run also runs the in-training validation once after its last step
     (``--eval_every 5``, ``--eval_datapath`` the tree's scene directory,
     its config with MOTION_PROBE_THR -1): one finite ATE for the scene,
     and the training's peak memory read before it
  10 the entry points on 120 rendered frames at 480 x 752 (PlaneScene on
     loop_path, PNGs, a calibration file and a TUM ground truth): ``python
     -m cdvslam_tpu_torch.demo`` in a subprocess with --save_trajectory
     --plot --save_ply --save_colmap --timeit (exit 0, the files, finite
     poses, the timed sections); ``eval.harness.run_sequence`` with
     default_cdvo.yaml and ``evaluate_against_tum_gt``: the harness's FPS
     over frames 60-119 beside phase 4's, a finite ATE (random weights: no
     accuracy figure), K1 once per update and K2 12 times per frame; the
     reader alone in ms per frame; fast_dpvo.yaml through the harness under
     "dpv" (finite poses, keyframe removals counted, K1 at C = 128 once per
     update); and the web viewer (``SLAM(viz=True)``, 40 frames):
     state.json fetched over loopback with its sizes checked, refresh()
     timed
  11 the trained-weights proof (``python -m cdvslam_tpu_torch.train.
     e2e_proof``, cut to PROOF_STEPS = 20 training steps; its own run is
     1,500): K2 at the proof's 415 tokens (240 x 320) against plain, the
     serving call at B 1 by phase 2's rule and the training calls at B 8
     by phase "2-train"'s, with times; the float32 training on the pool of
     48 rendered clips (every loss finite, ms per step, peak memory; 24
     float32 K2 forwards, 12 dQ and 12 dK/dV per step, no bf16 K2 and no
     K1: the rollout takes the plain corr); the checkpoint round trip
     through a temporary directory (the weights the SLAM loads equal the
     trained ones bitwise); the SLAM with the trained and with random
     weights over the 40 held-out frames at the evaluation's five seeds
     (the tool's JSON result and every seed's ATEs, all finite, K1 once
     per update and bf16 K2 12 times per frame); K1 on one update of the
     trained run (pyramids of 60 x 80 and 15 x 20) against plain by phase
     1's rule, and timed
  12 the retrieval-recall harness (``eval.lc_recall``) at per_loop 24,
     sigma 0 and 5, on the host: the table's rows, recall at sigma 0 and
     thresh 0.04 above 0

Then a kernels line (a list of per-kernel records: launches on the main
path, max error, kernel / plain / library times and the roofline bound;
K1's record adds the phase-5 times as ms_main_path and friends, the
phase-6 times as ms_loop_update and friends, and phase 8's as ms_c128,
ms_dpvo_update, ms_dpv_loop_update and friends; both records add
launches_loop_path, launches_harness_path (phase 10's harness run),
launches_classic_path, launches_cdvo_pp_path, launches_dpvo_path and
launches_proof_slam_runs (phase 11's SLAM runs), and K1's adds phase
11's update as ms_proof_update, max_abs_err_proof_update and friends; the
float32 forward and the two backward kernels of K2 have records of their
own, timed at the training shape, with phase 9's launches and phase
11's (launches_proof_training, ms_proof_shape at B 8, L 415), and the bf16
backward kernels (wgmma kernels apart from the float32 ones) records of
their own with the launches of phase 9's bf16 run; the float32 records
take three TF32 passes as bound_ms and give the FP32-FMA figure as
bound_fma_ms; the float32 forward's record names its pre-pass and adds
its SLAM-shape times as ms_slam and friends),
the nvidia-smi line, and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

``--profile DIR`` runs phase 0 and then, instead of the smoke, 20
steady-state frames of the main path timed and 20 more under
torch.profiler: device busy time and idle share (busy over the untraced
wall time), launches per frame, the port's two kernels and the top
kernels by device time; then the same for the loop-closure path of
phase 6 after 100 warm-up frames, for the CDVO++ path of phase 7 after
60 (with the heads' device time and launches per frame) and for the DPVO
path of phase 8 after 60; then a float32 and a bf16 sparse training step
(phase 9's setting, each after two untraced steps). The full tables go to
DIR/profile_{main,loop,cdvo_pp,dpvo}_path.txt and
DIR/profile_train_step{,_bf16}.txt. It prints neither the kernels line nor
the ok line.
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
TF32_FLOPS = 495e12           # dense TF32 tensor cores: a float32-accurate product is three passes

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


def _hgmma_counts(lib):
    """HGMMA instructions per kernel (mangled name) in a built library's SASS."""
    from cdvslam_tpu_torch.ops import native
    tool = Path(native.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


BF16_K2 = ("flash_qkv_kernel", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
F32_K2 = ("flash_f32_kernel",)   # the float32 forward: three TF32 passes on wgmma


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
                  if "registers" in ln or "spill" in ln or "(C75" in ln
                  or "entry function" in ln]
            for name, b in builds.items()}
    per_fn = _hgmma_counts(native.lib_path("flash_attn"))
    hgmma = {k: sum(n for fn, n in per_fn.items() if k in fn) for k in BF16_K2 + F32_K2}
    emit({"phase": 0, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_wall_s": round(wall, 3),
          "build_s": {k: round(v["seconds"], 3) for k, v in builds.items()},
          "ptxas": regs, "hgmma": hgmma})
    if not (hgmma["flash_bwd_dq_bf16"] and hgmma["flash_bwd_dkv_bf16"]):
        raise SystemExit(f"phase 0: a bf16 backward kernel has no HGMMA: {hgmma}")
    if not all(hgmma[k] for k in F32_K2):
        raise SystemExit(f"phase 0: the float32 forward has no HGMMA: {hgmma}")
    return smi


def _corr_inputs(gen, dtype, E=E, layout="random", C=C):
    """Inputs at the main-path shapes with C channels (24: the CDV paths,
    128: the DPVO path). layout: "random" (the phase-1 draw:
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
    flops = args[3].shape[0] * 9 * 64 * args[0].shape[1] * 2 * 2
    rounds = [cuda_time(lambda: corr_cuda.corr_pyramid_cl(*args), 20) for _ in range(5)]
    return {"ms": statistics.median(rounds), "rounds_ms": rounds,
            "plain_ms": cuda_time(lambda: corr_pyramid_plain(*args), 3),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3,
            "bytes": nbytes, "box_share": _box_share(args[3])}


def phase1(channels=C, phase=1, seed=1):
    """K1 against its plain version on the layouts below, at ``channels``
    (phase 1: 24, the CDV paths; phase "8-corr": 128, the DPVO path)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"phase": phase, "C": channels, "checks": {}}
    worst, ok = 0.0, True
    cases = [("random", E), ("border", E), ("rigid", E), ("scattered", E),
             ("random", 0), ("random", 777)]
    rec = None
    for layout, n in cases:
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = _corr_inputs(gen, dtype, n, layout, C=channels)
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
    if phase != 1:
        out.update({k: rec[k] for k in ("ms", "rounds_ms", "plain_ms", "bound_ms", "bytes")})
    emit(out)
    if not ok:
        raise SystemExit(f"phase {phase}: corr disagrees with plain")
    rec["max_abs_err"] = worst
    return rec


def _k2_serving_case(qkv, h):
    """The bf16 serving call against its plain version by phase 2's rule
    (max abs error 2e-2, relative Frobenius 1e-2)."""
    import torch
    from cdvslam_tpu_torch.ops import flash_attn
    got = flash_attn.flash_attention_qkv(qkv, h).float()
    want = flash_attn.attention_qkv_plain(qkv, h).float()
    torch.cuda.synchronize()
    max_abs = (got - want).abs().max().item()
    rel_fro = ((got - want).norm() / want.norm()).item()
    ok = got.shape == want.shape == (*qkv.shape[:2], qkv.shape[2] // 3)
    return {"max_abs": max_abs, "rel_fro": rel_fro,
            "ok": ok and max_abs <= 2e-2 and rel_fro <= 1e-2}


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
        out["checks"][f"L{n}"] = rec = _k2_serving_case(qkv, h)
        ok, worst = ok and rec["ok"], max(worst, rec["max_abs"])
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


TRAIN_SHAPE = (15, 6, 1611, 64)   # sparse training: 15 frames at 480 x 640 (490 x 644 padded)


def _attn_flops(B, L, h=6, d=64):
    """Multiply-adds counted twice: S = Q K^T and P V, 2 L^2 d each."""
    return 4 * L * L * d * h * B


def _bwd_native(which, qkv, out, lse, dout, D, dqkv, lib=None):
    """One launch of a backward kernel through the C entry point (``dq``
    also writes D, which ``dkv`` reads), for timing each kernel alone; of
    the current source, or of another build of it (``lib``)."""
    import torch
    from cdvslam_tpu_torch.ops import native
    if lib is None:
        lib = native.load("flash_attn")
    B, L, C3 = qkv.shape
    stream = torch.cuda.current_stream().cuda_stream
    dt = 0 if qkv.dtype == torch.float32 else 1
    if which == "dq":
        err = lib.flash_attn_qkv_backward_dq(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                             lse.data_ptr(), D.data_ptr(), dqkv.data_ptr(),
                                             B, L, 6, 0.125, dt, stream)
    else:
        err = lib.flash_attn_qkv_backward_dkv(qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                                              D.data_ptr(), dqkv.data_ptr(), B, L, 6, 0.125,
                                              dt, stream)
    native.check(err, which)


def _k2_train_case(gen, B, L):
    """K2's training calls on one seeded (B, L) draw against their plain
    versions by phase "2-train"'s rules (see ``phase2_train``): the
    float32 and bf16 forwards with the log-sum-exp and both backward
    kernels, each twice for bitwise repeatability. Returns the record
    (with "ok") and the max abs errors by key."""
    import torch
    from cdvslam_tpu_torch.ops import flash_attn as fa
    errs = {}

    def rel(a, b, key=None):
        err = (a.float() - b.float()).abs().max().item()
        if key is not None:
            errs[key] = max(errs.get(key, 0.0), err)
        return err / b.float().abs().max().item()

    qkv = torch.randn((B, L, 1152), generator=gen, device="cuda")
    dout = torch.randn((B, L, 384), generator=gen, device="cuda")
    rec, good = {}, True
    for dtype, name, tol in ((torch.float32, "f32", 1e-4), (torch.bfloat16, "bf16", 1e-2)):
        x, g = qkv.to(dtype), dout.to(dtype)
        o, lse = fa._forward(x, 6, with_lse=True)
        p_out, p_lse = fa.attention_qkv_plain(x.float(), 6), fa.attention_lse_plain(x, 6)
        r_lse = rel(lse, p_lse, "bf16_lse" if name == "bf16" else None)
        if name == "f32":
            r_out = rel(o, p_out, "f32")
            o2, lse2 = fa._forward(x, 6, with_lse=True)
            same = (torch.equal(fa._forward(x, 6, with_lse=False)[0], o)
                    and torch.equal(o2, o) and torch.equal(lse2, lse))
            rec.update(fwd_f32_rel=r_out, lse_f32_rel=r_lse, fwd_f32_bitwise=same)
            good = good and r_out <= 1e-5 and r_lse <= 1e-5 and same
        else:
            want = fa.attention_qkv_plain(x, 6).float()
            max_abs = (o.float() - want).abs().max().item()
            rel_fro = ((o.float() - want).norm() / want.norm()).item()
            rec.update(fwd_bf16_max_abs=max_abs, fwd_bf16_rel_fro=rel_fro, lse_bf16_rel=r_lse)
            good = good and max_abs <= 2e-2 and rel_fro <= 1e-2 and r_lse <= 1e-3
        d1 = fa.flash_attention_qkv_backward(x, o, lse, g, 6)
        d2 = fa.flash_attention_qkv_backward(x, o, lse, g, 6)
        r = rel(d1, fa.attention_qkv_backward_plain(x, p_out, p_lse, g, 6), f"bwd_{name}")
        same = torch.equal(d1, d2)
        rec[f"bwd_{name}_rel"], rec[f"bwd_{name}_bitwise"] = r, same
        good = good and r <= tol and same
    torch.cuda.synchronize()
    rec["ok"] = good
    return rec, errs


def phase2_train():
    """K2 for training: the float32 forward (output and log-sum-exp) and
    the backward kernels in float32 and bf16 against their plain versions
    at the SLAM shape (B 1, L 1891), the training shape (B 15, L 1611) and
    odd L; two backward calls bitwise equal, and the float32 forward with
    the log-sum-exp bitwise equal to the call without it and to a second
    call; then times at the training shape against the plain versions,
    SDPA's forward and its backward, and the roofline bounds, and the
    float32 forward at the SLAM shape. Tolerances: f32 forward output and
    log-sum-exp 1e-5 and f32 backward 1e-4 of max |plain|; the bf16 forward with the
    log-sum-exp as phase 2 holds the serving call (2e-2 max abs, 1e-2
    relative Frobenius, against the plain version in bf16) and its
    log-sum-exp 1e-3 of max |plain|; bf16 backward 1e-2 of max |plain|.
    The plain backward takes the plain output (float32 on the same values)
    and log-sum-exp, not the kernels'; the kernels round dqkv to bf16."""
    import torch
    import torch.nn.functional as F
    from cdvslam_tpu_torch.ops import flash_attn as fa
    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {"phase": "2-train", "checks": {}}
    worst = {"f32": 0.0, "bf16_lse": 0.0, "bwd_f32": 0.0, "bwd_bf16": 0.0}  # max abs errors
    ok = True
    for B, L in ((1, 1), (1, 7), (1, 9), (1, 63), (1, 65), (1, 127), (1, 129), (1, 1000),
                 (1, 1891), TRAIN_SHAPE[::2]):
        rec, errs = _k2_train_case(gen, B, L)
        for key, err in errs.items():
            worst[key] = max(worst[key], err)
        out["checks"][f"B{B}_L{L}"] = rec
        ok = ok and rec["ok"]
    out["ok"] = ok
    emit(out)
    if not ok:
        raise SystemExit("phase 2-train: the training kernels disagree with plain")

    # times at the training shape
    B, h, L, d = TRAIN_SHAPE
    flops = _attn_flops(B, L)
    times = {}
    # a float32-accurate product is three TF32 passes on the tensor cores
    for dtype, name, peak in ((torch.float32, "f32", TF32_FLOPS / 3),
                              (torch.bfloat16, "bf16", BF16_FLOPS)):
        es = 4 if dtype == torch.float32 else 2
        qkv = torch.randn((B, L, 1152), generator=gen, device="cuda").to(dtype)
        dout = torch.randn((B, L, 384), generator=gen, device="cuda").to(dtype)
        o, lse = fa._forward(qkv, 6, with_lse=True)
        D = torch.empty((B, h, L), device="cuda")
        dqkv = torch.empty_like(qkv)
        q, k, v = (t.detach().requires_grad_(True) for t in
                   qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        sd_out = F.scaled_dot_product_attention(q, k, v)
        sd_dout = dout.reshape(B, L, h, d).transpose(1, 2)
        fns = {"fwd": lambda: fa._forward(qkv, 6, with_lse=True),
               "dq": lambda: _bwd_native("dq", qkv, o, lse, dout, D, dqkv),
               "dkv": lambda: _bwd_native("dkv", qkv, o, lse, dout, D, dqkv),
               "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v),
               "sdpa_bwd": lambda: torch.autograd.grad(sd_out, (q, k, v), sd_dout,
                                                       retain_graph=True)}
        rounds = {key: [] for key in fns}
        for i in range(5):
            for key in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                rounds[key].append(cuda_time(fns[key], 3, warmup=1))
        med = {key: statistics.median(v) for key, v in rounds.items()}
        med["plain_fwd"] = cuda_time(lambda: fa.attention_qkv_plain(qkv, 6), 3, warmup=1)
        med["plain_bwd"] = cuda_time(
            lambda: fa.attention_qkv_backward_plain(qkv, o, lse, dout, 6), 3, warmup=1)
        io = B * L * 384 * es                       # one (B, L, C) tensor
        stat = B * h * L * 4                        # one (B, h, L) float32 tensor
        # bytes each function must move (inputs read once, outputs written
        # once) and operations: forward S and P V; dQ: S, dP and dQ (6 L^2 d
        # h); dK/dV: S, dP, dK and dV (8 L^2 d h) -- the whole backward
        # needs 10 L^2 d h when one kernel does both
        work = {"fwd": (flops, 4 * io + stat),
                "dq": (1.5 * flops, 3 * io + 2 * io + 2 * stat + io),
                "dkv": (2.0 * flops, 3 * io + io + 2 * stat + 2 * io)}
        for key, (ops, nbytes) in work.items():
            ops_ms, bytes_ms = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            times[f"{key}_{name}"] = {
                "ms": med[key], "rounds_ms": rounds[key],
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "share_of_bound": max(ops_ms, bytes_ms) / med[key],
                "plain_ms": med["plain_fwd"] if key == "fwd" else med["plain_bwd"],
                "library_ms": med["sdpa_fwd"] if key == "fwd" else med["sdpa_bwd"]}
            if name == "f32":   # the FP32 FMA pipes' figure beside it
                times[f"{key}_{name}"].update(bound_fma_ms=ops / F32_FLOPS * 1e3,
                                              share_of_fma_bound=ops / F32_FLOPS * 1e3 / med[key])
        # the backward as one function: 10 L^2 d h; the split design
        # recomputes S and dP in both kernels (4 L^2 d h more)
        ops_ms = 2.5 * flops / peak * 1e3
        bytes_ms = (8 * io + stat) / HBM_BYTES_PER_S * 1e3
        bwd_ms = med["dq"] + med["dkv"]
        times[f"bwd_{name}"] = {
            "ms": bwd_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": max(ops_ms, bytes_ms) / bwd_ms,
            "plain_ms": med["plain_bwd"], "library_ms": med["sdpa_bwd"]}
        if name == "f32":
            times[f"bwd_{name}"]["bound_fma_ms"] = 2.5 * flops / F32_FLOPS * 1e3
        times[f"sdpa_fwd_bwd_{name}_ms"] = med["sdpa_fwd"] + med["sdpa_bwd"]
        del qkv, dout, o, lse, D, dqkv, q, k, v, sd_out
        torch.cuda.empty_cache()
    times["fwd_f32_slam"] = _f32_forward_slam_times(gen)
    emit({"phase": "2-train-times", "shape": {"B": B, "heads": h, "L": L, "d": d},
          "per": "one call; ms medians of 5 alternating rounds of 3 calls; plain_ms of the "
                 "backward is the formula (both kernels' work); library_ms: SDPA forward, or "
                 "SDPA backward (dq, dk and dv together)", **times})
    return {"max_abs_err": worst, "times": times}


def _f32_forward_slam_times(gen):
    """The float32 forward with the log-sum-exp at the SLAM shape against
    SDPA's float32 forward, 5 alternating rounds of 20 calls (medians), with
    both bounds: three TF32 passes (bound_ms) and the FP32 FMA pipes."""
    import torch
    import torch.nn.functional as F
    from cdvslam_tpu_torch.ops import flash_attn as fa
    B, h, L, d = ATTN_SHAPE
    qkv = torch.randn((B, L, 3 * h * d), generator=gen, device="cuda")
    q, k, v = qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    fns = {"fwd": lambda: fa._forward(qkv, h, with_lse=True),
           "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)}
    rounds = {key: [] for key in fns}
    for i in range(5):
        for key in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            rounds[key].append(cuda_time(fns[key], 20))
    ms = statistics.median(rounds["fwd"])
    ops = _attn_flops(B, L, h, d)
    ops_ms, fma_ms = 3 * ops / TF32_FLOPS * 1e3, ops / F32_FLOPS * 1e3
    bytes_ms = (4 * B * L * h * d * 4 + B * h * L * 4) / HBM_BYTES_PER_S * 1e3
    return {"shape": {"B": B, "heads": h, "L": L, "d": d}, "ms": ms, "rounds_ms": rounds["fwd"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": max(ops_ms, bytes_ms) / ms,
            "bound_fma_ms": fma_ms, "share_of_fma_bound": fma_ms / ms,
            "plain_ms": cuda_time(lambda: fa.attention_qkv_plain(qkv, h), 5),
            "library_ms": statistics.median(rounds["sdpa"]), "library_rounds_ms": rounds["sdpa"]}


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
    """The main path, each frame prefetched one frame ahead
    (``SLAM.prefetch``); returns the launch counts, the corr kernel's inputs
    captured from the last warm-up frame's update, and the FPS. After the
    timed window, 20 blocks of 20 frames run without and with the
    prefetch in the order plain, prefetched, prefetched, plain, ... (the
    host's clock drifts within a run, and strict turns would always put
    the prefetched block second): the prefetched blocks' median time must
    not exceed the others' median by more than the others' own spread
    (their interquartile range). Over the blocks the upload itself is
    timed (``SLAM.upload_log``): on the device, the plain call's copy on
    the main stream and the main stream's wait on a prefetched frame's
    upload (CUDA events around each); on the host, the ``prefetch()``
    call and the plain call's upload (medians). The prefetch's mechanism
    is checked directly: the median wait is below the median plain copy."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.config import get_cfg
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import kernels as slam_kernels
    ht, wd, WARM, WIN, BLOCK, BLOCKS = 480, 752, 60, 100, 20, 20
    cfg = get_cfg()
    cfg.MOTION_PROBE_THR = -1.0
    frames, intr = _frames(ht, wd)
    kernel = slam_kernels.corr_pyramid_cl
    captured, prefetch_s = [], []

    def prefetch(image):
        t = time.perf_counter()
        slam.prefetch(image)
        prefetch_s.append(time.perf_counter() - t)

    def run(fs, prefetch=prefetch):
        """Frames fs, each prefetched while the one before it runs."""
        if prefetch:
            prefetch(frames[fs[0] % 8])
        for f in fs:
            if prefetch and f + 1 < fs.stop:
                prefetch(frames[(f + 1) % 8])
            slam(f, frames[f % 8], intr)

    def capture(*args):
        captured.append(tuple(a.clone() for a in args[:6]))   # the tensors
        return kernel(*args)

    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    slam = SLAM(cfg, network="cdv", ht=ht, wd=wd, seed=0)
    t_start = time.perf_counter()
    run(range(WARM - 1))
    slam_kernels.corr_pyramid_cl = capture
    try:
        run(range(WARM - 1, WARM))
    finally:
        slam_kernels.corr_pyramid_cl = kernel
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    upd0, corr0, attn0 = slam.stats["updates"], corr_cuda.LAUNCHES.count, flash_attn.LAUNCHES.count
    t0 = time.perf_counter()
    run(range(WARM, WARM + WIN))
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    win_updates = slam.stats["updates"] - upd0
    win_corr = corr_cuda.LAUNCHES.count - corr0
    win_attn = flash_attn.LAUNCHES.count - attn0
    edges = slam.pg.E
    block_s = {False: [], True: []}
    prefetch_s.clear()
    slam.upload_log = []
    for b in range(BLOCKS):
        first = WARM + WIN + b * BLOCK
        t = time.perf_counter()
        prefetched = b % 4 in (1, 2)
        run(range(first, first + BLOCK), prefetch=prefetch if prefetched else None)
        torch.cuda.synchronize()
        block_s[prefetched].append(time.perf_counter() - t)
    log, slam.upload_log = slam.upload_log, None
    poses, tstamps = slam.terminate()
    torch.cuda.synchronize()
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    frames_run = WARM + WIN + BLOCK * BLOCKS
    q1, med, q3 = statistics.quantiles(block_s[False], n=4)
    prefetch_ratio = statistics.median(block_s[True]) / med
    upload = {  # ms: device (CUDA events on the main stream) and host medians
        "plain_copy_device_ms": statistics.median(
            s.elapsed_time(e) for p, s, e, _ in log if not p),
        "prefetched_wait_device_ms": statistics.median(
            s.elapsed_time(e) for p, s, e, _ in log if p),
        "plain_upload_host_ms": 1e3 * statistics.median(h for p, _, _, h in log if not p),
        "prefetched_take_host_ms": 1e3 * statistics.median(h for p, _, _, h in log if p),
        "prefetch_call_host_ms": 1e3 * statistics.median(prefetch_s),
        "frames": {"plain": sum(not p for p, *_ in log), "prefetched": sum(p for p, *_ in log)},
        "frame_bytes": frames[0].nbytes}
    checks = {
        "poses_shape": list(poses.shape) == [frames_run, 7],
        "poses_finite": bool(np.isfinite(poses).all()),
        "corr_1_per_update": counts["corr"] == slam.stats["updates"] and win_corr == win_updates,
        "attn_12_per_frame": counts["dino_flash_attn"] == 12 * frames_run and win_attn == 12 * WIN,
        "one_update_per_frame": win_updates == WIN,
        "corr_inputs_captured": len(captured) == 1,
        "no_inactive_store": slam.pg.tw is None and len(slam.pg.ii_inac) == 0,
        "prefetch_no_slower": statistics.median(block_s[True]) <= med + (q3 - q1),
        "prefetch_wait_below_copy": (upload["prefetched_wait_device_ms"]
                                     < upload["plain_copy_device_ms"]),
        "prefetch_all_used": not slam._prefetched,
    }
    ok = all(checks.values())
    emit({"phase": 4, "fps": WIN / win_s, "window_s": win_s, "warmup_s": warm_s,
          "prefetch_blocks_s": block_s[True], "plain_blocks_s": block_s[False],
          "fps_prefetch_blocks": BLOCK * len(block_s[True]) / sum(block_s[True]),
          "fps_plain_blocks": BLOCK * len(block_s[False]) / sum(block_s[False]),
          "prefetch_median_ratio": prefetch_ratio, "plain_blocks_iqr_s": q3 - q1,
          "upload": upload,
          "frames": frames_run, "updates": slam.stats["updates"],
          "keyframe_removals": slam.stats["keyframe_removals"], "edges": edges,
          "launches": counts, "checks": checks, "card": smi,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 4: main path checks failed: {checks}")
    return counts, captured[0], WIN / win_s


def phase4_f32(smi, nframes=40):
    """The main path in float32 (MIXED_PRECISION=False): the DINO blocks on
    the float32 K2 forward. nframes frames, FPS over the frames after the
    8-frame init, poses finite, 12 f32 K2 launches per frame and no bf16."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.config import get_cfg
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    cfg = get_cfg()
    cfg.MOTION_PROBE_THR = -1.0
    cfg.MIXED_PRECISION = False
    frames, intr = _frames()
    slam = SLAM(cfg, network="cdv", ht=480, wd=752, seed=0)
    corr_cuda.LAUNCHES.reset()
    flash_attn.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for f in range(nframes):
        if f == 8:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        slam(f, frames[f % 8], intr)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    poses, _ = slam.terminate()
    torch.cuda.synchronize()
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn_f32": flash_attn.LAUNCHES_F32.count,
              "dino_flash_attn_bf16": flash_attn.LAUNCHES.count}
    checks = {"poses_finite": bool(np.isfinite(poses).all()),
              "poses_shape": list(poses.shape) == [nframes, 7],
              "attn_f32_12_per_frame": counts["dino_flash_attn_f32"] == 12 * nframes,
              "no_bf16_attn": counts["dino_flash_attn_bf16"] == 0,
              "corr_1_per_update": counts["corr"] == slam.stats["updates"],
              "float32_network": slam.fdtype == torch.float32}
    ok = all(checks.values())
    emit({"phase": "4-f32", "frames": nframes, "fps": (nframes - 8) / run_s,
          "updates": slam.stats["updates"], "launches": counts, "checks": checks,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 4-f32: float32 main path checks failed: {checks}")
    return counts


def corr_on_captured(phase, args):
    """K1 on one update's own inputs, captured from a path's run: phase 5
    (a steady main-path update), phase "6-corr" (an update with loop
    edges), and phase 8's "8-update" and "8-loop-update" (the same on the
    DPVO path, C = 128)."""
    err, rel, _ = _corr_check(args)
    rec = _corr_record(args)
    ok = rel <= 5e-3
    emit({"phase": phase, "C": args[0].shape[1], "E": args[3].shape[0], "max_abs": err,
          "rel": rel,
          "box_share": rec["box_share"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
          "bound_ms": rec["bound_ms"], "ok": ok})
    if not ok:
        raise SystemExit(f"phase {phase}: corr disagrees with plain on the captured inputs")
    return rec


def _preset(name):
    """get_cfg() merged with config/<name> (its "KEY: value" lines; no yaml
    module needed)."""
    from cdvslam_tpu_torch.config import get_cfg
    preset = (ROOT / "config" / name).read_text().splitlines()
    return get_cfg().merge_from_list(
        [t.strip() for ln in preset if ":" in ln for t in ln.split(":", 1)])


def _loop_cfg():
    """get_cfg() merged with config/default_cdvslam.yaml, proximity backend
    only, no motion probe, KEYFRAME_THRESH=0."""
    cfg = _preset("default_cdvslam.yaml")
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


EUROC_INTR = (458.654, 457.296, 367.215, 248.375)


def classic_state(n, M, ht, wd, intr, loop):
    """A keyframe state for the classical backend: n keyframes of
    ``loop_path(n, n - 20)`` with a seeded drift (rotation and translation
    noise, scale growing to 2x), M patches per frame at seeded quarter-
    resolution pixels with the plane's true inverse depths, and the gray
    frames of the loop pair's triplets. Returns (poses (n, 7), patches
    (n * M, 3, 3, 3), intrinsics / 4 (4,), {frame id: gray})."""
    import cv2
    import numpy as np
    from scipy.spatial.transform import Rotation
    from cdvslam_tpu_torch.data.render import PlaneScene, _pose_rt, _se3, loop_path
    scene = PlaneScene(intr, ht, wd, seed=3)
    gt = loop_path(n, n - 20)
    rng = np.random.RandomState(0)

    def mat(pose):
        G = np.eye(4)
        G[:3, :3], G[:3, 3] = _pose_rt(pose)
        return G

    est = [mat(gt[0])]
    for k in range(1, n):
        rel = mat(gt[k]) @ np.linalg.inv(mat(gt[k - 1]))
        rel[:3, 3] *= np.exp(np.log(2.0) * k / n)
        noise = np.eye(4)
        noise[:3, :3] = Rotation.from_rotvec(0.002 * rng.randn(3)).as_matrix()
        noise[:3, 3] = 0.002 * rng.randn(3)
        est.append(noise @ rel @ est[-1])
    poses = np.stack([_se3(G[:3, :3], G[:3, 3]) for G in est])
    patches = np.zeros((n * M, 3, 3, 3))
    for f in range(n):
        px, py = rng.uniform(2, wd / 4 - 2, M), rng.uniform(2, ht / 4 - 2, M)
        for c, val in enumerate((px, py, scene.true_inv_depth(gt[f], px, py))):
            patches[f * M:(f + 1) * M, c] = val[:, None, None]
    gray = {f: cv2.cvtColor(scene.render(gt[f]), cv2.COLOR_RGB2GRAY)
            for i in loop for f in (i - 1, i, i + 1)}
    return poses, patches, np.asarray(intr, np.float64) / 4, gray


def fill_classic_state(slam, state):
    """Write ``classic_state`` into a port SLAM's patch graph (every frame
    a keyframe, ids 0..n-1) and index the triplets' frames."""
    import numpy as np
    import torch
    poses, patches, intr4, gray = state
    pg, n = slam.pg, len(poses)
    pg.n, pg.m, pg.counter = n, len(patches), n
    pg.tstamps_[:n] = np.arange(n)
    for buf, val in ((pg.poses_, poses), (pg.patches_, patches),
                     (pg.intrinsics_, np.broadcast_to(intr4, (n, 4)))):
        buf[:len(val)] = torch.as_tensor(val, dtype=buf.dtype, device=buf.device)
    for f, g in gray.items():
        slam.long_term_lc.retrieval.insert_image(g, f)


def _classic_cfg():
    """default_cdvslam.yaml as published (classical backend and proximity
    loop closure on), with phase 6's cut: no motion probe,
    KEYFRAME_THRESH=0."""
    cfg = _preset("default_cdvslam.yaml")
    cfg.MOTION_PROBE_THR = -1.0
    cfg.KEYFRAME_THRESH = 0.0
    return cfg


def phase6_classic(smi, fps_main):
    """The published default_cdvslam.yaml with the classical backend on, on
    rendered loop frames; then the backend on a known 1,000-keyframe state
    against the port's float64 CPU run. Returns the launch counts."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.data.render import PlaneScene, loop_path
    from cdvslam_tpu_torch.loop import long_term
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    ht, wd = 480, 752
    cfg = _classic_cfg()
    t = time.perf_counter()
    scene = PlaneScene(EUROC_INTR, ht, wd, seed=3)
    frames = [scene.render(p) for p in loop_path(LC_FRAMES, LC_FRAMES - 20)]
    render_s = time.perf_counter() - t
    intr = np.asarray(EUROC_INTR, np.float32)
    slam = SLAM(cfg, network="cdv", ht=ht, wd=wd, seed=0)
    lc, run_pgo = slam.long_term_lc, long_term.run_pgo
    index_ms, query_ms, pgo_ms = [], [], []

    def host_timed(fn, log):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            log.append((time.perf_counter() - t) * 1e3)
            return out
        return timed

    def timed_pgo(*args, **kwargs):            # on the worker's stream
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ends[0].record()
        out = run_pgo(*args, **kwargs)
        ends[1].record()
        ends[1].synchronize()
        pgo_ms.append(ends[0].elapsed_time(ends[1]))
        return out

    lc.retrieval.insert_image = host_timed(lc.retrieval.insert_image, index_ms)
    lc.retrieval.detect_loop = host_timed(lc.retrieval.detect_loop, query_ms)
    long_term.run_pgo = timed_pgo
    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    frame_ms, pgo_running = [], []
    try:
        for f in range(LC_FRAMES):
            t = time.perf_counter()
            slam(f, frames[f], intr)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            pgo_running.append(lc.worker is not None and lc.worker.is_alive())
        run_updates = slam.stats["updates"]
        poses, _ = slam.terminate()
        torch.cuda.synchronize()
    finally:
        long_term.run_pgo = run_pgo
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    steady = frame_ms[8:]
    split = {name: [ms for ms, busy in zip(steady, pgo_running[8:]) if busy == want]
             for name, want in (("pgo_worker_running", True), ("no_pgo_worker", False))}
    known = _classic_known_state()
    checks = {
        "lc_attempts": slam.stats["lc_attempts"] > 0,
        "poses_shape": list(poses.shape) == [LC_FRAMES, 7],
        "poses_finite": bool(np.isfinite(poses).all()),
        "every_frame_indexed": len(index_ms) == LC_FRAMES,
        "corr_1_per_update": counts["corr"] == slam.stats["updates"],
        "one_update_per_frame": run_updates == 12 + (LC_FRAMES - 8),
        "attn_12_per_frame": counts["dino_flash_attn"] == 12 * LC_FRAMES,
        **known.pop("checks"),
    }
    ok = all(checks.values())
    emit({"phase": "6-classic", "frames": LC_FRAMES, "keyframes": slam.pg.n,
          "fps": len(steady) / (sum(steady) / 1e3), "fps_phase4": fps_main,
          "fps_frames": {k: {"fps": len(v) / (sum(v) / 1e3) if v else None, "frames": len(v)}
                         for k, v in split.items()},
          "lc_attempts": slam.stats["lc_attempts"], "lc_applied": slam.stats["lc_applied"],
          "loop_pairs": lc.loop_pairs, "last_failure": getattr(lc, "_fail", None),
          "retrieval_ms_per_frame": (sum(index_ms) + sum(query_ms)) / LC_FRAMES,
          "index_ms_median": statistics.median(index_ms),
          "query_ms_median": statistics.median(query_ms) if query_ms else None,
          "pgo_ms": pgo_ms, "loop_edges": slam.stats["loop_edges"],
          "global_ba": slam.stats["global_ba"], "render_s": render_s,
          "launches": counts, "known_state": known, "checks": checks, "card": smi,
          "cuts": {"KEYFRAME_THRESH": 0.0, "MOTION_PROBE_THR": -1.0,
                   "weights": "random (seed 0)", "frames": LC_FRAMES}, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 6-classic: classical loop-closure checks failed: {checks}")
    return counts


KNOWN_N, KNOWN_LOOP = 1000, (985, 5)   # frame 985 revisits frame 5


def _classic_known_state():
    """close_loop on a known 1,000-keyframe state under CLASSIC_LOOP_SYNC, on
    the card and in a float64 CPU run of the port: the correction applied,
    the gap between the two, ms per close_loop and per run_pgo."""
    import torch
    from cdvslam_tpu_torch.loop import long_term
    from cdvslam_tpu_torch.slam import SLAM
    ht, wd = 480, 752
    cfg = _classic_cfg()
    cfg.CLASSIC_LOOP_SYNC = True
    cfg.BUFFER_SIZE = 1024
    t = time.perf_counter()
    state = classic_state(KNOWN_N, cfg.PATCHES_PER_FRAME, ht, wd, EUROC_INTR, KNOWN_LOOP)
    state_s = time.perf_counter() - t
    run_pgo, captured, out = long_term.run_pgo, [], {}

    def capture(*args, **kwargs):
        captured.append(args)
        return run_pgo(*args, **kwargs)

    long_term.run_pgo = capture
    try:
        for side, kwargs in (("card", {}), ("cpu_f64", {"device": "cpu", "dtype": torch.float64})):
            slam = SLAM(cfg, network="cdv", ht=ht, wd=wd, seed=0, **kwargs)
            fill_classic_state(slam, state)
            before = slam.pg.poses_[:KNOWN_N].clone()
            if side == "card":
                torch.cuda.synchronize()
            t = time.perf_counter()
            slam.long_term_lc.close_loop(*KNOWN_LOOP)
            slam.long_term_lc.lc_callback()
            if side == "card":
                torch.cuda.synchronize()
            out[side] = {"ms": (time.perf_counter() - t) * 1e3, "stats": dict(slam.stats),
                         "poses": slam.pg.poses_[:KNOWN_N].double().cpu(),
                         "moved": float((slam.pg.poses_[:KNOWN_N] - before).abs().max()),
                         "fail": getattr(slam.long_term_lc, "_fail", None)}
    finally:
        long_term.run_pgo = run_pgo
    gap = float((out["card"]["poses"] - out["cpu_f64"]["poses"]).abs().max())
    pgo_ms = cuda_time(lambda: run_pgo(*captured[0]), 3, warmup=1) if captured else None
    return {"n": KNOWN_N, "loop": list(KNOWN_LOOP), "state_s": state_s,
            "close_loop_ms": out["card"]["ms"], "close_loop_ms_cpu_f64": out["cpu_f64"]["ms"],
            "run_pgo_ms": pgo_ms, "pgo_rows": int(captured[0][1].shape[0]) if captured else None,
            "max_pose_gap_vs_cpu_f64": gap, "moved": out["card"]["moved"],
            "failure": out["card"]["fail"],
            "checks": {"known_state_applied": all(out[s]["stats"]["lc_applied"] == 1 for s in out),
                       "known_state_moved": out["card"]["moved"] > 1e-2,
                       "known_state_vs_cpu_f64": gap <= 1e-3}}


def _cdvo_pp_cfg(depth_head="random"):
    """get_cfg() merged with config/default_cdvo++.yaml, random seeded heads,
    no motion probe."""
    cfg = _preset("default_cdvo++.yaml")
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


def _dpvo_cfg(strategy=None, loop=False):
    """get_cfg() merged with config/default_dpvo.yaml (RANDOM selection), no
    motion probe; ``strategy`` replaces the selection; ``loop``: the
    proximity loop closure with phase 6's cut, KEYFRAME_THRESH=0."""
    cfg = _preset("default_dpvo.yaml")
    cfg.MOTION_PROBE_THR = -1.0
    if strategy is not None:
        cfg.CENTROID_SEL_STRAT = strategy
    if loop:
        cfg.LOOP_CLOSURE = True
        cfg.KEYFRAME_THRESH = 0.0
    return cfg


def phase8(smi):
    """The DPVO path at 480 x 752 (160 frames), a GRADIENT_BIAS sub-run and
    a DPV-SLAM sub-run; returns the launch counts of the 160-frame run and
    the corr inputs of its last warm-up update and of one loop update."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import kernels as slam_kernels
    WARM, WIN = 60, 100
    frames, intr = _frames()
    kernel = slam_kernels.corr_pyramid_cl
    channels, captured, capture = [], {}, [False]

    def counted(*args):
        channels.append(args[0].shape[1])
        if capture[0]:
            captured["steady"] = tuple(a.clone() for a in args[:6])
        return kernel(*args)

    slam = SLAM(_dpvo_cfg(), network="dpv", ht=480, wd=752, seed=0)
    torch.cuda.reset_peak_memory_stats()
    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    slam_kernels.corr_pyramid_cl = counted
    try:
        t_start = time.perf_counter()
        for f in range(WARM):
            capture[0] = f == WARM - 1   # the last warm-up frame's update (its only one)
            slam(f, frames[f % 8], intr)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t_start
        capture[0] = False
        upd0, corr0 = slam.stats["updates"], corr_cuda.LAUNCHES.count
        t0 = time.perf_counter()
        for f in range(WARM, WARM + WIN):
            slam(f, frames[f % 8], intr)
        torch.cuda.synchronize()
        win_s = time.perf_counter() - t0
        win = {"updates": slam.stats["updates"] - upd0, "corr": corr_cuda.LAUNCHES.count - corr0}
        edges = slam.pg.E
        poses, _ = slam.terminate()
        torch.cuda.synchronize()
    finally:
        slam_kernels.corr_pyramid_cl = kernel
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    frames_run = WARM + WIN
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = dict(slam.stats)
    checks = {
        "poses_shape": list(poses.shape) == [frames_run, 7],
        "poses_finite": bool(np.isfinite(poses).all()),
        "corr_1_per_update": counts["corr"] == stats["updates"] == len(channels)
                             and win["corr"] == win["updates"],
        "corr_at_C128": set(channels) == {128},
        "no_flash_attn": counts["dino_flash_attn"] == 0,
        "one_update_per_frame": win["updates"] == WIN,
        "corr_inputs_captured": "steady" in captured,
    }
    del slam
    torch.cuda.empty_cache()
    gb = _gradient_bias_subrun(frames, intr)
    checks.update(gb.pop("checks"))
    loop = _dpv_slam_subrun(frames, intr)
    checks.update(loop.pop("checks"))
    loop_args = loop.pop("corr_args")
    ok = all(checks.values())
    emit({"phase": 8, "fps": WIN / win_s, "window_s": win_s, "warmup_s": warm_s,
          "frames": frames_run, "updates": stats["updates"],
          "keyframe_removals": stats["keyframe_removals"], "steady_edges": edges,
          "launches": counts, "checks": checks, "card": smi, "peak_mem_gb": peak_gb,
          "gradient_bias_subrun": gb, "dpv_slam_subrun": loop,
          "cuts": {"weights": "random (seed 0)", "frames": frames_run,
                   "dpv_slam": f"KEYFRAME_THRESH=0, {LC_FRAMES} frames"}, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 8: DPVO path checks failed: {checks}")
    return counts, captured["steady"], loop_args, loop["launches"]


def _gradient_bias_subrun(frames, intr, nframes=40):
    """CENTROID_SEL_STRAT="GRADIENT_BIAS" for nframes frames: the selected
    centres' range and the checks."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import runtime
    select, picked = runtime.select_gradient_bias, []

    def recorded(*args):
        coords = select(*args)
        picked.append(torch.stack([coords[..., 0].amin(), coords[..., 0].amax(),
                                   coords[..., 1].amin(), coords[..., 1].amax()]))
        return coords

    slam = SLAM(_dpvo_cfg("GRADIENT_BIAS"), network="dpv", ht=480, wd=752, seed=0)
    runtime.select_gradient_bias = recorded
    try:
        for f in range(nframes):
            slam(f, frames[f % 8], intr)
        poses, _ = slam.terminate()
    finally:
        runtime.select_gradient_bias = select
    xmin, xmax, ymin, ymax = torch.stack(picked).cpu().T
    x_lo, x_hi = float(xmin.min()), float(xmax.max())
    y_lo, y_hi = float(ymin.min()), float(ymax.max())
    return {"frames": nframes, "selections": len(picked), "x_range": [x_lo, x_hi],
            "y_range": [y_lo, y_hi], "keyframe_removals": slam.stats["keyframe_removals"],
            "checks": {
                "gb_poses_finite": bool(np.isfinite(poses).all()),
                "gb_one_selection_per_frame": len(picked) == nframes,
                "gb_centres_inside": x_lo >= 1 and x_hi < slam.wd4 - 1
                                     and y_lo >= 1 and y_hi < slam.ht4 - 1}}


def _dpv_slam_subrun(frames, intr):
    """default_dpvo.yaml with LOOP_CLOSURE=True (phase 6's cut) for
    LC_FRAMES frames: loop edges, global BAs, launches, and the corr inputs
    of the first update that holds loop edges."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam import kernels as slam_kernels
    cfg = _dpvo_cfg(loop=True)
    slam = SLAM(cfg, network="dpv", ht=480, wd=752, seed=0)
    kernel, captured, channels = slam_kernels.corr_pyramid_cl, {}, []

    def capture_corr(*args):
        pg = slam.pg
        channels.append(args[0].shape[1])
        if "corr" not in captured and (pg.ii < pg.n - cfg.REMOVAL_WINDOW - 1).any():
            captured["corr"] = tuple(a.clone() for a in args[:6])
        return kernel(*args)

    torch.cuda.reset_peak_memory_stats()
    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    slam_kernels.corr_pyramid_cl = capture_corr
    peak_E = 0
    try:
        t0 = time.perf_counter()
        for f in range(LC_FRAMES):
            slam(f, frames[f % 8], intr)
            peak_E = max(peak_E, slam.pg.E)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        poses, _ = slam.terminate()
        torch.cuda.synchronize()
    finally:
        slam_kernels.corr_pyramid_cl = kernel
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    return {"frames": LC_FRAMES, "keyframes": slam.pg.n, "fps": LC_FRAMES / run_s,
            "loop_edges": slam.stats["loop_edges"], "global_ba": slam.stats["global_ba"],
            "updates": slam.stats["updates"], "peak_active_edges": peak_E,
            "launches": counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "corr_args": captured.get("corr"),
            "checks": {
                "lc_loop_edges": slam.stats["loop_edges"] > 0,
                "lc_global_ba": slam.stats["global_ba"] > 0,
                "lc_poses_finite": bool(np.isfinite(poses).all()),
                "lc_corr_1_per_update_at_C128": counts["corr"] == slam.stats["updates"]
                                                == len(channels) and set(channels) == {128},
                "lc_no_flash_attn": counts["dino_flash_attn"] == 0,
                "lc_loop_corr_inputs_captured": "corr" in captured}}


def _synthetic_tartan(root, nframes=70, ht=480, wd=640):
    """A TartanAir-format scene tree (one scene of nframes seeded random
    frames, depths 4-5 m, slow forward motion) and its scene-info pickle."""
    import cv2
    import numpy as np
    from cdvslam_tpu_torch.data.tartan import build_scene_info
    scene = root / "office" / "office" / "Easy" / "P001"
    (scene / "image_left").mkdir(parents=True)
    (scene / "depth_left").mkdir(parents=True)
    rng = np.random.RandomState(9)
    poses = []
    for i in range(nframes):
        cv2.imwrite(str(scene / "image_left" / f"{i:06d}_left.png"),
                    (rng.rand(ht, wd, 3) * 255).astype(np.uint8))
        np.save(str(scene / "depth_left" / f"{i:06d}_left_depth.npy"),
                4.0 + rng.rand(ht, wd).astype(np.float32))
        poses.append([0.02 * i, 0.0, 0.01 * i, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(str(scene / "pose_left.txt"), np.asarray(poses), delimiter=" ")
    build_scene_info(str(root), str(root / "TartanAir.pickle"))
    return root / "TartanAir.pickle"


HARNESS_FRAMES = 120    # rendered frames of phase 10


def _render_sequence(root, nframes=HARNESS_FRAMES, ht=480, wd=752):
    """``nframes`` views of the rendered plane (``PlaneScene`` on
    ``loop_path(nframes, nframes - 20)``) written as PNGs (BGR, as cv2
    reads them) with a calibration file and a TUM-format ground truth
    (t x y z qx qy qz qw of the camera-to-world poses, t the frame index,
    which is the image reader's timestamp). Returns (image dir, calib
    path, ground-truth path, frames, seconds)."""
    import cv2
    import numpy as np
    from scipy.spatial.transform import Rotation
    from cdvslam_tpu_torch.data.render import PlaneScene, _pose_rt, loop_path
    t = time.perf_counter()
    scene = PlaneScene(EUROC_INTR, ht, wd, seed=3)
    poses = loop_path(nframes, nframes - 20)
    imagedir = root / "images"
    imagedir.mkdir(parents=True)
    frames = []
    for f, pose in enumerate(poses):
        img = scene.render(pose)
        frames.append(img)
        cv2.imwrite(str(imagedir / f"{f:06d}.png"), img[..., ::-1])
    calib = root / "calib.txt"
    calib.write_text(" ".join(repr(float(x)) for x in EUROC_INTR) + "\n")
    rows = []
    for f, pose in enumerate(poses):
        R, tr = _pose_rt(pose)
        rows.append([f, *(-R.T @ tr), *Rotation.from_matrix(R.T).as_quat()])
    gt = root / "groundtruth.txt"
    np.savetxt(gt, np.asarray(rows))
    return imagedir, calib, gt, frames, time.perf_counter() - t


def _harness_run(cfg, imagedir, calib, version="cdv"):
    """``eval.harness.run_sequence`` on the card with each SLAM call's
    start time recorded (a subclass of the port's SLAM, put where the
    harness looks it up); returns (poses, tstamps, slam, call times, wall
    seconds, launch counts of K1 and K2's bf16 forward)."""
    import torch
    import cdvslam_tpu_torch.slam as slam_pkg
    from cdvslam_tpu_torch.eval.harness import run_sequence
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    calls, base = [], slam_pkg.SLAM

    class Timed(base):
        def __call__(self, *args, **kwargs):
            calls.append(time.perf_counter())
            return super().__call__(*args, **kwargs)

    sink = []
    slam_pkg.SLAM = Timed
    corr_cuda.LAUNCHES.reset()
    flash_attn.LAUNCHES.reset()
    try:
        t = time.perf_counter()
        poses, tstamps = run_sequence(cfg, str(imagedir), str(calib), version=version,
                                      slam_sink=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        slam_pkg.SLAM = base
    counts = {"corr": corr_cuda.LAUNCHES.count, "dino_flash_attn": flash_attn.LAUNCHES.count}
    return poses, tstamps, sink[0], calls, wall, counts


def _steady_fps(calls):
    """FPS over frames 60-119 from each SLAM call's start time."""
    return (len(calls) - 61) / (calls[-1] - calls[60])


def _direct_run(cfg, frames, intr):
    """The same frames from memory, straight into the port's SLAM (no
    reader, no prefetch): FPS over frames 60-119."""
    import torch
    from cdvslam_tpu_torch.slam import SLAM
    slam = SLAM(cfg, "cdv", *frames[0].shape[:2])
    calls = []
    for f, img in enumerate(frames):
        calls.append(time.perf_counter())
        slam(f, img, intr)
    torch.cuda.synchronize()
    slam.terminate()
    return _steady_fps(calls)


def phase10(smi, fps_main):
    """The port's entry points on the card, on 120 rendered frames at
    480 x 752 (``_render_sequence``) with random weights:
    - the demo, ``python -m cdvslam_tpu_torch.demo`` in a subprocess in the
      sequence's directory with ``--save_trajectory --plot --save_ply
      --save_colmap --timeit --opts MOTION_PROBE_THR -1`` (its default
      stride 2): exit 0, its files written, finite poses, its timed sections;
    - the harness, ``eval.harness.run_sequence`` (reader thread, BGR -> RGB,
      SLAM, terminate) with ``config/default_cdvo.yaml`` and
      MOTION_PROBE_THR=-1, then ``evaluate_against_tum_gt``: FPS over frames
      60-119 (phase 4's steady window) beside phase 4's, a finite ATE (no
      accuracy figure: random weights), poses finite, K1 once per update and
      K2 12 times per frame; the reader alone (decode, crop, queue) in ms per
      frame; then the same frames from memory straight into the SLAM, twice,
      and the harness once more (harness, direct, direct, harness), so the
      reader's share of the gap to phase 4 shows in one call;
    - ``config/fast_dpvo.yaml`` through the harness under "dpv" (48 patches,
      KEYFRAME_INDEX 2): poses finite, the keyframe removals counted, K1 at
      C = 128 once per update, K2 never;
    - the web viewer, ``SLAM(viz=True)`` on the card for 40 frames:
      ``state.json`` fetched over loopback with its sizes checked, and
      ``refresh()`` timed (a host sync; it runs every 5th kept frame).
    Returns the harness path's launch counts."""
    import json
    import os
    import queue
    import statistics
    import subprocess
    import tempfile
    import urllib.request
    import numpy as np
    import torch
    from cdvslam_tpu_torch.config import get_cfg
    from cdvslam_tpu_torch.eval.harness import evaluate_against_tum_gt
    from cdvslam_tpu_torch.slam import SLAM
    from cdvslam_tpu_torch.slam.stream import image_stream
    root = Path(tempfile.mkdtemp(prefix="cdv_phase10_"))
    imagedir, calib, gt, frames, render_s = _render_sequence(root)
    ht, wd = frames[0].shape[:2]
    out, checks = {"phase": 10, "render_s": render_s, "frames": HARNESS_FRAMES}, {}

    # the demo, as a user runs it
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cdvslam_tpu_torch.demo", "--imagedir",
                        str(imagedir), "--calib", str(calib), "--name", "phase10",
                        "--save_trajectory", "--plot", "--save_ply", "--save_colmap", "--timeit",
                        "--opts", "MOTION_PROBE_THR", "-1"],
                       cwd=root, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
                       text=True, timeout=300)
    out["demo_s"] = time.perf_counter() - t
    files = {"trajectory": root / "saved_trajectories" / "phase10.txt",
             "plot": root / "trajectory_plots" / "phase10.pdf", "ply": root / "phase10.ply",
             "colmap": root / "colmap_saving" / "phase10" / "points3D.txt"}
    checks["demo_exit_0"] = r.returncode == 0
    checks["demo_files"] = all(f.is_file() and f.stat().st_size > 0 for f in files.values())
    if checks["demo_files"]:
        traj = np.loadtxt(files["trajectory"])
        checks["demo_poses_finite"] = traj.shape == (HARNESS_FRAMES // 2, 8) and bool(
            np.isfinite(traj).all())
    else:
        checks["demo_poses_finite"] = False
    out["demo_timeit"] = [line for line in r.stdout.splitlines() if ": median " in line]
    checks["demo_timeit_sections"] = all(
        any(line.startswith(f"{s}: ") for line in out["demo_timeit"])
        for s in ("SLAM", "patch", "update", "keyframe"))
    if r.returncode != 0:
        out["demo_stderr_tail"] = r.stderr[-3000:]

    # the reader alone
    q = queue.Queue()
    t = time.perf_counter()
    image_stream(q, str(imagedir), str(calib), 1)
    out["reader_ms_per_frame"] = (time.perf_counter() - t) * 1e3 / HARNESS_FRAMES

    # the harness
    cfg = get_cfg().merge_from_file(ROOT / "config" / "default_cdvo.yaml")
    cfg.MOTION_PROBE_THR = -1.0
    poses, tstamps, slam, calls, wall, counts = _harness_run(cfg, imagedir, calib)
    fps = _steady_fps(calls)
    ate = evaluate_against_tum_gt(poses, tstamps, gt)
    intr = np.asarray(EUROC_INTR, np.float32)
    direct = [_direct_run(cfg, frames, intr) for _ in range(2)]
    again = _steady_fps(_harness_run(cfg, imagedir, calib)[3])
    out["harness"] = {"fps_frames_60_119": fps, "fps_main_path_phase4": fps_main,
                      "fps_share_of_phase4": fps / fps_main, "fps_second_run": again,
                      "fps_direct_same_frames": direct,
                      "harness_over_direct": (fps + again) / sum(direct), "wall_s": wall,
                      "fps_wall": HARNESS_FRAMES / wall, "ate_random_weights": ate,
                      "updates": slam.stats["updates"],
                      "keyframe_removals": slam.stats["keyframe_removals"],
                      "launches": counts}
    checks["harness_poses_finite"] = poses.shape == (HARNESS_FRAMES, 7) and bool(
        np.isfinite(poses).all())
    checks["harness_ate_finite"] = bool(np.isfinite(ate))
    checks["harness_corr_1_per_update"] = counts["corr"] == slam.stats["updates"] > 0
    checks["harness_attn_12_per_frame"] = counts["dino_flash_attn"] == 12 * HARNESS_FRAMES

    # fast_dpvo.yaml through the harness under "dpv"
    import cdvslam_tpu_torch.slam.kernels as slam_kernels
    widths = []
    wide = slam_kernels.corr_pyramid_cl

    def width_logged(gmap, *args, **kwargs):
        widths.append(gmap.shape[1])
        return wide(gmap, *args, **kwargs)
    fast = get_cfg().merge_from_file(ROOT / "config" / "fast_dpvo.yaml")
    fast.MOTION_PROBE_THR = -1.0
    slam_kernels.corr_pyramid_cl = width_logged
    try:
        fposes, _, fslam, fcalls, fwall, fcounts = _harness_run(fast, imagedir, calib, "dpv")
    finally:
        slam_kernels.corr_pyramid_cl = wide
    out["fast_dpvo"] = {"keyframe_removals": fslam.stats["keyframe_removals"],
                        "updates": fslam.stats["updates"], "M": fslam.M,
                        "fps_frames_60_119": _steady_fps(fcalls),
                        "launches": fcounts}
    checks["fast_dpvo_poses_finite"] = fposes.shape == (HARNESS_FRAMES, 7) and bool(
        np.isfinite(fposes).all())
    checks["fast_dpvo_corr_c128"] = (fcounts["corr"] == fslam.stats["updates"] == len(widths)
                                    and set(widths) == {128})
    checks["fast_dpvo_no_attn"] = fcounts["dino_flash_attn"] == 0
    checks["fast_dpvo_removed_keyframes"] = fslam.stats["keyframe_removals"] > 0

    # the web viewer on the card
    vcfg = get_cfg()
    vcfg.MOTION_PROBE_THR = -1.0
    vslam = SLAM(vcfg, "cdv", ht, wd, viz=True, viewer_port=0)
    refresh, timed = vslam.viewer.refresh, []

    def refresh_timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        refresh()
        timed.append((time.perf_counter() - t) * 1e3)
    vslam.viewer.refresh = refresh_timed
    for f in range(40):
        vslam(f, frames[f], intr)
    url = f"http://127.0.0.1:{vslam.viewer.port}/state.json"
    state = json.loads(urllib.request.urlopen(url, timeout=10).read())
    vposes, _ = vslam.terminate()
    n = state["n"]
    checks["viewer_state_sizes"] = (
        n >= 2 and len(state["points"]) % 3 == 0 and len(state["points"]) > 0
        and len(state["colors"]) == len(state["points"])
        and len(state["weights"]) == len(state["points"]) // 3
        and len(state["traj"]) == 3 * n and len(state["frustum"]) == 48
        and len(state["kf_frustums"]) == 48 * n and bool(state["image"]))
    checks["viewer_poses_finite"] = bool(np.isfinite(vposes).all())
    out["viewer"] = {"n": n, "points": len(state["points"]) // 3,
                     "refresh_ms": timed, "refresh_ms_median": statistics.median(timed),
                     "refreshes": len(timed)}
    ok = all(checks.values())
    out.update({"checks": checks, "card": smi, "ok": ok,
                "cuts": {"weights": "random (seed 0)",
                         "data": f"{HARNESS_FRAMES} frames of a rendered textured plane at "
                                 f"{ht} x {wd} (PlaneScene, loop_path)",
                         "config": "MOTION_PROBE_THR=-1 (the random network's probe keeps "
                                   "no frame)"}})
    emit(out)
    if not ok:
        raise SystemExit(f"phase 10: entry-point checks failed: {checks}")
    return counts


PROOF_STEPS = 20        # training steps of phase 11 (the proof's own run takes 1,500)
PROOF_L = 415           # DINO tokens of a 240 x 320 frame: 18 x 23 patches and the cls token
PROOF_CORR_CALL = 30    # the trained run's K1 call whose inputs phase 11 holds to plain


def _k2_proof_shape():
    """Each K2 call at the proof's shapes against its plain version: the
    serving call at (1, PROOF_L) in bf16 (phase 2's rule), the training
    calls at (F, PROOF_L) by phase "2-train"'s; with kernel and plain
    times (CUDA events, 5 calls) of the float32 forward, dQ and dK/dV at
    the training shape and of the serving call."""
    import torch
    from cdvslam_tpu_torch.ops import flash_attn as fa
    from cdvslam_tpu_torch.train import e2e_proof
    B = e2e_proof.F
    gen = torch.Generator(device="cuda").manual_seed(11)
    serving = torch.randn((1, PROOF_L, 1152), generator=gen, device="cuda").to(torch.bfloat16)
    checks = {f"serving_B1_L{PROOF_L}": _k2_serving_case(serving, 6)}
    checks[f"train_B{B}_L{PROOF_L}"], errs = _k2_train_case(gen, B, PROOF_L)
    qkv = torch.randn((B, PROOF_L, 1152), generator=gen, device="cuda")
    dout = torch.randn((B, PROOF_L, 384), generator=gen, device="cuda")
    o, lse = fa._forward(qkv, 6, with_lse=True)
    D, dqkv = torch.empty((B, 6, PROOF_L), device="cuda"), torch.empty_like(qkv)
    times = {
        "serving_bf16": (cuda_time(lambda: fa.flash_attention_qkv(serving, 6), 5),
                         cuda_time(lambda: fa.attention_qkv_plain(serving, 6), 5)),
        "fwd_f32": (cuda_time(lambda: fa._forward(qkv, 6, with_lse=True), 5),
                    cuda_time(lambda: fa.attention_qkv_plain(qkv, 6), 5)),
        "dq_f32": (cuda_time(lambda: _bwd_native("dq", qkv, o, lse, dout, D, dqkv), 5), None),
        "dkv_f32": (cuda_time(lambda: _bwd_native("dkv", qkv, o, lse, dout, D, dqkv), 5), None)}
    plain_bwd = cuda_time(lambda: fa.attention_qkv_backward_plain(qkv, o, lse, dout, 6), 5)
    return checks, errs, {k: {"ms": ms, "plain_ms": plain if plain is not None else plain_bwd}
                          for k, (ms, plain) in times.items()}


def phase11(smi):
    """The trained-weights proof (``train.e2e_proof``) on the card: K2 at
    the proof's shapes against plain; PROOF_STEPS float32 training steps
    on the clip pool (every loss finite; 24 float32 K2 forwards per step,
    12 in the rollout's extractor and 12 again under recomputation, and
    12 of each backward kernel; no bf16 K2 and no K1: the rollout takes
    the plain corr); the checkpoint round trip through a temporary
    directory (the weights the SLAM loads equal the trained ones bitwise);
    the SLAM runs over the 40 held-out frames, trained and random at each
    of the evaluation's seeds (the ATEs finite, K1 once per update, K2 bf16
    12 per frame); K1 on the inputs of one update of the trained run
    (PROOF_CORR_CALL, seed 0: pyramids of 60 x 80 and 15 x 20) against
    plain by phase 1's rule, with its times. Returns the launch counts of
    training and of the SLAM runs, K2's times and K1's record."""
    import tempfile
    import numpy as np
    import torch
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn
    from cdvslam_tpu_torch.slam import kernels as slam_kernels
    from cdvslam_tpu_torch.train import e2e_proof
    k2_checks, k2_errs, k2_times = _k2_proof_shape()
    torch.cuda.empty_cache()
    corr_cuda.LAUNCHES.reset()
    flash_attn.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="cdv_proof_") as tmp:
        ckpt = str(Path(tmp) / "e2e_proof.pt")
        t = time.perf_counter()
        model, state, records = e2e_proof.train(PROOF_STEPS, "cuda", ckpt=ckpt)
        train_s = time.perf_counter() - t
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train_counts = {"corr": corr_cuda.LAUNCHES.count, "fwd_bf16": flash_attn.LAUNCHES.count,
                        "fwd_f32": flash_attn.LAUNCHES_F32.count,
                        "bwd_dq": flash_attn.LAUNCHES_DQ.count,
                        "bwd_dkv": flash_attn.LAUNCHES_DKV.count}
        weights = e2e_proof.load_weights(ckpt, "cuda")
    trained = model.state_dict()
    bitwise = list(weights) == list(trained) and all(
        torch.equal(weights[k], trained[k]) for k in trained)
    del model, state, trained
    torch.cuda.empty_cache()
    kernel, calls, captured, slams = slam_kernels.corr_pyramid_cl, [0], [], []

    def capture(*args):
        if not slams:                          # the trained run at the first seed
            calls[0] += 1
            if calls[0] == PROOF_CORR_CALL:
                captured.append(tuple(a.clone() for a in args[:6]))
        return kernel(*args)

    corr_cuda.LAUNCHES.reset()
    flash_attn.reset_counts()
    slam_kernels.corr_pyramid_cl = capture
    try:
        t = time.perf_counter()
        result = e2e_proof.evaluate(weights, "cuda", sink=slams)
        eval_s = time.perf_counter() - t
    finally:
        slam_kernels.corr_pyramid_cl = kernel
    slam_counts = {"corr": corr_cuda.LAUNCHES.count, "fwd_bf16": flash_attn.LAUNCHES.count,
                   "fwd_f32": flash_attn.LAUNCHES_F32.count}
    corr = None
    if captured:
        err, rel, _ = _corr_check(captured[0])
        corr = {"max_abs_err": err, "rel": rel, "E": captured[0][3].shape[0],
                "levels": [tuple(f.shape[1:3]) for f in captured[0][1:3]],
                **_corr_record(captured[0])}
    losses = [r["loss"] for r in records]
    step_ms = [r["ms"] for r in records]
    S, runs = PROOF_STEPS, 2 * len(e2e_proof.EVAL_SEEDS)
    ates = result["ate_trained_seeds"] + result["ate_random_seeds"]
    checks = {
        "k2_proof_shapes": all(c["ok"] for c in k2_checks.values()),
        "losses_finite": len(records) == S and bool(np.isfinite(losses).all()),
        "train_k2_f32_24_per_step": train_counts["fwd_f32"] == 24 * S,
        "train_k2_dq_12_per_step": train_counts["bwd_dq"] == 12 * S,
        "train_k2_dkv_12_per_step": train_counts["bwd_dkv"] == 12 * S,
        "train_no_bf16_k2_no_k1": train_counts["fwd_bf16"] == train_counts["corr"] == 0,
        "checkpoint_round_trip_bitwise": bitwise,
        "ates_finite": len(slams) == runs and len(ates) == runs and bool(
            np.isfinite(ates).all()),
        "slam_corr_1_per_update": slam_counts["corr"] == sum(x.stats["updates"] for x in slams),
        "slam_k2_bf16_12_per_frame": slam_counts["fwd_bf16"] == 12 * runs * e2e_proof.EVAL_FRAMES,
        "corr_on_a_trained_update": corr is not None and corr["rel"] <= 5e-3,
    }
    ok = all(checks.values())
    emit({"phase": 11, "steps": S, "loss_curve": losses, "step_ms": step_ms,
          "step_ms_median_after_2": statistics.median(step_ms[2:]), "train_s": train_s,
          "peak_mem_gb": peak_gb, "result": result, "eval_s": eval_s,
          "updates": [x.stats["updates"] for x in slams],
          "launches_train": train_counts, "launches_slam": slam_counts,
          "k2_proof_shape": {"checks": k2_checks, "max_abs": k2_errs, "times": k2_times},
          "corr_trained_update": corr, "checks": checks, "card": smi,
          "cuts": {"steps": f"{S} (the proof's own run: 1,500)"}, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 11: the proof's checks failed: {checks}")
    return {"train": train_counts, "slam": slam_counts, "k2_times": k2_times, "corr": corr}


def phase12(smi, per_loop=24):
    """The retrieval-recall harness (``eval.lc_recall``) at per_loop frames
    a loop, sigma 0 and 5, on the host (cv2 ORB, the native BoW library):
    the table's rows; recall at sigma 0 and thresh 0.04 above 0."""
    import io
    from cdvslam_tpu_torch.eval import lc_recall
    t = time.perf_counter()
    table = lc_recall.run(per_loop, sigmas=(0.0, 5.0), out=io.StringIO())
    wall = time.perf_counter() - t
    first = next(r for r in table["rows"] if r["sigma"] == 0.0 and r["thresh"] == 0.04)
    checks = {"recall_sigma0_thresh004_above_0": first["recall"] > 0,
              "rows": len(table["rows"]) == 10}
    ok = all(checks.values())
    emit({"phase": 12, **table, "wall_s": wall, "device": "host", "checks": checks,
          "card": smi, "cuts": {"per_loop": f"{per_loop} (the harness's default: 48)",
                                "sigmas": "0 and 5 (the harness's: 0, 2, 5, 10)"}, "ok": ok})
    if not ok:
        raise SystemExit(f"phase 12: the recall harness's checks failed: {checks}")


GROUPS = {"cdv": ("patchify.dino", "patchify.xfeat", "update", "posenc"),
          "dpv": ("patchify.fnet", "patchify.inet", "update")}


def _grad_groups(state, network):
    """After a step's update, Adam's first moment is (1 - b1) times the
    step's gradient: the leaves of each parameter group with a nonzero
    gradient, and each DINO block's qkv projection (the K2 backward's
    input gradient flows through it)."""
    seen = {g: [0, 0] for g in GROUPS[network]}
    qkv = {}
    for (name, _), mu in zip(state.params.items(), state.opt_state.mu):
        nz = bool((mu != 0).any())
        for g in seen:
            if name.startswith(g):
                seen[g][0] += nz
                seen[g][1] += 1
        if name.endswith("attn.qkv.weight"):
            qkv[name] = nz
    return seen, qkv


def phase9(smi):
    """Training at full width on a synthetic TartanAir tree at 480 x 640
    through the training entry point (``train.cli.main``): CDVNet with
    seeded random weights, 3 sparse steps (F 15, M 80, 18 iterations) and 2
    dense steps (F 4, M 1530, 4 iterations) in float32, two sparse steps in
    bf16 (the second a steady one), and one DPVO step (M 96). Each run is
    driven with the kernel counts set to 0 and read after it. Checks: finite
    losses and no NaN skip; K2 launches equal to 12 blocks x 2 (the
    checkpointed extractor runs forward again in the backward pass) forward
    and 12 of each backward kernel per step, none under DPVO; a nonzero
    gradient in every parameter group and in every DINO block's qkv; then
    one small training step (F 4, M 4, 48 x 64) on the card held to the CPU
    port's float32 and float64 runs (``_train_step_card_vs_cpu``). The
    float32 run validates once after its fifth step (``train.cli.validate``
    on the tree's scene, MOTION_PROBE_THR -1): one finite ATE; its peak
    memory is reported apart from the training's."""
    import tempfile
    import numpy as np
    import torch
    from cdvslam_tpu_torch.eval import tartan
    from cdvslam_tpu_torch.ops import flash_attn as fa
    from cdvslam_tpu_torch.train import cli
    tmp = Path(tempfile.mkdtemp(prefix="cdv_train_"))
    t0 = time.perf_counter()
    pickle_path = _synthetic_tartan(tmp / "TartanAir")
    tree_s = time.perf_counter() - t0
    common = ["--datapath", str(tmp / "TartanAir"), "--scene_info", str(pickle_path),
              "--outdir", str(tmp / "checkpoints"), "--logdir", str(tmp / "runs"),
              "--eval_every", "1000000"]
    # the float32 run validates once, after its last step, on the tree's
    # scene: the validation globs --eval_datapath/*/Easy/*, and the
    # trainer's layout is scene/scene/Easy/P
    validation = ["--eval_every", "5", "--eval_datapath", str(tmp / "TartanAir" / "office")]
    runs = {"f32": ("cdv", ["--schedule", "sparse,sparse,sparse,dense,dense", *validation]),
            "bf16": ("cdv", ["--schedule", "sparse,sparse", "--compute_dtype", "bfloat16"]),
            "dpvo": ("dpv", ["--schedule", "sparse"])}
    out, checks = {"phase": 9, "tree_s": tree_s, "runs": {}}, {}
    validate, evaluate, summaries, peaks = cli.validate, tartan.evaluate, [], []

    def evaluate_random_network(datapath, cfg, eargs, **kwargs):
        cfg.MOTION_PROBE_THR = -1.0      # the random network's probe keeps no frame
        return evaluate(datapath, cfg, eargs, **kwargs)

    def validate_logged(*args, **kwargs):
        # the training's peak so far, then the validation's own
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        summaries.append(validate(*args, **kwargs))
        out["validation_s"] = time.perf_counter() - t
        out["validation_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        return summaries[-1]
    cli.validate, tartan.evaluate = validate_logged, evaluate_random_network
    for run, (network, extra) in runs.items():
        fa.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        peaks.clear()
        grads = {}

        def on_step(record, state, network=network):
            grads[record["step"]] = _grad_groups(state, network)

        recs = cli.main([network, *common, *extra], on_step=on_step)
        torch.cuda.synchronize()
        n = len(recs)
        counts = {"fwd_bf16": fa.LAUNCHES.count, "fwd_f32": fa.LAUNCHES_F32.count,
                  "bwd_dq": fa.LAUNCHES_DQ.count, "bwd_dkv": fa.LAUNCHES_DKV.count}
        fwd = "fwd_bf16" if run == "bf16" else "fwd_f32"
        expect = ({fwd: 24 * n, "bwd_dq": 12 * n, "bwd_dkv": 12 * n} if network == "cdv"
                  else {"bwd_dq": 0, "bwd_dkv": 0})
        groups = {step: g for step, (g, _) in grads.items()}
        qkv_ok = all(all(q.values()) and len(q) == (12 if network == "cdv" else 0)
                     for _, q in grads.values())
        checks[f"{run}_losses_finite"] = all(np.isfinite(r["loss"]) and r["nan_skip"] == 0.0
                                             for r in recs)
        checks[f"{run}_k2_launches"] = all(counts[k] == v for k, v in expect.items()) and (
            network == "cdv" or sum(counts.values()) == 0)
        checks[f"{run}_every_group_has_a_gradient"] = all(
            hit > 0 for g in groups.values() for hit, _ in g.values())
        checks[f"{run}_every_dino_qkv_has_a_gradient"] = qkv_ok
        out["runs"][run] = {
            "network": network, "steps": recs, "launches": counts, "expected_launches": expect,
            "peak_mem_gb": max(peaks + [torch.cuda.max_memory_allocated()]) / 1e9,
            "grad_groups_nonzero_of_leaves": groups}
    cli.validate, tartan.evaluate = validate, evaluate
    out["validation"] = summaries
    checks["validation_ran_once_on_the_scene"] = (
        len(summaries) == 1 and summaries[0] is not None
        and bool(np.isfinite(summaries[0].get("office_Easy_P001", np.nan))))
    out["small_card_vs_cpu"] = _train_step_card_vs_cpu()
    checks["small_card_vs_cpu"] = out["small_card_vs_cpu"]["ok"]
    ok = all(checks.values())
    out.update({"checks": checks, "card": smi, "ok": ok,
                "cuts": {"weights": "random (seed 0)",
                         "data": "a synthetic 70-frame TartanAir-format scene at 480 x 640",
                         "steps": "3 sparse + 2 dense float32, 2 sparse bf16, 1 DPVO"}})
    emit(out)
    if not ok:
        raise SystemExit(f"phase 9: training checks failed: {checks}")
    return out


def _train_step_card_vs_cpu():
    """One train-step loss and gradient of a seeded CDVNet on a seeded
    48 x 64 clip (F 4, M 4, MIN_FRAME 3, 3 iterations), twice on the card
    (TF32 off) and on the CPU in float32 and float64, from the same weights
    and draws: the card's loss within 1e-4 of the float64 one, and each
    gradient leaf above 1e-6 of the largest held to its own triangle
    (``leaf_triangle``)."""
    import numpy as np
    import torch
    from cdvslam_tpu_torch.models import CDVNet
    from cdvslam_tpu_torch.train import RolloutConfig, draw, make_loss_fn, trainable
    cfg = RolloutConfig(F=4, M=4, STEPS=3, MIN_FRAME=3, is_cdv=True)
    rng = np.random.RandomState(0)
    batch = {"images": torch.from_numpy((rng.rand(1, 4, 48, 64, 3) * 255).astype(np.float32)),
             "poses": torch.tensor([0, 0, 0, 0, 0, 0, 1.0]).repeat(1, 4, 1),
             "disps": torch.ones(1, 4, 12, 16),
             "intrinsics": torch.tensor([[60.0, 60.0, 32.0, 24.0]])}
    draws = [draw(cfg, 48, 64, torch.Generator().manual_seed(4))]
    res = {}
    for name, dev, dtype in (("cpu64", "cpu", torch.float64), ("cpu32", "cpu", torch.float32),
                             ("card", "cuda", torch.float32), ("card2", "cuda", torch.float32)):
        torch.manual_seed(0)
        model = CDVNet().to(dev, dtype).eval()
        leaves = trainable(model)
        loss, _ = make_loss_fn(model, cfg)({k: v.to(dev, dtype) for k, v in batch.items()},
                                           draws=draws)
        loss.backward()
        res[name] = (loss.item(), {k: t.grad.double().cpu() for k, t in leaves.items()})
    (l64, g64), (l32, _), (lg, _), (lg2, _) = (res[n] for n in ("cpu64", "cpu32", "card", "card2"))
    tri = leaf_triangle(g64, res["cpu32"][1], res["card"][1], res["card2"][1])
    ok = bool(np.isfinite(lg) and np.isfinite(lg2) and abs(lg - l64) <= 1e-4 * abs(l64)
              and abs(lg2 - l64) <= 1e-4 * abs(l64) and tri["ok"])
    return {"loss_cpu64": l64, "loss_cpu32": l32, "loss_card": [lg, lg2], "leaves": tri, "ok": ok}


def leaf_triangle(g64, g32, card, card2, floor=1e-3):
    """Each gradient leaf whose float64 max |g| is above 1e-6 of the largest
    leaf's, held to its own triangle: both card runs' distance from the
    float64 run (max abs over the leaf, over the leaf's max |g|) at most 3x
    that leaf's float32 noise plus ``floor``, where the noise is the larger
    of the CPU float32 run's distance from float64 and the two card runs'
    distance from each other (the card's scatter-adds sum in an order that
    changes from run to run). The damped BA solves amplify float32 rounding
    to 1e-2 of some leaves; a kernel fault shows as a leaf far outside its
    own noise. Returns the worst leaf overall and among DINO's leaves."""
    top = max(g.abs().max().item() for g in g64.values())
    rows, bad = {}, []
    for k, g in g64.items():
        scale = g.abs().max().item()
        if scale < 1e-6 * top:
            continue
        d32, d1, d2, spread = ((a - b).abs().max().item() / scale for a, b in (
            (g32[k], g), (card[k], g), (card2[k], g), (card[k], card2[k])))
        limit = 3 * max(d32, spread) + floor
        rows[k] = {"cpu32": d32, "card": max(d1, d2), "spread": spread, "limit": limit,
                   "use": max(d1, d2) / limit}
        if max(d1, d2) > limit:
            bad.append(k)
    worst = max(rows, key=lambda k: rows[k]["use"])
    dino = max((k for k in rows if ".dino." in k), key=lambda k: rows[k]["use"])
    return {"leaves": len(rows), "floor": floor, "failed": {k: rows[k] for k in bad},
            "worst": {worst: rows[worst]}, "worst_dino": {dino: rows[dino]},
            "max_card_rel": max(r["card"] for r in rows.values()),
            "max_cpu32_rel": max(r["cpu32"] for r in rows.values()), "ok": not bad}


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


def _profile_train(out_dir, dtype="float32"):
    """Three sparse training steps in ``dtype`` through the CLI on phase 9's
    synthetic tree: the second timed untraced, the third under
    torch.profiler (device busy time and idle share against the untraced
    step, launches, K2's kernels, the top kernels and host ops)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cdvslam_tpu_torch.train import cli
    tmp = Path(tempfile.mkdtemp(prefix="cdv_train_prof_"))
    pickle_path = _synthetic_tartan(tmp / "TartanAir")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rec = {}

    def on_step(record, state):
        rec[record["step"]] = record["ms"]
        if record["step"] == 2:
            prof.start()
        elif record["step"] == 3:
            torch.cuda.synchronize()
            prof.stop()

    cli.main(["cdv", "--datapath", str(tmp / "TartanAir"), "--scene_info", str(pickle_path),
              "--outdir", str(tmp / "checkpoints"), "--logdir", str(tmp / "runs"),
              "--schedule", "sparse,sparse,sparse", "--compute_dtype", dtype], on_step=on_step)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_cpu_time_total)[:10]
    name = "f32" if dtype == "float32" else "bf16"
    (out_dir / f"profile_train_step{'' if name == 'f32' else '_bf16'}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60))
    emit({"phase": "profile", "path": f"train_sparse_{name}", "untraced_step_ms": rec[2],
          "traced_step_ms": rec[3], "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / rec[2],
          "kernel_launches": sum(e.count for e in kernels),
          "k2_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in kernels
                    if "flash_" in e.key},
          "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
          "top_host_ops_ms": {e.key[:60]: e.self_cpu_time_total / 1e3 for e in ops}})


def profile_paths(out_dir):
    """The main path (60 warm-up frames), the loop-closure path (100
    warm-up frames: about 78 keyframes past the first loop detection), the
    CDVO++ path and the DPVO path (60 warm-up frames each), 20 frames
    timed and 20 traced each."""
    import torch
    from cdvslam_tpu_torch.config import get_cfg
    from cdvslam_tpu_torch.slam import SLAM
    frames, intr = _frames()
    out_dir.mkdir(parents=True, exist_ok=True)
    main_cfg = get_cfg()
    main_cfg.MOTION_PROBE_THR = -1.0
    for path, network, cfg, warm in (("main", "cdv", main_cfg, 60),
                                     ("loop", "cdv", _loop_cfg(), 100),
                                     ("cdvo_pp", "cdv", _cdvo_pp_cfg(), 60),
                                     ("dpvo", "dpv", _dpvo_cfg(), 60)):
        slam = SLAM(cfg, network=network, ht=480, wd=752, seed=0)
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
    _profile_train(out_dir)
    _profile_train(out_dir, "bfloat16")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="run phase 0 and the profiles of the main, the loop-closure, "
                         "the CDVO++ and the DPVO path only; the tables go to "
                         "DIR/profile_{main,loop,cdvo_pp,dpvo}_path.txt")
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
    train_rec = phase2_train()
    phase3()
    counts, captured, fps_main = phase4(smi)
    f32_counts = phase4_f32(smi)
    main_rec = corr_on_captured(5, captured)
    lc_counts, lc_captured = phase6(smi)
    loop_rec = corr_on_captured("6-corr", lc_captured)
    classic_counts = phase6_classic(smi, fps_main)
    pp_counts = phase7(smi)
    c128_rec = phase1(128, "8-corr", seed=8)
    dpvo_counts, dpvo_captured, dpv_loop_captured, dpv_loop_counts = phase8(smi)
    dpvo_rec = corr_on_captured("8-update", dpvo_captured)
    dpv_loop_rec = corr_on_captured("8-loop-update", dpv_loop_captured)
    train = phase9(smi)
    harness_counts = phase10(smi, fps_main)
    proof = phase11(smi)
    phase12(smi)

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
         "launches_harness_path": harness_counts["corr"],
         "launches_classic_path": classic_counts["corr"],
         "launches_cdvo_pp_path": pp_counts["corr"],
         "launches_proof_slam_runs": proof["slam"]["corr"],
         "launches_proof_training": proof["train"]["corr"],
         "E_proof_update": proof["corr"]["E"], "levels_proof_update": proof["corr"]["levels"],
         "max_abs_err_proof_update": proof["corr"]["max_abs_err"],
         "ms_proof_update": proof["corr"]["ms"],
         "plain_ms_proof_update": proof["corr"]["plain_ms"],
         "bound_ms_proof_update": proof["corr"]["bound_ms"],
         "box_share_proof_update": proof["corr"]["box_share"],
         "E_loop_update": lc_captured[3].shape[0], "ms_loop_update": loop_rec["ms"],
         "plain_ms_loop_update": loop_rec["plain_ms"],
         "bound_ms_loop_update": loop_rec["bound_ms"],
         "box_share_loop_update": loop_rec["box_share"],
         "ms_c128": c128_rec["ms"], "plain_ms_c128": c128_rec["plain_ms"],
         "bound_ms_c128": c128_rec["bound_ms"], "max_abs_err_c128": c128_rec["max_abs_err"],
         "bytes_c128": c128_rec["bytes"], "rounds_ms_c128": c128_rec["rounds_ms"],
         "launches_dpvo_path": dpvo_counts["corr"],
         "launches_dpv_slam_path": dpv_loop_counts["corr"],
         "E_dpvo_update": dpvo_captured[3].shape[0], "ms_dpvo_update": dpvo_rec["ms"],
         "plain_ms_dpvo_update": dpvo_rec["plain_ms"],
         "bound_ms_dpvo_update": dpvo_rec["bound_ms"],
         "box_share_dpvo_update": dpvo_rec["box_share"],
         "E_dpv_loop_update": dpv_loop_captured[3].shape[0],
         "ms_dpv_loop_update": dpv_loop_rec["ms"],
         "plain_ms_dpv_loop_update": dpv_loop_rec["plain_ms"],
         "bound_ms_dpv_loop_update": dpv_loop_rec["bound_ms"],
         "box_share_dpv_loop_update": dpv_loop_rec["box_share"]},
        {"name": "dino_flash_attn", "route": "cuda",
         "source": "cdvslam_tpu_torch/csrc/flash_attn.cu",
         "replaces": "cdvslam_tpu/models/dinov2.py:53",
         "launches": counts["dino_flash_attn"], "max_abs_err": attn_rec["max_abs_err"],
         "ms": attn_rec["ms"], "plain_ms": attn_rec["plain_ms"],
         "bound_ms": max(ops_ms, bytes_ms),
         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
         "library_ms": attn_rec["library_ms"],
         "launches_loop_path": lc_counts["dino_flash_attn"],
         "launches_harness_path": harness_counts["dino_flash_attn"],
         "launches_classic_path": classic_counts["dino_flash_attn"],
         "launches_cdvo_pp_path": pp_counts["dino_flash_attn"],
         "launches_dpvo_path": dpvo_counts["dino_flash_attn"],
         "launches_proof_slam_runs": proof["slam"]["fwd_bf16"],
         "ms_proof_shape": proof["k2_times"]["serving_bf16"]["ms"],
         "plain_ms_proof_shape": proof["k2_times"]["serving_bf16"]["plain_ms"],
         "per": "one call, packed qkv (1, 1891, 1152) bf16 -> (1, 1891, 384); ms and "
                "library_ms are medians of 5 alternating rounds of 20 calls",
         "rounds": attn_rec["rounds"],
         "launches_train_bf16_step": train["runs"]["bf16"]["launches"]["fwd_bf16"],
         "train_shape_bf16_lse": train_rec["times"]["fwd_bf16"],
         "max_abs_err_lse": train_rec["max_abs_err"]["bf16_lse"]},
    ]
    t, runs = train_rec["times"], train["runs"]
    per = ("one call at the sparse training shape, packed qkv (15, 1611, 1152); ms, "
           "plain_ms and library_ms from phase 2-train; launches: phase 9's {} run ({})")
    dq_tpu = ("jax/experimental/pallas/ops/tpu/flash_attention.py:1287 (_flash_attention_bwd_dq, "
              "reached from cdvslam_tpu/models/dinov2.py:69)")
    dkv_tpu = ("jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
               "(_flash_attention_bwd_dkv, reached from cdvslam_tpu/models/dinov2.py:69)")
    for name, key, dt, src, replaces in (
            ("dino_flash_attn_f32", "fwd", "f32", "fwd_f32",
             "cdvslam_tpu/models/dinov2.py:53 (library _flash_attention_impl, "
             "jax/experimental/pallas/ops/tpu/flash_attention.py:589)"),
            ("dino_flash_attn_bwd_dq", "dq", "f32", "bwd_dq", dq_tpu),
            ("dino_flash_attn_bwd_dkv", "dkv", "f32", "bwd_dkv", dkv_tpu),
            ("dino_flash_attn_bwd_dq_bf16", "dq", "bf16", "bwd_dq", dq_tpu),
            ("dino_flash_attn_bwd_dkv_bf16", "dkv", "bf16", "bwd_dkv", dkv_tpu)):
        rec = t[f"{key}_{dt}"]
        run = "float32" if dt == "f32" else "bf16"
        extra = {"status": "redesigned", "share_of_bound": rec["share_of_bound"]}
        if dt == "f32":   # the proof's float32 training (phase 11)
            at = proof["k2_times"][f"{key}_f32"]
            extra.update(launches_proof_training=proof["train"][src],
                         ms_proof_shape=at["ms"], plain_ms_proof_shape=at["plain_ms"])
        if dt == "f32":
            extra.update(bound_fma_ms=rec["bound_fma_ms"],
                         share_of_fma_bound=rec["share_of_fma_bound"])
        if key == "fwd":
            slam = t["fwd_f32_slam"]
            extra.update(
                prepass="flash_f32_split: Q, K and V^T (keys permuted by 8) split into TF32 "
                        "hi and lo parts, a second launch of the same wrapper call",
                launches_f32_slam=f32_counts["dino_flash_attn_f32"],
                ms_slam=slam["ms"], rounds_ms_slam=slam["rounds_ms"],
                plain_ms_slam=slam["plain_ms"], library_ms_slam=slam["library_ms"],
                library_rounds_ms_slam=slam["library_rounds_ms"],
                bound_ms_slam=slam["bound_ms"], share_of_bound_slam=slam["share_of_bound"],
                bound_fma_ms_slam=slam["bound_fma_ms"])
        else:
            extra["backward_both_kernels"] = t[f"bwd_{dt}"]
        kernels.append({
            "name": name, "route": "cuda", "source": "cdvslam_tpu_torch/csrc/flash_attn.cu",
            "replaces": replaces, "launches": runs[dt]["launches"][src],
            "max_abs_err": train_rec["max_abs_err"]["f32" if key == "fwd" else f"bwd_{dt}"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "per": per.format(run, "3 sparse + 2 dense steps" if dt == "f32" else "2 sparse steps"),
            "rounds_ms": rec["rounds_ms"], **extra})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
