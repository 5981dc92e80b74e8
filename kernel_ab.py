#!/usr/bin/env python3
"""Time a port kernel against another version of its source on one GPU.

    python3 kernel_ab.py corr OTHER.cu                  # csrc/corr.cu against OTHER.cu
    python3 kernel_ab.py corr OTHER.cu --channels 128   # the same at DPVO's 128 channels
    python3 kernel_ab.py flash_attn OTHER.cu            # csrc/flash_attn.cu against OTHER.cu
    python3 kernel_ab.py flash_attn_bwd OTHER.cu        # the backward kernels, both types

OTHER.cu must export the same C functions as the kernel it stands in for
(``corr_pyramid_forward``; ``flash_attn_qkv_forward``; or
``flash_attn_qkv_backward_dq`` and ``flash_attn_qkv_backward_dkv``). Both
are built with the same nvcc flags and called on the same inputs: corr and
flash_attn at the main-path shape (chip_smoke.py's phase-1 draw for corr, at
24 channels unless ``--channels`` says 128; packed qkv (1, 1891, 1152) bf16
for flash_attn, with SDPA on the same tensor beside them), in 10 rounds of
30 calls whose order alternates; flash_attn_bwd at the sparse training
shape (packed qkv (15, 1611, 1152)) in float32 and in bf16, one call being
dQ then dK/dV through the two C entry points on the current forward's
output and log-sum-exp, with SDPA's backward (dq, dk and dv of one
forward) on the same tensors beside them, in 10 rounds of 5 calls. Prints
one JSON line: the card, the max difference between the two outputs (per
type for flash_attn_bwd: of dqkv), the median ms of each and every round.
Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=("corr", "flash_attn", "flash_attn_bwd"))
    ap.add_argument("other", type=Path, help="the other version's .cu source")
    ap.add_argument("--channels", type=int, choices=(24, 128), default=24,
                    help="corr only: the channel count of gmap and the fmaps")
    args = ap.parse_args()
    name, other = args.kernel, args.other.resolve()
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from cdvslam_tpu_torch.ops import corr_cuda, flash_attn, native
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 2
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = native.BUILD_DIR / f"ab_{name}_{other.stem}.so"
    subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", str(so), str(other)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if name == "flash_attn_bwd":
        print(json.dumps({"kernel": name, "other": other.name, "card": smi,
                          **backward_ab(lib)}))
        return 0
    symbol = {"corr": "corr_pyramid_forward", "flash_attn": "flash_attn_qkv_forward"}[name]
    fn = getattr(lib, symbol)
    fn.argtypes = native.SIGNATURES[name][symbol]
    fn.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    if name == "corr":
        gen = torch.Generator(device="cuda").manual_seed(1)
        inputs = cs._corr_inputs(gen, torch.bfloat16, C=args.channels)
        g, f1, f2, c, ii, jj = inputs

        def other_fn():
            out = torch.empty((c.shape[0], 7, 7, 3, 3, 2), dtype=g.dtype, device="cuda")
            native.check(fn(g.data_ptr(), f1.data_ptr(), f2.data_ptr(), c.data_ptr(),
                            ii.data_ptr(), jj.data_ptr(), out.data_ptr(), c.shape[0],
                            g.shape[0], f1.shape[0], g.shape[1], f1.shape[1], f1.shape[2],
                            f2.shape[1], f2.shape[2], 1, stream()), symbol)
            return out
        fns = {"current": lambda: corr_cuda.corr_pyramid_cl(*inputs), "other": other_fn}
    else:
        B, h, L, d = cs.ATTN_SHAPE
        gen = torch.Generator(device="cuda").manual_seed(2)
        qkv = torch.randn((B, L, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)

        def other_fn():
            out = torch.empty((B, L, h * d), dtype=qkv.dtype, device="cuda")
            native.check(fn(qkv.data_ptr(), out.data_ptr(), B, L, h, d ** -0.5, stream()),
                         symbol)
            return out
        fns = {"current": lambda: flash_attn.flash_attention_qkv(qkv, h), "other": other_fn,
               "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)}

    diff = (fns["current"]().float() - fns["other"]().float()).abs().max().item()
    print(json.dumps({"kernel": name, "other": other.name, "card": smi, "max_abs_diff": diff,
                      "channels": args.channels if name == "corr" else None,
                      **alternate(fns, 30)}))
    return 0


def alternate(fns, reps, warmup=2):
    """Time each callable of ``fns`` in 10 rounds of ``reps`` calls whose
    order alternates: {"median_ms": {name: ms}, "rounds_ms": {name: [ms]}}."""
    import chip_smoke as cs
    rounds = {key: [] for key in fns}
    for i in range(10):
        for key in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            rounds[key].append(cs.cuda_time(fns[key], reps, warmup=warmup))
    return {"median_ms": {key: statistics.median(ms) for key, ms in rounds.items()},
            "rounds_ms": rounds}


def backward_ab(lib):
    """dQ then dK/dV of the current source and of ``lib`` at the sparse
    training shape, in float32 and bf16, with SDPA's backward beside them:
    {"shape": ..., "f32": {...}, "bf16": {...}}, each type with the max
    difference of dqkv between the sources, medians and rounds."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from cdvslam_tpu_torch.ops import flash_attn, native
    for sym in ("flash_attn_qkv_backward_dq", "flash_attn_qkv_backward_dkv"):
        getattr(lib, sym).argtypes = native.SIGNATURES["flash_attn"][sym]
        getattr(lib, sym).restype = ctypes.c_int
    mine = native.load("flash_attn")
    B, h, L, d = cs.TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {"shape": {"B": B, "heads": h, "L": L, "d": d},
           "per": "one call: dQ then dK/dV; sdpa: one backward of SDPA (dq, dk, dv); "
                  "10 alternating rounds of 5 calls"}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        qkv = torch.randn((B, L, 3 * h * d), generator=gen, device="cuda").to(dtype)
        dout = torch.randn((B, L, h * d), generator=gen, device="cuda").to(dtype)
        out, lse = flash_attn._forward(qkv, h, with_lse=True)
        D = torch.empty((B, h, L), device="cuda")

        def run(which):
            dqkv = torch.empty_like(qkv)
            for kernel in ("dq", "dkv"):
                cs._bwd_native(kernel, qkv, out, lse, dout, D, dqkv, lib=which)
            return dqkv

        q, k, v = (t.detach().requires_grad_(True) for t in
                   qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        sd_out = F.scaled_dot_product_attention(q, k, v)
        sd_dout = dout.reshape(B, L, h, d).transpose(1, 2)
        fns = {"current": lambda: run(mine), "other": lambda: run(lib),
               "sdpa": lambda: torch.autograd.grad(sd_out, (q, k, v), sd_dout,
                                                   retain_graph=True)}
        diff = (run(mine).float() - run(lib).float()).abs().max().item()
        res[key] = {"max_abs_diff": diff, **alternate(fns, 5, warmup=1)}
        del qkv, dout, out, lse, D, q, k, v, sd_out
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(main())
