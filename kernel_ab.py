#!/usr/bin/env python3
"""Time a port kernel against another version of its source on one GPU.

    python3 kernel_ab.py corr OTHER.cu                  # csrc/corr.cu against OTHER.cu
    python3 kernel_ab.py corr OTHER.cu --channels 128   # the same at DPVO's 128 channels
    python3 kernel_ab.py flash_attn OTHER.cu            # csrc/flash_attn.cu against OTHER.cu
    python3 kernel_ab.py flash_attn_bwd OTHER.cu        # the backward kernels, both types
    python3 kernel_ab.py flash_attn_f32 OTHER.cu        # the float32 forward

OTHER.cu must export the same C functions as the kernel it stands in for
(``corr_pyramid_forward``; ``flash_attn_qkv_forward``;
``flash_attn_qkv_backward_dq`` and ``flash_attn_qkv_backward_dkv``, with
their scratch argument where OTHER.cu also exports
``flash_attn_bwd_f32_rows``, without it where it does not; or
``flash_attn_qkv_forward_f32``, with its scratch argument where OTHER.cu
also exports ``flash_attn_f32_rows``, without it where it does not). Both
are built with the same nvcc flags and called on the same inputs: corr and
flash_attn at the main-path shape (chip_smoke.py's phase-1 draw for corr, at
24 channels unless ``--channels`` says 128; packed qkv (1, 1891, 1152) bf16
for flash_attn, with SDPA on the same tensor beside them), in 10 rounds of
30 calls whose order alternates; flash_attn_bwd at the sparse training
shape (packed qkv (15, 1611, 1152)) in float32 and in bf16, one call being
dQ then dK/dV through the two C entry points on the current forward's
output and log-sum-exp, with SDPA's backward (dq, dk and dv of one
forward) on the same tensors beside them, in 10 rounds of 5 calls;
flash_attn_f32 at the training shape (10 rounds of 5 calls) and the SLAM
shape (1, 1891) (10 rounds of 30), one call being the forward with the
log-sum-exp, with SDPA's float32 forward beside them. Prints one JSON line:
the card, the max difference between the two outputs (per type for
flash_attn_bwd: of dqkv; per shape for flash_attn_f32: of the output and of
the log-sum-exp), the median ms of each and every round; flash_attn_f32
adds each output's error against float64 (of the current source, OTHER.cu
and SDPA) and the device ms of each kernel the current call launches (the
pre-pass and the main kernel, by torch.profiler); flash_attn_bwd adds, in
float32, each source's dqkv error against the formula in float64 (max
|error| over max |float64|, of dqkv and of each of its q, k and v slots)
and the device ms of each kernel the current call launches (the pre-pass,
dQ and dK/dV).
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
    ap.add_argument("kernel", choices=("corr", "flash_attn", "flash_attn_bwd", "flash_attn_f32"))
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
    if name in ("flash_attn_bwd", "flash_attn_f32"):
        ab = backward_ab if name == "flash_attn_bwd" else forward_f32_ab
        print(json.dumps({"kernel": name, "other": other.name, "card": smi, **ab(lib)}))
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
    difference of dqkv between the sources, medians and rounds; float32
    adds each source's dqkv error against the formula in float64 and the
    device ms of each kernel the current call launches."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from cdvslam_tpu_torch.ops import flash_attn, native
    # the three-pass source's entry points take a scratch (the sixth or
    # seventh argument); a source without flash_attn_bwd_f32_rows takes none
    with_ws = hasattr(lib, "flash_attn_bwd_f32_rows")
    for sym, at in (("flash_attn_qkv_backward_dq", 6), ("flash_attn_qkv_backward_dkv", 5)):
        args = native.SIGNATURES["flash_attn"][sym]
        getattr(lib, sym).argtypes = args if with_ws else args[:at] + args[at + 1:]
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
        ws = flash_attn.backward_scratch(qkv, h)

        def run(which):
            dqkv = torch.empty_like(qkv)
            scratch = ws if which is mine or with_ws else False
            for kernel in ("dq", "dkv"):
                cs._bwd_native(kernel, qkv, out, lse, dout, D, dqkv, lib=which, ws=scratch)
            return dqkv

        q, k, v = (t.detach().requires_grad_(True) for t in
                   qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        sd_out = F.scaled_dot_product_attention(q, k, v)
        sd_dout = dout.reshape(B, L, h, d).transpose(1, 2)
        fns = {"current": lambda: run(mine), "other": lambda: run(lib),
               "sdpa": lambda: torch.autograd.grad(sd_out, (q, k, v), sd_dout,
                                                   retain_graph=True)}
        d_mine, d_other = run(mine), run(lib)
        res[key] = {"max_abs_diff": (d_mine.float() - d_other.float()).abs().max().item()}
        if key == "f32":
            want = cs._bwd_float64(qkv, dout)
            scale = want.abs().max().item()
            res[key]["vs_float64"] = {
                name: {"dqkv_max_rel": (d.double() - want).abs().max().item() / scale,
                       **{f"{part}_max_rel": (d.double() - want).reshape(B, L, 3, -1)[:, :, i]
                          .abs().max().item() / scale for i, part in enumerate("qkv")}}
                for name, d in (("current", d_mine), ("other", d_other))}
            del want
        del d_mine, d_other
        torch.cuda.empty_cache()
        res[key].update(alternate(fns, 5, warmup=1))
        if key == "f32":
            res[key]["current_launch_ms"] = launch_times(fns["current"], 5)
        del qkv, dout, out, lse, D, ws, q, k, v, sd_out
        torch.cuda.empty_cache()
    return res


def launch_times(fn, reps):
    """Device ms per launch of each kernel that ``fn`` launches, by
    torch.profiler over ``reps`` calls: {kernel name: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count}


def _errors_vs_float64(qkv, h, outs):
    """Each output (and log-sum-exp) against attention in float64 on the
    same values: max |error| over max |float64|, and the mean signed error
    along the float64 value's sign over the mean |float64| (below 0: the
    output leans toward zero)."""
    import torch
    from cdvslam_tpu_torch.ops import flash_attn
    x = qkv.double()
    B, L, C3 = x.shape
    o64 = flash_attn.attention_qkv_plain(x, h)
    q, k, _ = x.reshape(B, L, 3, h, C3 // 3 // h).permute(2, 0, 3, 1, 4).unbind(0)
    l64 = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
    res = {}
    for name, (o, lse) in outs.items():
        e = o.double() - o64
        res[name] = {"out_max_rel": (e.abs().max() / o64.abs().max()).item(),
                     "out_mean_signed": ((e * o64.sign()).mean() / o64.abs().mean()).item()}
        if lse is not None:
            res[name]["lse_max_rel"] = ((lse.double() - l64).abs().max() / l64.abs().max()).item()
    return res


def forward_f32_ab(lib):
    """The float32 forward with the log-sum-exp, of the current source and
    of ``lib``, with SDPA's float32 forward beside them, at the training and
    the SLAM shape: {"train": {...}, "slam": {...}}, each with the max
    differences of the output and the log-sum-exp, each one's errors
    against float64, medians and rounds, and the device ms of each launch
    of the current call."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from cdvslam_tpu_torch.ops import flash_attn, native
    fn = lib.flash_attn_qkv_forward_f32
    with_ws = hasattr(lib, "flash_attn_f32_rows")   # the three-pass source takes a scratch
    args = native.SIGNATURES["flash_attn"]["flash_attn_qkv_forward_f32"]
    fn.argtypes = args if with_ws else args[:3] + args[4:]
    fn.restype = ctypes.c_int
    res = {"per": "one call: the forward with the log-sum-exp; sdpa: SDPA's float32 forward; "
                  "10 alternating rounds"}
    for key, (B, h, L, d), reps in (("train", cs.TRAIN_SHAPE, 5), ("slam", cs.ATTN_SHAPE, 30)):
        gen = torch.Generator(device="cuda").manual_seed(9)
        qkv = torch.randn((B, L, 3 * h * d), generator=gen, device="cuda")
        q, k, v = qkv.reshape(B, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)

        def other_fn():
            out = torch.empty((B, L, h * d), device="cuda")
            lse = torch.empty((B, h, L), device="cuda")
            ptrs = [qkv.data_ptr(), out.data_ptr(), lse.data_ptr()]
            if with_ws:
                rows = lib.flash_attn_f32_rows(L)
                ws = torch.empty(6 * B * h * rows * d, device="cuda")
                ptrs.append(ws.data_ptr())
            stream = torch.cuda.current_stream().cuda_stream
            native.check(fn(*ptrs, B, L, h, d ** -0.5, stream), "flash_attn_qkv_forward_f32")
            return out, lse

        fns = {"current": lambda: flash_attn._forward(qkv, h, with_lse=True),
               "other": other_fn, "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)}
        (o1, l1), (o2, l2) = fns["current"](), fns["other"]()
        sd = fns["sdpa"]().transpose(1, 2).reshape(B, L, h * d)
        res[key] = {"shape": {"B": B, "heads": h, "L": L, "d": d},
                    "max_abs_diff_out": (o1 - o2).abs().max().item(),
                    "max_abs_diff_lse": (l1 - l2).abs().max().item(),
                    "vs_float64": _errors_vs_float64(qkv, h, {"current": (o1, l1),
                                                              "other": (o2, l2),
                                                              "sdpa": (sd, None)}),
                    **alternate(fns, reps, warmup=1),
                    "current_launch_ms": launch_times(fns["current"], reps)}
        del qkv, q, k, v, o1, l1, o2, l2, sd
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    sys.exit(main())
