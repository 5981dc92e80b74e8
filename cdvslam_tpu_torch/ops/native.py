"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, into ``build/kernels/`` at the root of the
checkout, and the library's file name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.
``build()`` starts one ``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel library: {symbol: argtypes}
SIGNATURES = {
    "corr": {"corr_pyramid_forward": [_P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "flash_attn": {"flash_attn_qkv_forward": [_P, _P, _I, _I, _I, ctypes.c_float, _P],
                   "flash_attn_qkv_forward_lse": [_P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
                   "flash_attn_qkv_forward_f32": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                                                  _P],
                   "flash_attn_f32_rows": [_I],
                   "flash_attn_bwd_f32_rows": [_I],
                   "flash_attn_qkv_backward_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                                  ctypes.c_float, _I, _P],
                   "flash_attn_qkv_backward_dkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                                   ctypes.c_float, _I, _P]},
    "trace": {"trace_stamp": [_P, _P, _I, _I, _I, _I, _P],
              "trace_ticks": [_P, _I, _P]},
    "segsum": {"segment_sum_forward": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "ba_edges": {"ba_linearize_forward": [_P] * 9 + [_I, _I] + [ctypes.c_float] * 3 + [_P] * 6,
                 "ba_update_forward": [_P] * 6 + [_I] * 4 + [_P] * 3},
}

_loaded: dict[str, ctypes.CDLL] = {}
# every LaunchCounter, for code that replays recorded launches (a CUDA graph)
COUNTERS: list = []


class LaunchCounter:
    """Number of kernel launches a wrapper has made (reset by callers)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        COUNTERS.append(self)

    def reset(self):
        self.count = 0


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Build the named kernel libraries (all by default) in parallel.

    Returns {name: {"seconds": build time or 0.0 if cached, "log": ptxas
    report}}. Raises with nvcc's output if any build fails.
    """
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    result = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            result[name] = {"seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        result[name] = {"seconds": secs, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for sym, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
