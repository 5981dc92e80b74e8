"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload cdvo.euroc-stream --seed 7 --seconds 20 --trace 0

The cell is a ``workloads`` entry of ``BENCHMARK.json``. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also end standard
error. Earlier lines carry what the run saw besides (set-up phases, graph keys,
captures, each sequence's start, end and steady seconds, frames and host
and wait seconds per 5 s, the card's power limit and clocks). It exits non-zero without a result when there is
no card, fewer cards than the cell asks for, or when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import cell

    wl = cell.cell_spec(args.workload)[0]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks = cell.run(args.workload, args.seed, args.seconds, args.trace,
                              t_start=T_START)
    found = cell.forbidden_modules()
    if found:
        print(f"portbench: loaded modules of {found}: the run is refused", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
