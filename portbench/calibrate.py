"""Readings that the limits of ``correct`` are set from: for each seed, one
short run of a cell with the numbers of the program and of the control
(the reference in float8 with TF32 in the program's place) on the same
sampled steps, all in one process.

    python3 portbench/calibrate.py cdvo.euroc-stream --seconds 4 --seeds 1 2 3 [--out F]

Prints one JSON line per run ({"seed", "readings", "control_readings"})
and writes them all to ``--out`` when given.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import cell
    rows = []
    for seed in args.seeds:
        got = {"seed": seed}

        def log(obj, got=got):
            for key in ("readings", "control_readings", "window"):
                if key in obj:
                    got[key] = obj[key]

        result, checks = cell.run(args.workload, seed, args.seconds, 0, log=log, control=True)
        got["correct"], got["checks"] = result["correct"], checks
        got["metrics"] = result["metrics"]
        print(json.dumps(got), flush=True)
        rows.append(got)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
