#!/usr/bin/env python3
"""Compare the SLAM runtime of this checkout with another one on one card,
in one call.

    python3 runtime_ab.py OTHER [--rounds 2] [--out chiprun_out/runtime_ab]

OTHER is a directory that holds another checkout: for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists (``build/parent``). Both trees run, each in processes of its own:
- the tree's own ``chip_smoke.py`` phases 4, 6, 7 and 8 (the main, loop-
  closure, CDVO++ and DPVO paths with the tree's own checks and FPS
  figures), in turns OTHER, this, this, OTHER, ... (``--rounds`` pairs);
- this checkout's ``chip_smoke.profile_paths`` (the four paths under
  torch.profiler: host ms, device busy ms and idle share, the kernels the
  device ran and the host's launch calls per frame; no training step) on
  each tree's package, in turns OTHER, this.
Each JSON line the runs print is passed on with "tree" ("other" or
"this") and "round" added; each run's whole output goes to
``OUT/<job>_<tree>_<round>.log``. Then the card's name and power limit,
and last a summary line: per tree, each round's FPS of each phase and the
profiles' figures per path. Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parent

PHASES = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as s
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = s.phase0()
s.phase4(smi)
s.phase6(smi)
s.phase7(smi)
s.phase8(smi)
"""

PROFILE = """
import importlib.util, sys, torch
from pathlib import Path
sys.path.insert(0, {tree!r})
spec = importlib.util.spec_from_file_location("smoke_this", {smoke!r})
s = importlib.util.module_from_spec(spec)
spec.loader.exec_module(s)
import cdvslam_tpu_torch
assert Path(cdvslam_tpu_torch.__file__).resolve().parents[1] == Path({tree!r}).resolve()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
s.phase0()
s.profile_paths(Path({out!r}), train=False)
"""


def run_job(job, code, tree, tag, rnd, out, timeout):
    """One process in ``tree``; returns its JSON lines with "phase"."""
    r = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                       text=True, timeout=timeout)
    (out / f"{job}_{tag}_{rnd}.log").write_text(r.stdout + "\n--- stderr ---\n" + r.stderr)
    lines = []
    for line in r.stdout.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "phase" in rec:
            rec.update(tree=tag, round=rnd)
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    if r.returncode != 0:
        raise SystemExit(f"runtime_ab: {job} in the {tag} tree exited {r.returncode}; "
                         f"see {out / f'{job}_{tag}_{rnd}.log'}")
    return lines


def fps_of(rec):
    """The FPS figures of one phase line."""
    if rec["phase"] == 6:
        return {k: v["fps"] for k, v in rec["fps_frames"].items()}
    keys = ("fps", "fps_prefetch_blocks", "fps_plain_blocks")
    out = {k: rec[k] for k in keys if k in rec}
    if rec["phase"] == 8:
        out["dpv_slam_subrun_fps"] = rec["dpv_slam_subrun"]["fps"]
    return out


PROFILE_KEYS = ("wall_ms_per_frame", "device_busy_ms_per_frame", "device_idle_share",
                "kernel_launches_per_frame", "host_launch_calls_per_frame",
                "graph_replays_per_frame", "graph_captures_in_windows", "global_ba_in_windows")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's directory")
    ap.add_argument("--rounds", type=int, default=2, help="pairs of phase runs (default 2)")
    ap.add_argument("--out", type=Path, default=THIS / "chiprun_out" / "runtime_ab")
    args = ap.parse_args()
    other = args.other.resolve()
    if not (other / "chip_smoke.py").is_file() or not (other / "cdvslam_tpu_torch").is_dir():
        print(f"runtime_ab.py: {other} holds no checkout of the port", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("runtime_ab.py: no CUDA device", file=sys.stderr)
        return 2
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"other": other, "this": THIS}
    summary = {tag: {"fps": {}, "profile": {}} for tag in trees}
    order = [t for r in range(args.rounds) for t in (("other", "this") if r % 2 == 0
                                                       else ("this", "other"))]
    for rnd, tag in enumerate(order):
        for rec in run_job("phases", PHASES, trees[tag], tag, rnd, args.out, 1800):
            summary[tag]["fps"].setdefault(str(rec["phase"]), []).append(fps_of(rec))
    for rnd, tag in enumerate(("other", "this")):
        prof_dir = args.out / f"profile_{tag}"
        code = PROFILE.format(tree=str(trees[tag]), smoke=str(THIS / "chip_smoke.py"),
                              out=str(prof_dir))
        for rec in run_job("profile", code, THIS, tag, rnd, args.out, 1800):
            if rec["phase"] == "profile":
                summary[tag]["profile"][rec["path"]] = {k: rec.get(k) for k in PROFILE_KEYS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    print(json.dumps({"runtime_ab": summary, "order": order, "card": smi.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
