"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check against the reference.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is data found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` (whose ``read(ctx)``
returns the metric's value, or None where the run gave it nothing to read).
A traffic file names its driver, ``drivers/<driver>.py``, whose ``Session``
makes the inputs and drives the program:

- ``setup()`` makes weights and inputs from the seed and warms every shape
  the window uses (``env.mark(name)`` times its phases); returns a dict
  for the set-up's line;
- ``window(seconds)`` runs the measured window; returns ``attempted``,
  ``failed``, ``values`` (the end-to-end metrics it measures, by name) and
  ``log`` (the window's line);
- ``trace()`` (a ``--trace 1`` run) profiles a span after the window and
  returns ``yardstick.profile.summarize``'s dict;
- ``context()`` is what the per-layer readers read;
- ``release()`` frees the program's state;
- ``check(control)`` returns (checks, readings, control readings): each
  check a dict ``value``, ``limit``, correct where ``value <= limit``.

This file adds ``setup_s`` and ``peak_mem_gb`` to the driver's values.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cdvslam_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload):
    """The workload entry, its configuration and traffic files, and the
    end-to-end and per-layer metric entries that the cell reports."""
    spec = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg = load_json(BENCH / "configs" / f"{wl['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return wl, cfg, traffic, e2e, layer


def derive_seeds(seed):
    """Independent sub-seeds of ``--seed`` (any non-negative integer): the
    weights (63 bits), the texture (32), the SLAM's patch draws (63) and the
    sampled steps (32)."""
    s = np.random.SeedSequence(seed).generate_state(6, dtype=np.uint32).astype(np.int64)
    return {"weights": int(s[0] << 31 | s[1] >> 1), "texture": int(s[2]),
            "slam": int(s[3] << 31 | s[4] >> 1), "picks": int(s[5])}


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def smi():
    """The card's name, power limit, clocks, temperature and draw, as
    nvidia-smi reads them (None where it cannot)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
                            "temperature.gpu,power.draw", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() or None


def _load(kind, name):
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}",
                                                  BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name):
    return _load("metrics", name).read


def load_driver(name):
    return _load("drivers", name)


def run(workload, seed, seconds, trace, t_start=None, device=None, shrink=None,
        slam_hook=None, log=None, control=False):
    """One run of ``workload``: returns (result, checks), the result being
    the dict of the last line of output (without "checks"). ``device``: the
    card when None. ``shrink`` (tests on the CPU): keys of the configuration
    (``settings``, ``ht``, ``wd``) and of the traffic to replace.
    ``slam_hook(slam)`` is called on every new SLAM before it runs.
    ``log(obj)`` takes the earlier lines. ``control`` (``calibrate.py``,
    never a benchmark run): also log the numbers of the control, the
    reference in float8 with TF32 in the program's place, on the same
    sampled steps."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda obj: print(json.dumps(obj), flush=True))
    wl, cfgspec, traffic, e2e, layer = cell_spec(workload)
    shrink = shrink or {}
    cfgspec = dict(cfgspec, **{k: v for k, v in shrink.items() if k in ("ht", "wd")})
    cfgspec["settings"] = dict(cfgspec["settings"], **shrink.get("settings", {}))
    traffic = dict(traffic, **shrink.get("traffic", {}))

    import torch
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    phases = {"import": time.perf_counter() - t_start}

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    if cuda:
        from cdvslam_tpu_torch.ops import native
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        mark("cuda_context")
        native.build()
        mark("kernel_build")
    env = SimpleNamespace(cfgspec=cfgspec, traffic=traffic, seeds=derive_seeds(seed),
                          device=dev, mark=mark, hook=slam_hook)
    sess = load_driver(traffic["driver"]).Session(env)
    info = sess.setup()
    # what set-up made lives to the end: out of the collector's way
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log({"setup": {"seconds": setup_s, "phases_s": phases, **info,
                   "threads": torch.get_num_threads(), "cpus": len(os.sched_getaffinity(0)),
                   "card": smi() if cuda else None}})

    win = sess.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prof = sess.trace() if trace else None
    ctx = sess.context()
    ctx.update(profile=prof, peaks=load_json(BENCH / "yardstick" / "peaks.json"))
    log({"window": {**win["log"], **ctx.get("log", {}), "card": smi() if cuda else None}})
    metrics = {}
    if trace:
        for m in layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(win["values"], peak_mem_gb=peak / 1e9, setup_s=setup_s)
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    del ctx
    sess.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, readings, ctrl = sess.check(control)
    log({"readings": readings})
    if ctrl is not None:
        log({"control_readings": ctrl})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": wl["chips"], "memory_peak_bytes": int(peak)}}
    if prof is not None:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["traced_wall_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    return result, checks
