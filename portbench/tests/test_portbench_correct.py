"""The check that decides ``correct`` fails where it should: a run on the
CPU at 64 x 96 with 8 patches drives the cell as a benchmark run does (past
its look for a card), with the timed step broken underneath or the host's
index rows broken above it, and with the control (the reference in float8,
TF32 allowed) in the program's place.
On the card: one short run of each cell reads correct."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import cell
from portbench.ref.slam.kernels import BLOCK_ROWS, SCALARS

SHRINK = {"ht": 64, "wd": 96, "settings": {"PATCHES_PER_FRAME": 8},
          "traffic": {"period": 24, "warm_frames": 16, "check_steps": [2, 5], "check_samples": 2,
                      "sequence_frames": 40, "profile_frames": 3, "tex_size": 256}}
SEED = 2**31 + 101


def unchanged(slam):
    """The step leaves the state as it found it."""
    orig = slam.fused.run

    def run(key, frame, ints, floats):
        st = slam.pg.state()
        saved = {k: v.clone() for k, v in st.items()}
        out = orig(key, frame, ints, floats)
        for k, v in st.items():
            v.copy_(saved[k])
        return out
    slam.fused.run = run


def half_edges(slam):
    """The update leaves the second half of the real edges out (masked):
    the BA and the operator's sums run over the rest."""
    orig = slam.fused.run

    def run(key, frame, ints, floats):
        E_pad = key.E_pad
        rows = ints[: len(BLOCK_ROWS) * E_pad].reshape(len(BLOCK_ROWS), E_pad).copy()
        mask = rows[BLOCK_ROWS.index("mask")]
        real = int(mask.sum())
        mask[real // 2: real] = 0
        return orig(key, frame, np.concatenate([rows.reshape(-1), ints[-len(SCALARS):]]),
                    floats)
    slam.fused.run = run


def altered(slam):
    """The newest frame's pose is altered where the step produces it."""
    orig = slam.fused.run

    def run(key, frame, ints, floats):
        out = orig(key, frame, ints, floats)
        n = int(ints[-len(SCALARS) + SCALARS.index("n")])
        slam.pg.poses_[n, 0] += 0.05
        return out
    slam.fused.run = run


def _rows(slam, change):
    """``change(rows, ii, jj)`` applied to the int rows that the runtime's
    ``_prepare_update`` hands on (after its cache of shift-invariant rows),
    so the tap and both sides see the broken rows."""
    orig = slam._prepare_update

    def prepare(ii, jj, kk, E_pad, net_src):
        k0, KWIN, rows = orig(ii, jj, kk, E_pad, net_src)
        if slam.is_initialized:
            rows = rows.copy()
            change(rows, len(ii))
        return k0, KWIN, rows
    slam._prepare_update = prepare


def segments_stale(slam):
    """The cached group segment row is off by one edge: each edge sums
    into its neighbour's (i, j) group."""
    def change(rows, E):
        g = BLOCK_ROWS.index("gseg")
        rows[g, :E] = np.roll(rows[g, :E], 1)
    _rows(slam, change)


def net_src_shuffled(slam):
    """Edges that carry a hidden state take their neighbour's."""
    def change(rows, E):
        r = rows[BLOCK_ROWS.index("net_src")]
        old = np.nonzero(r[:E] >= 0)[0]
        r[old] = np.roll(r[old], 1)
    _rows(slam, change)


def _run(workload, hook=None, **kw):
    return cell.run(workload, SEED, 0.1, 0, device="cpu", shrink=SHRINK, slam_hook=hook,
                    log=lambda obj: None, **kw)


@pytest.mark.parametrize("workload", ["cdvo.euroc-stream", "dpvo.euroc-stream"])
def test_a_sound_step_is_correct(workload):
    result, checks = _run(workload)
    assert checks["missing_samples"]["value"] == 0
    assert result["correct"], checks


@pytest.mark.parametrize("workload", ["cdvo.euroc-stream", "dpvo.euroc-stream"])
@pytest.mark.parametrize("fault", [unchanged, half_edges, altered, segments_stale,
                                   net_src_shuffled])
def test_a_broken_step_is_not_correct(workload, fault):
    result, checks = _run(workload, fault)
    assert checks["missing_samples"]["value"] == 0
    assert not result["correct"], checks


@pytest.mark.parametrize("workload", ["cdvo.euroc-stream", "dpvo.euroc-stream"])
def test_the_control_fails_a_limit(workload):
    got = {}

    def log(obj):
        got.update(obj)
    cell.run(workload, SEED, 0.1, 0, device="cpu", shrink=SHRINK, log=log, control=True)
    limits = cell.load_json(cell.BENCH / "configs" / f"{cell.cell_spec(workload)[0]['config']}"
                            ".json")["limits"]
    assert limits and any(got["control_readings"][k] > v for k, v in limits.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cell.load_json(cell.ROOT / "BENCHMARK.json")["workloads"]])
def test_a_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, str(cell.BENCH / "run.py"), "--workload", workload,
                          "--seed", str(SEED), "--seconds", "8", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=cell.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
    assert torch.cuda.is_available()
