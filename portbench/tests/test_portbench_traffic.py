"""The traffic: deterministic per seed, different across seeds, and the
sequence and rate rules of each mix."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import cell
from portbench.yardstick.render import PlaneScene, loop_path, render_batch

SPEC = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
# every mix on file
MIXES = sorted(p.stem for p in (cell.BENCH / "traffic").glob("*.json"))
# EuRoC's ground truth: the pose counts of the sequences the mixes follow
EUROC_POSES = {"MH_01_easy": 3638, "V1_02_medium": 1671}


def frames(seed, n=4):
    s = cell.derive_seeds(seed)
    scene = PlaneScene((57.3, 57.2, 45.9, 31.0), 64, 96, tex_size=256, extent=8.0,
                       seed=s["texture"])
    return render_batch(scene, loop_path(n, 240), "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 3])
def test_same_seed_same_frames(seed):
    assert np.array_equal(frames(seed), frames(seed))


def test_seeds_differ():
    a, b = frames(2**31 + 1), frames(2**31 + 2)
    assert a.shape == (4, 64, 96, 3) and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).mean() > 10


def test_derived_seeds_fit_their_users():
    s = cell.derive_seeds(2**33 + 5)
    assert 0 <= s["texture"] < 2**32 and 0 <= s["picks"] < 2**32
    assert 0 <= s["weights"] < 2**63 and 0 <= s["slam"] < 2**63
    assert s != cell.derive_seeds(2**33 + 6)


def test_render_matches_the_plane_renderer():
    scene = PlaneScene((57.3, 57.2, 45.9, 31.0), 64, 96, tex_size=256, seed=3)
    poses = loop_path(3, 240)
    got = render_batch(scene, poses, "cpu").astype(int)
    want = np.stack([scene.render(p) for p in poses]).astype(int)
    assert np.abs(got - want).max() <= 8 and (np.abs(got - want) > 1).mean() < 0.05


def test_loop_path_repeats_with_its_period():
    p = loop_path(241, 240)
    assert np.allclose(p[0], p[240])


@pytest.mark.parametrize("mix", MIXES)
def test_mix_rules(mix):
    t = json.loads((cell.BENCH / "traffic" / f"{mix}.json").read_text())
    assert t["sequence_frames"] == EUROC_POSES["MH_01_easy"]
    assert t["sequence_frames"] < 4096                   # BUFFER_SIZE never reached
    assert 0 < t["warm_frames"] < t["sequence_frames"]
    lo, hi = t["check_steps"]
    # each sampled step has a step of its SLAM before it, and falls in the
    # window's first sequence (its first 8 frames initialise the SLAM)
    assert 1 <= lo and hi - lo >= t["check_samples"] > 0
    assert hi <= t["sequence_frames"] - 8
    assert (t["source_ht"], t["source_wd"]) == (480, 752)
    assert (cell.BENCH / "drivers" / f"{t['driver']}.py").is_file()
    assert callable(cell.load_driver(t["driver"]).Session)
    assert t["prefetch"] == 1


@pytest.mark.parametrize("mix", MIXES)
def test_the_driver_hands_each_frame_in_an_array_of_its_own(mix):
    """Each frame owns its data, C-contiguous, shares no buffer with
    another, and is bitwise ``render_batch``'s view."""
    t = json.loads((cell.BENCH / "traffic" / f"{mix}.json").read_text())
    t.update(period=5, tex_size=256)
    seeds = cell.derive_seeds(2**31 + 29)
    env = SimpleNamespace(traffic=t, seeds=seeds, device=torch.device("cpu"),
                          cfgspec={"network": "cdv", "ht": 64, "wd": 96, "settings": {}})
    sess = cell.load_driver(t["driver"]).Session(env)
    sess.render()
    got = sess.frames
    assert len(got) == 5
    for k, f in enumerate(got):
        assert f.flags.owndata and f.flags.c_contiguous and f.base is None
        assert not any(np.may_share_memory(f, g) for g in got[k + 1:])
    intr = np.asarray(t["intrinsics"]) * np.array([96 / t["source_wd"], 64 / t["source_ht"]] * 2)
    scene = PlaneScene(intr, 64, 96, tex_size=256, extent=t["extent"], seed=seeds["texture"])
    want = render_batch(scene, loop_path(5, 5), "cpu")
    assert want.dtype == np.uint8 and np.array_equal(np.stack(got), want)
