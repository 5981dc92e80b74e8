"""Package rules of the port: no JAX, the card by default, configs
outside the ported slice refused, and the heads' set-up rules."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cdvslam_tpu_torch.config import get_cfg
from cdvslam_tpu_torch.slam import SLAM

torch.set_num_threads(2)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import cdvslam_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "cdvslam_tpu"))
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 20 else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    # sys.modules keys, not substrings: "cdvslam_tpu" is a prefix of the port's name
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                       text=True, timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr


def test_slam_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLAM(get_cfg(), "cdv", ht=64, wd=96)


@pytest.mark.parametrize("change", [
    {"network": "dpv"}, {"viz": True}, {"LOOP_CLOSURE": True, "CLASSIC_LOOP_CLOSURE": True},
    {"CLASSIC_LOOP_CLOSURE": True}, {"CENTROID_SEL_STRAT": "RANDOM"},
    {"CENTROID_SEL_STRAT": "GRADIENT_BIAS"},
])
def test_configs_outside_the_slice_raise(change):
    cfg = get_cfg()
    kwargs = {"device": "cpu"}
    for k, v in change.items():
        if k in ("network", "viz"):
            kwargs[k] = v
        else:
            cfg[k] = v
    with pytest.raises(NotImplementedError):
        SLAM(cfg, ht=64, wd=96, **kwargs)


def test_mixed_precision_off_is_refused_on_the_card():
    cfg = get_cfg()
    cfg.MIXED_PRECISION = False
    with pytest.raises(NotImplementedError, match="bf16"):
        SLAM(cfg, "cdv", ht=64, wd=96, device="cuda")


def test_score_without_a_seg_head_raises():
    cfg = get_cfg()
    cfg.CENTROID_SEL_STRAT = "SCORE"
    with pytest.raises(ValueError, match="seg head"):
        SLAM(cfg, "cdv", ht=64, wd=96, device="cpu")


@pytest.mark.parametrize("key", ["SEG_HEAD", "DEPTH_HEAD"])
def test_missing_head_checkpoint_raises(tmp_path, key):
    """The JAX package warns and runs without the head; the port refuses."""
    cfg = get_cfg()
    cfg[key] = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        SLAM(cfg, "cdv", ht=64, wd=96, device="cpu")


def test_cdvo_pp_preset_with_random_heads_builds_on_the_cpu():
    cfg = get_cfg().merge_from_file(Path(__file__).resolve().parents[1] / "config"
                                    / "default_cdvo++.yaml")
    assert cfg.CENTROID_SEL_STRAT == "SCORE" and cfg.FILTER_DYNAMIC_CLASS
    cfg.SEG_HEAD, cfg.DEPTH_HEAD = "random", "random"
    slam = SLAM(cfg, "cdv", ht=64, wd=96, device="cpu")
    assert slam.seg_head is not None and slam.depth_head is not None
    assert not slam.depth_is_dpt and slam.scale_factor == 20.0
