"""Package rules of the port: no JAX, the card by default, and configs
outside the ported slice refused."""
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
    {"CLASSIC_LOOP_CLOSURE": True}, {"SEG_HEAD": "random"}, {"DEPTH_HEAD": "dpt"},
    {"FILTER_DYNAMIC_CLASS": True}, {"CENTROID_SEL_STRAT": "SCORE"},
    {"CENTROID_SEL_STRAT": "RANDOM"},
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
