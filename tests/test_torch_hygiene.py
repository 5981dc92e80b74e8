"""Package rules of the port: no JAX (the training, data and parallel
modules included), the card by default (SLAM and the training entry point),
configs outside the ported slice refused, the classical loop closure built
(and a backend that cannot be built raised), and the heads' set-up rules
(CDV) and refusal (DPVO)."""
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


def test_port_sources_import_nothing_of_jax_even_lazily():
    """No import line anywhere in the port (inside functions too) names jax,
    flax, optax or the JAX package: the import test above cannot see a
    lazy import that a run never reaches (train/, data/, parallel/)."""
    import re
    pkg = Path(__file__).resolve().parents[1] / "cdvslam_tpu_torch"
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|cdvslam_tpu)\b", re.M)
    files = sorted(pkg.rglob("*.py"))
    assert any(f.parent.name == "train" for f in files) and any(f.parent.name == "parallel"
                                                                 for f in files)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert not offenders, offenders


def test_score_head_and_dino_adapter_are_refused():
    from cdvslam_tpu_torch.models import CDVNet
    for kw in ({"compute_score": True}, {"dino_adapt": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            CDVNet(**kw)


def test_training_cli_wants_a_card_unless_told(monkeypatch):
    from cdvslam_tpu_torch.train import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["cdv"])


def test_slam_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLAM(get_cfg(), "cdv", ht=64, wd=96)


def _build(change, error=None):
    cfg = get_cfg()
    kwargs = {"device": "cpu"}
    for k, v in change.items():
        if k in ("network", "viz"):
            kwargs[k] = v
        else:
            cfg[k] = v
    if error is None:
        return SLAM(cfg, ht=64, wd=96, **kwargs)
    with pytest.raises(error):
        SLAM(cfg, ht=64, wd=96, **kwargs)


@pytest.mark.parametrize("change", [
    {"viz": True}, {"network": "dpv", "viz": True}, {"network": "vonet"},
])
def test_configs_outside_the_slice_raise(change):
    _build(change, NotImplementedError)


@pytest.mark.parametrize("change", [
    {"network": "dpv", "CLASSIC_LOOP_CLOSURE": True},
    {"LOOP_CLOSURE": True, "CLASSIC_LOOP_CLOSURE": True}, {"CLASSIC_LOOP_CLOSURE": True},
])
def test_classic_loop_closure_builds_on_the_cpu(change):
    """Refused until the classical backend was ported; each builds a SLAM
    with its backend attached (cv2 and g++ are on this host)."""
    from cdvslam_tpu_torch.loop.long_term import LongTermLoopClosure
    slam = _build(change)
    assert isinstance(slam.long_term_lc, LongTermLoopClosure)
    assert slam.stats["lc_attempts"] == slam.stats["lc_applied"] == 0


def test_classic_backend_that_cannot_load_its_library_raises(monkeypatch, tmp_path):
    """The JAX package warns and turns the backend off; the port raises."""
    from cdvslam_tpu_torch.loop import retrieval
    monkeypatch.setattr(retrieval, "_LIB", None)
    monkeypatch.setattr(retrieval, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(retrieval, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build({"CLASSIC_LOOP_CLOSURE": True})


@pytest.mark.parametrize("change", [
    {"SEG_HEAD": "random"}, {"DEPTH_HEAD": "dpt_random"}, {"FILTER_DYNAMIC_CLASS": True},
])
def test_heads_under_dpv_raise(change):
    """The JAX package sets the heads up for CDV only and ignores them
    under DPVO; the port refuses them (ROADMAP Queue 3)."""
    _build({"network": "dpv", **change}, ValueError)


@pytest.mark.parametrize("strategy", ["RANDOM", "GRADIENT_BIAS", "RANDOM_GRID", "SCORE"])
def test_dpvo_builds_on_the_cpu_with_every_strategy(strategy):
    """DPVO draws GRADIENT_BIAS, and RANDOM for anything else, as the JAX
    package does; the gmap and fmap rings take its 128 channels."""
    cfg = get_cfg().merge_from_file(Path(__file__).resolve().parents[1] / "config"
                                    / "default_dpvo.yaml")
    cfg.CENTROID_SEL_STRAT = strategy
    slam = SLAM(cfg, "dpv", ht=64, wd=96, device="cpu")
    assert slam.seg_head is None and slam.depth_head is None
    assert slam.pg.gmap_.shape[1:] == (128, 3, 3) and slam.pg.fmap1_.shape[1:] == (16, 24, 128)
    cand, depth = slam.patch_sampler(0)
    assert cand.shape == ((3 if strategy == "GRADIENT_BIAS" else 1) * 96, 2) and depth.shape == (96,)
    assert cand.min() >= 1 and cand[:, 0].max() < 23 and cand[:, 1].max() < 15


def test_mixed_precision_off_is_refused_on_the_card():
    """No longer refused: DINO attention has a float32 kernel, so
    MIXED_PRECISION=False under "cdv" builds for the card. On a host
    without one it gets as far as moving the network there."""
    cfg = get_cfg()
    cfg.MIXED_PRECISION = False
    with pytest.raises((RuntimeError, AssertionError)) as err:
        SLAM(cfg, "cdv", ht=64, wd=96, device="cuda")
    assert not isinstance(err.value, NotImplementedError)
    assert "CUDA" in str(err.value)


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


@pytest.mark.parametrize("preset", ["default_cdvslam.yaml", "default_cdvslam++.yaml"])
def test_published_cdvslam_presets_build_on_the_cpu(preset):
    """Both set CLASSIC_LOOP_CLOSURE and LOOP_CLOSURE; the ++ preset's
    heads are seeded random ones (the checkpoints are not in the repo)."""
    cfg = get_cfg().merge_from_file(Path(__file__).resolve().parents[1] / "config" / preset)
    assert cfg.CLASSIC_LOOP_CLOSURE and cfg.LOOP_CLOSURE
    if cfg.SEG_HEAD:
        cfg.SEG_HEAD, cfg.DEPTH_HEAD = "random", "random"
    slam = SLAM(cfg, "cdv", ht=64, wd=96, device="cpu")
    assert slam.long_term_lc is not None


def test_cdvo_pp_preset_with_random_heads_builds_on_the_cpu():
    cfg = get_cfg().merge_from_file(Path(__file__).resolve().parents[1] / "config"
                                    / "default_cdvo++.yaml")
    assert cfg.CENTROID_SEL_STRAT == "SCORE" and cfg.FILTER_DYNAMIC_CLASS
    cfg.SEG_HEAD, cfg.DEPTH_HEAD = "random", "random"
    slam = SLAM(cfg, "cdv", ht=64, wd=96, device="cpu")
    assert slam.seg_head is not None and slam.depth_head is not None
    assert not slam.depth_is_dpt and slam.scale_factor == 20.0
