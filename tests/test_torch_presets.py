"""The odometry presets through the port's harness (the port's counterpart
of ``test_fidelity_configs.py``, ``tests/torch_presets.py``): CDVO
(``default_cdvo.yaml``), CDVO at stride 2 (the EuRoC invocation), DPVO
(``default_dpvo.yaml``) and ``fast_dpvo.yaml`` (48 patches, KEYFRAME_INDEX
2), 20 rendered frames at 192 x 256 with random weights, with the JAX
smokes' assertions plus keyframe removals. Fewer patches than the presets
ship, for CPU time: 16 under each (a whole
48-patch run is in ``test_torch_presets_fast_dpvo.py`` and on the card,
chip_smoke.py phase 10)."""
import pytest

cv2 = pytest.importorskip("cv2")

from torch_presets import smoke, render_sequences  # noqa: E402

FAST_DPVO = "config/fast_dpvo.yaml"


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    return render_sequences(tmp_path_factory.mktemp("presets"))


def test_preset_cdvo(sequences):
    _, slam = smoke(sequences, "config/default_cdvo.yaml", "cdv",
                    opts=["PATCHES_PER_FRAME", "16"])
    assert slam.stats["keyframe_removals"] > 0


def test_preset_euroc_stride2(sequences):
    # the eval.euroc invocation: default_cdvo at stride 2
    smoke(sequences, "config/default_cdvo.yaml", "cdv", stride=2,
          opts=["PATCHES_PER_FRAME", "16"])


def test_preset_dpvo(sequences):
    _, slam = smoke(sequences, "config/default_dpvo.yaml", "dpv",
                    opts=["PATCHES_PER_FRAME", "16"])
    assert slam.stats["keyframe_removals"] > 0


def test_preset_fast_dpvo(sequences):
    _, slam = smoke(sequences, FAST_DPVO, "dpv", opts=["PATCHES_PER_FRAME", "16"])
    assert slam.cfg.KEYFRAME_INDEX == 2 and slam.cfg.REMOVAL_WINDOW == 14
    assert slam.stats["keyframe_removals"] > 0
