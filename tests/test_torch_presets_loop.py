"""The loop-closure presets through the port's harness (the port's
counterpart of ``test_fidelity_configs.py``'s LC smokes,
``tests/torch_presets.py``): CDV-SLAM with proximity loop closure
(``default_cdvslam.yaml`` with the classical backend off, 44 frames so
that loop pairs with j - i >= 30 exist, KEYFRAME_THRESH 0 and a permissive
flow gate) and CDV-SLAM++ (``default_cdvslam++.yaml`` with seeded random
seg and depth heads, the retrieval radius shrunk to the sequence's scale,
CLASSIC_LOOP_SYNC), at 192 x 256 with random weights. The JAX smokes'
assertions: loop edges and a global BA fire, and the classical backend
attempts a closure. Fewer patches than the presets ship, for CPU time: 8
under CDV-SLAM (the JAX smoke uses 16) and 16 under CDV-SLAM++."""
import pytest

cv2 = pytest.importorskip("cv2")

from torch_presets import F_LONG, F, render_sequences, smoke  # noqa: E402


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    return render_sequences(tmp_path_factory.mktemp("presets_loop"),
                            (("images", F), ("images_long", F_LONG)))


def test_preset_cdvslam_proximity_lc(sequences):
    _, slam = smoke(
        sequences, "config/default_cdvslam.yaml", "cdv",
        opts=["CLASSIC_LOOP_CLOSURE", "False", "KEYFRAME_THRESH", "0.0",
              "PATCHES_PER_FRAME", "8", "BACKEND_THRESH", "999.0"],
        images="images_long", nframes=F_LONG)
    assert slam.stats["loop_edges"] > 0, "proximity LC never appended loop edges"
    assert slam.stats["global_ba"] > 0, "loop edges never triggered global BA"


def test_preset_cdvslam_pp_classic(sequences):
    _, slam = smoke(
        sequences, "config/default_cdvslam++.yaml", "cdv",
        opts=["SEG_HEAD", "random", "DEPTH_HEAD", "random", "PATCHES_PER_FRAME", "16",
              "LOOP_RETR_THRESH", "0.0", "LOOP_RETR_RADIUS", "8",
              "LOOP_CLOSE_NMS", "4", "CLASSIC_LOOP_SYNC", "True",
              "KEYFRAME_THRESH", "0.0"])
    assert slam.long_term_lc is not None, "classic LC not constructed"
    assert slam.stats["lc_attempts"] > 0, "classic LC never attempted a closure"
