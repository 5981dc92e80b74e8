"""The retrieval-recall harness (``python -m cdvslam_tpu_torch.eval.lc_recall``)
against the JAX tool (``tools/bench_lc_recall.py``, its ``main`` run with
``sys.argv`` at per_loop 12 and its stdout captured), both on the JAX
tool's own renders (``tests/render_plane.py``): every row of the table is
the same, which fixes the fired, valid and recall counts (precision to
two decimals tells the valid count apart at up to 100 fires, recall the
detected count at 10 eligible frames); and the port's own renders give a
table of the same shape with the counts it prints."""
import importlib.util
import io
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cv2")

from render_plane import PlaneScene, overhead_loop_poses  # noqa: E402
from cdvslam_tpu_torch.eval import lc_recall  # noqa: E402

PER_LOOP = 12
TOOL = Path(__file__).resolve().parents[1] / "tools" / "bench_lc_recall.py"


def _table(text):
    return [line.split() for line in text.splitlines()[2:] if line.strip()]


def test_recall_table_matches_the_jax_tool_on_its_renders(monkeypatch):
    spec = importlib.util.spec_from_file_location("bench_lc_recall", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr("sys.argv", ["bench_lc_recall.py", str(PER_LOOP)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        tool.main()
    want = _table(buf.getvalue())

    scene = PlaneScene(lc_recall.INTR, lc_recall.HT, lc_recall.WD, seed=3)
    got = io.StringIO()
    table = lc_recall.run(PER_LOOP, scene=scene, loop_poses=np.asarray(
        overhead_loop_poses(PER_LOOP)), out=got)
    assert len(want) == len(table["rows"]) == 20
    assert _table(got.getvalue()) == want
    assert sum(r["fired"] for r in table["rows"]) > 0


def test_the_ports_own_renders_give_the_printed_counts():
    buf = io.StringIO()
    table = lc_recall.run(PER_LOOP, sigmas=(0.0, 5.0), threshes=(0.04,), out=buf)
    assert table["eligible"] == PER_LOOP - 2 and table["frames"] == 2 * PER_LOOP
    for row, line in zip(table["rows"], _table(buf.getvalue()), strict=True):
        assert row["detected"] <= row["valid"] <= row["fired"]
        assert line == [f"{row['sigma']:.1f}", f"{row['thresh']:.2f}", f"{row['recall']:.2f}",
                        f"{row['precision']:.2f}", str(row["fired"])]
