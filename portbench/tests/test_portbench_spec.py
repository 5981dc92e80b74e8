"""BENCHMARK.json and every configuration, traffic and metric file it
names parse and are found by name, within the benchmark's contract."""
import json
import re

import pytest

from portbench import cell

SPEC = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("wl", [w["name"] for w in SPEC["workloads"]])
def test_workload_found_by_name(wl):
    w, cfg, traffic, e2e, layer = cell.cell_spec(wl)
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    assert cfg["name"] == w["config"] and cfg["network"] in ("cdv", "dpv")
    assert callable(cell.load_driver(traffic["driver"]).Session)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert callable(cell.load_reader(m["name"]))
        assert m["moves"] in names


@pytest.mark.parametrize("kind", ["configs", "end_to_end", "per_layer"])
def test_entries(kind):
    seen = set()
    for e in SPEC[kind]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        if kind == "configs":
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert e["file"] == f"portbench/configs/{e['name']}.json"
            assert json.loads((cell.ROOT / e["file"]).read_text())["reduced"] == e["reduced"]
        else:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert set(e) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                              "workloads"}
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25


def test_per_layer_readers_return_nothing_without_a_trace():
    ctx = {"profile": None, "frame_log": [], "sequences": [], "captures": 0,
           "cell": {"network": "cdv"}, "last_update": None}
    for m in SPEC["per_layer"]:
        v = cell.load_reader(m["name"])(ctx)
        assert v is None or m["name"] == "graph_captures"
