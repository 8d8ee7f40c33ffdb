"""BENCHMARK.json and the files its names lead to."""

import json
import os
import re

import pytest

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for x in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    c = spec.load_cell(cell)
    assert c.queries and set(c.queries) == set(c.traffic["queries"])
    for q in c.queries:
        mod = spec.reference_module(q)
        assert callable(mod.answer) and mod.COLUMNS
    door = spec.front_door(c.config["front_door"])
    assert callable(door.open_session)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m.name).read)
        assert m.moves in {e.name for e in c.end_to_end}
    assert {m.name for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    for m in c.end_to_end:
        assert m.workloads is None or cell in m.workloads
    assert c.per_layer


def test_per_layer_cells_and_moves_exist():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")
