"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""
import json
import re

import pytest

from perfbench import bench
from perfbench.traffic import gen

SPEC = bench.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _e2e_of(cell):
    return {m["name"] for m in bench.metrics_for(SPEC, cell, False)}


def test_top_level_and_entry_keys():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        extra = set(m) - {"name", "unit", "better", "source", "workloads"}
        assert extra <= ({"bound"} if m in SPEC["end_to_end"]
                         else {"layer", "moves"})
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_text():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in SPEC["workloads"] + SPEC["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_and_reports_enough(cell):
    w = bench.cell_of(SPEC, cell)
    config = bench.load_json("configs", w["config"])
    assert config["name"] == w["config"]
    assert gen.load(w["traffic"])["name"] == w["traffic"]
    limits = bench.load_json("limits", cell)
    assert limits["route_mismatch"]["limit"] == 0
    assert all(v["limit"] > 0 for k, v in limits.items() if k != "route_mismatch")
    e2e = _e2e_of(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.metrics_for(SPEC, cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(bench.reader(m["name"]))
    for m in e2e:
        assert callable(bench.reader(m))


def test_configs_are_used_and_files_unique():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = bench.load_json("configs", c["name"])
        for path in c["reduced"]:
            # a reduced key names a model entry's key, and says what was
            # published there
            assert path.startswith("models.")
            rest = path[len("models."):]
            assert any(rest.startswith(m["name"] + ".")
                       for m in cfg["models"]), path
            assert rest in cfg["published"], path
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
