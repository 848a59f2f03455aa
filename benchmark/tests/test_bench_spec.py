"""BENCHMARK.json and the files it names: every configuration, mix and
metric is found by its name, and every name and unit keeps to the
characters the contract allows."""

import json
import re

import pytest

from benchmark import mix
from benchmark.run import HERE, ROOT, cell_parts, reader, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moved = {m["name"]: set(m.get("workloads", [w["name"] for w in b["workloads"]]))
             for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= moved[m["moves"]]


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_each_cell_finds_its_files(cell):
    c, cfg, traffic, e2e, layer = cell_parts(spec(), cell)
    assert cfg["name"] == c["config"] and isinstance(mix.load(traffic), mix.Mix)
    assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(reader(m["name"]))
    assert (HERE / "traffic" / f"{c['traffic']}.json").exists()
