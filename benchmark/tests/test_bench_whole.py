"""The whole-capture configuration through the harness on the CPU: cut to
one 150x170 unit, with the port's whole-image gate lowered so the unit
takes the route a 4096x3000 capture takes on the card, a sound program
comes out correct and the faults planted in its answers do not."""

import json

import pytest

from benchmark import compare
from benchmark.run import run_cell
from conftest import HERE, mix
from test_bench_run import _broken

SEEDS = [1, 2**31 + 5]


def whole_small() -> dict:
    """``whole4096-otsu-threshold`` with its one unit cut to 150x170."""
    with open(HERE / "configs" / "whole4096-otsu-threshold.json") as fh:
        cfg = json.load(fh)
    cfg["image_hw"] = [150, 170]
    cfg["grid"]["base_unit"] = [0, 0, 170, 150]
    cfg["exclusions"] = [{"shape": "circle", "cx": 32, "cy": 30, "r": 6}]
    cfg["capture"]["speck_radius"] = [2, 4]
    return cfg


@pytest.fixture
def whole(monkeypatch):
    from tpu_inspect_torch import engine

    monkeypatch.setattr(engine, "WHOLE_MIN_PX", 1000)
    assert engine._whole_route(150, 170)


def test_configuration_is_one_unit_over_the_capture():
    with open(HERE / "configs" / "whole4096-otsu-threshold.json") as fh:
        cfg = json.load(fh)
    g = cfg["grid"]
    assert g["base_unit"] == [0, 0, 4096, 3000] and cfg["image_hw"] == [3000, 4096]
    assert all(g[k] == 1 for k in ("units_x", "units_y", "blocks_x", "blocks_y"))
    assert not cfg.get("chained_reference_capture") and cfg["reduced"] == []


@pytest.mark.parametrize("seed", SEEDS)
def test_whole_run_is_correct(cpu, whole, seed):
    run, out = run_cell(whole_small(), mix("ahead", pool=4), seed, 0.5, device=cpu)
    assert compare.passed(out["numbers"]) and run.frames
    assert all(f.answers is not None for f in run.frames)


@pytest.mark.parametrize("kind", ["answer altered", "state unchanged"])
def test_whole_planted_fault_is_not_correct(cpu, whole, kind, monkeypatch):
    from tpu_inspect_torch import engine

    monkeypatch.setattr(engine, "_inspect_image_device", _broken(kind))
    _, out = run_cell(whole_small(), mix("ahead", pool=4), 1, 0.5, device=cpu)
    assert not compare.passed(out["numbers"])
