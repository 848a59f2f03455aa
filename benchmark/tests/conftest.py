"""Small cells for the harness's CPU tests: the configurations' recipes on
a grid of four 64x60 units, so the port's plain versions run them in
seconds."""

import copy
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent


def small(name: str) -> dict:
    """Configuration ``name`` with its capture cut to four units."""
    with open(HERE / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["image_hw"] = [150, 170]
    cfg["grid"] = {"base_unit": [10, 12, 64, 60], "units_x": 2, "units_y": 2, "blocks_x": 1,
                   "blocks_y": 1, "unit_space_x": 9, "unit_space_y": 7, "block_space_x": 0,
                   "block_space_y": 0}
    cfg["exclusions"] = [{"shape": "circle", "cx": 32, "cy": 30, "r": 6}]
    cfg["capture"]["speck_radius"] = [2, 4]
    return cfg


def mix(name: str, **over) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return {**json.load(fh), **over}


@pytest.fixture
def cpu():
    """The harness on the CPU: the port's plain versions stand in for its
    kernels (no card is looked for)."""
    return "cpu"
