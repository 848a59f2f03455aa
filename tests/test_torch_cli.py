"""The port's CLI (``python -m tpu_inspect_torch.cli ... --device cpu``)
against :mod:`tpu_inspect.cli` on a small grid: the grid file, the mask
exports, the JSON report of ``inspect`` and the JSONL lines of ``stream``
are equal; ``doctor`` reports the port's card, kernel build, route gates
and native IO.
"""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tpu_inspect import cli as jcli
from tpu_inspect.persistence import load_masks_csv as j_load_csv

from tpu_inspect_torch import cli
from tpu_inspect_torch.config import GridParams
from tpu_inspect_torch.geometry import grid_boxes
from tpu_inspect_torch.persistence import GridDocument, grid_metadata, save_grid
from tpu_inspect_torch.synthetic import make_mold_image

GRID = GridParams(
    base_unit=(20, 24, 64, 60), units_x=3, units_y=2, unit_space_x=10, unit_space_y=12
)
HW = (220, 280)
GRIDGEN = ["gridgen", "--base", "20,24,64,60", "--units", "3x2", "--blocks", "1x1",
           "--unit-space", "10,12", "--block-space", "0,0", "--image-size", "280x220"]


def _run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


@pytest.fixture()
def captures(tmp_path):
    """A reference capture, a shifted one and a third frame as PNG files."""
    paths = []
    for i, (seed, shift) in enumerate([(5, (0, 0)), (6, (2, 1)), (7, (-1, 2))]):
        p = str(tmp_path / f"cap_{i}.png")
        assert cv2.imwrite(p, make_mold_image(GRID, HW, seed=seed, defect_rate=1.0, shift=shift))
        paths.append(p)
    return paths


def test_gridgen_segment_inspect_match_jax(tmp_path, captures, capsys):
    _run(cli.main, GRIDGEN + ["--out", str(tmp_path / "t.json")], capsys)
    _run(jcli.main, GRIDGEN + ["--out", str(tmp_path / "j.json")], capsys)
    grid_p = str(tmp_path / "t.json")
    assert json.load(open(grid_p)) == json.load(open(tmp_path / "j.json"))

    seg = ["segment", "--grid", grid_p, "--image", captures[0], "--min-area", "5"]
    _run(cli.main, seg + ["--out", str(tmp_path / "ts"), "--device", "cpu"], capsys)
    _run(jcli.main, seg + ["--out", str(tmp_path / "js")], capsys)
    rows = j_load_csv(str(tmp_path / "ts" / "masks_summary.csv"))
    assert rows == j_load_csv(str(tmp_path / "js" / "masks_summary.csv")) and len(rows) == 6
    for i in range(6):
        name = f"mask_{i:04d}.png"
        a = cv2.imread(str(tmp_path / "ts" / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, cv2.imread(str(tmp_path / "js" / name),
                                                    cv2.IMREAD_UNCHANGED), err_msg=name)

    insp = ["inspect", "--grid", grid_p, "--image", captures[0], captures[1], "--min-area", "5"]
    ours = _run(cli.main, insp + ["--out", str(tmp_path / "ti"), "--device", "cpu"], capsys)
    theirs = _run(jcli.main, insp + ["--out", str(tmp_path / "ji")], capsys)
    report = json.loads(ours[-1])
    assert report == json.loads(theirs[-1])
    assert report == json.load(open(tmp_path / "ti" / "inspection.json"))
    assert report[captures[0]]["ng_count"] >= 1 and report[captures[1]]["unit_count"] == 6


@pytest.mark.parametrize("with_excl", [True, False])
def test_stream_matches_jax(tmp_path, captures, capsys, with_excl):
    """With exclusions and no anchors in the grid the first frame records
    them; without exclusions every frame is a reference capture."""
    excl = [{"shape": "rect", "x": 4, "y": 4, "w": 9, "h": 9}] if with_excl else []
    grid_p = str(tmp_path / "grid.json")
    save_grid(GridDocument(boxes=grid_boxes(GRID), metadata=grid_metadata(GRID, *HW[::-1]),
                           exclusions=excl), grid_p)
    argv = ["stream", "--grid", grid_p, *captures, "--min-area", "5", "--prefetch", "2"]
    ours = _run(cli.main, argv + ["--device", "cpu"], capsys)
    theirs = _run(jcli.main, argv, capsys)
    assert [json.loads(x) for x in ours] == [json.loads(x) for x in theirs]
    assert [json.loads(x)["index"] for x in ours] == [0, 1, 2]


def test_doctor(capsys):
    out = "\n".join(_run(cli.main, ["doctor", "--device", "cpu"], capsys))
    jout = "\n".join(_run(jcli.main, ["doctor"], capsys))
    assert "devices:" in out and "kernel library: libtik_" in out
    assert "gate seg_tail_fits(48, 315, 316): True" in out
    assert "gate _whole_route(48, 315, 316): False" in out
    assert "gate _whole_route(1, 3000, 4096): True" in out
    native_line = [x for x in out.splitlines() if x.startswith("native io:")]
    assert native_line == [x for x in jout.splitlines() if x.startswith("native io:")]
