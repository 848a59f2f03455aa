"""tpu_inspect_torch.session vs tpu_inspect.session: the same operation
sequence on both packages (the port on ``device="cpu"``, where kernels
A-J run their plain versions), with equal arrays, log lines, persisted
JSON and CSV, and equal PNG pixels (decoded with cv2; the port's encoder
is byte-different by design). Seeded synthetic captures; tolerance 0.
"""

import csv
import json

import numpy as np
import pytest

import tpu_inspect.config as jcfg
from tpu_inspect.session import InspectionSession as JSession
from tpu_inspect.session import SessionError as JSessionError

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch.geometry import BoxGrid
from tpu_inspect_torch.session import InspectionSession, SessionError
from tpu_inspect_torch.synthetic import make_mold_image

BASE = dict(base_unit=(6, 8, 48, 44), units_x=2, units_y=2)
EXCL = {"shape": "rect", "x": 2, "y": 2, "w": 8, "h": 6}


def _drive(session, cfg, tmp_path, tag):
    """The operator's sequence; returns what each step gave back."""
    grid = cfg.GridParams(**BASE)
    ref = make_mold_image(tcfg.GridParams(**BASE), (110, 115), seed=3, defect_rate=0.9)
    cur = make_mold_image(tcfg.GridParams(**BASE), (110, 115), seed=4, defect_rate=0.9,
                          shift=(3, -2))
    s = session
    s.add_image("ref.png", ref)
    s.add_image("cur.png", cur)
    out = {"units": s.apply_indexing(grid), "excl": s.add_exclusion(EXCL)}
    out["seg_ref"] = s.results().seg
    out["insp_ref"] = s.set_inspection(True)
    out["insp_ref_copy"] = {f: getattr(out["insp_ref"], f).copy()
                            for f in ("defect_masks", "valid", "areas", "verdicts")}
    # one parameter set for every single-unit call: each new set costs the
    # JAX package a compile of its diagnostic and one-unit passes
    s.set_defect_params(cfg.DefectParams(threshold=18, min_area=3, erode_px=2))
    out["test2"] = s.test_defect_unit(2)
    out["auto1"] = s.auto_update_defect_unit(1)
    out["test3"] = s.test_defect_unit(3, verbose=False)
    out["after_tests"] = s.results().insp
    s.set_inspection(True)
    s.switch_to("cur.png")
    out["seg_cur"] = s.results().seg
    out["insp_cur"] = s.results().insp
    with pytest.raises((SessionError, JSessionError), match="reference"):
        s.add_exclusion(EXCL)
    s.switch_to("ref.png")
    out["grid_doc"] = s.export_grid(str(tmp_path / f"{tag}_grid.json"))
    out["csv"] = s.export_masks(str(tmp_path / f"{tag}_masks"))
    out["thumbs"] = s.export_thumbnails(str(tmp_path / f"{tag}_thumbs"))
    out["log"] = list(s.log.lines)
    out["centroids"] = dict(s.ref_centroids)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("session")
    port = _drive(InspectionSession(device="cpu"), tcfg, tmp, "port")
    ref = _drive(JSession(), jcfg, tmp, "ref")
    return port, ref, tmp


def _same_result(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_session_passes_match_reference(runs):
    port, ref, _ = runs
    assert port["units"] == ref["units"] == 4 and port["excl"] == ref["excl"] == 0
    for key in ("seg_ref", "insp_ref", "after_tests", "seg_cur", "insp_cur"):
        _same_result(port[key], ref[key])
    assert port["seg_cur"].shifts.any()  # the second capture is aligned
    assert port["centroids"] == ref["centroids"]


def test_single_unit_tests_and_log_lines_match_reference(runs):
    port, ref, _ = runs
    for key in ("test2", "test3"):
        p, r = port[key], ref[key]
        assert (p["area"], p["verdict"], p["found"]) == (r["area"], r["verdict"], r["found"])
        if r["mask"] is None:
            assert p["mask"] is None
        else:
            np.testing.assert_array_equal(p["mask"], r["mask"])
    if ref["auto1"] is None:
        assert port["auto1"] is None
    else:
        np.testing.assert_array_equal(port["auto1"], ref["auto1"])
    assert port["log"] == ref["log"]
    assert any(line.startswith("Seg mask area (roi)=") for line in port["log"])


def test_results_a_caller_holds_stay_unchanged(runs):
    """Single-unit updates copy the stored (read-only) arrays first, so the
    result run_inspection returned is not changed by later unit tests."""
    port, ref, _ = runs
    for out in (port, ref):
        for f, before in out["insp_ref_copy"].items():
            np.testing.assert_array_equal(getattr(out["insp_ref"], f), before)
            assert not getattr(out["insp_ref"], f).flags.writeable
    assert port["after_tests"] is not port["insp_ref"]
    assert port["after_tests"].areas.flags.writeable


def test_exports_match_reference(runs):
    import cv2

    port, ref, tmp = runs
    assert port["grid_doc"] == ref["grid_doc"]
    assert json.load(open(tmp / "port_grid.json")) == json.load(open(tmp / "ref_grid.json"))
    rows = [list(csv.DictReader(open(out["csv"]))) for out in (port, ref)]
    assert rows[0] == rows[1] and len(rows[0]) == 4
    assert port["thumbs"] == ref["thumbs"] == 4
    for kind, n in (("masks", "mask_{:04d}.png"), ("thumbs", "unit_{:04d}.png")):
        for i in range(4):
            a = cv2.imread(str(tmp / f"port_{kind}" / n.format(i)), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp / f"ref_{kind}" / n.format(i)), cv2.IMREAD_UNCHANGED)
            assert a is not None and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_import_grid_and_bare_box_list(runs):
    """A v2 grid file restores the grid, exclusions and anchors; a bare box
    list (legacy) imports as a BoxGrid keeping every unit, on both."""
    port, ref, tmp = runs
    image = make_mold_image(tcfg.GridParams(**BASE), (110, 115), seed=3, defect_rate=0.9)
    s, js = InspectionSession(device="cpu"), JSession()
    for sess in (s, js):
        sess.add_image("ref.png", image)
        assert sess.import_grid(str(tmp / "ref_grid.json")) == 4
    assert s.grid == tcfg.GridParams(**BASE)
    assert s.exclusions == js.exclusions == [EXCL]
    assert s.ref_centroids == js.ref_centroids == ref["centroids"]
    boxes = [{"index": i, "x": d["x"], "y": d["y"], "w": d["w"], "h": d["h"]}
             for i, d in enumerate(port["grid_doc"]["boxes"])]
    for sess in (s, js):
        assert sess.import_grid(boxes[::-1]) == 4  # ordered by the index field
    assert isinstance(s.grid, BoxGrid) and s.grid.boxes == js.grid.boxes
    _same_result(s.run_segmentation(), js.run_segmentation())
    _same_result(s.run_inspection(), js.run_inspection())
