"""tpu_inspect_torch.ui.UIServer vs tpu_inspect.ui.UIServer: both servers
on 127.0.0.1, driven through the same HTTP operation sequence (the port's
session on ``device="cpu"``). Every JSON response is compared field by
field; PNGs by their pixels, decoded with cv2 (the port's encoder is
byte-different by design). Seeded synthetic captures; tolerance 0.
"""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_inspect.ui import UIServer as JUIServer

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch.synthetic import make_mold_image
from tpu_inspect_torch.ui import UIServer

GRID = tcfg.GridParams(base_unit=(6, 8, 48, 44), units_x=2, units_y=2)


def _post(srv, op, body=None):
    req = urllib.request.Request(
        f"{srv.url}api/{op}", data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read()), r.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.code


def _get(srv, path):
    try:
        with urllib.request.urlopen(f"{srv.url}{path}", timeout=120) as r:
            return r.read(), r.status, r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.read(), e.code, None


def _pixels(data: bytes):
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert img is not None, "PNG did not decode"
    return img


def _sequence(tmp_path):
    """(kind, op or path, body) steps: the reference tool's workflow."""
    import cv2

    ref = make_mold_image(GRID, (110, 115), seed=3, defect_rate=0.9)
    cur = make_mold_image(GRID, (110, 115), seed=4, defect_rate=0.9, shift=(2, -1))
    path = str(tmp_path / "ref.png")
    cv2.imwrite(path, ref)
    ok, buf = cv2.imencode(".png", cur)
    grid = {"base_unit": list(GRID.base_unit), "units_x": 2, "units_y": 2}
    return [
        ("post", "load", {"path": path}),
        ("post", "load", {"name": "cur.png", "png_base64": base64.b64encode(buf).decode()}),
        ("get", "", None),
        ("post", "grid_preview", grid),
        ("post", "indexing", grid),
        ("get", "api/state", None),
        ("post", "run_segmentation", {}),
        ("post", "exclusion_add", {"excl": {"shape": "rect", "x": 2, "y": 2, "w": 8, "h": 6}}),
        ("get", "api/canvas.png?mode=Segmentation", None),
        ("get", "api/thumb.png?idx=1&mode=Both", None),
        ("post", "select", {"idx": 2}),
        ("post", "test_defect", {"idx": 2}),
        ("get", "api/canvas.png?selected=2&outline=1", None),
        ("post", "inspection", {"enabled": True}),
        ("get", "api/state", None),
        ("get", "api/canvas.png", None),
        ("post", "defect_params", {"method": "threshold", "threshold": 18, "min_area": 3,
                                   "erode_px": 2}),
        ("post", "auto_update_defect", {"idx": 2}),
        ("post", "test_all", {}),
        ("get", "api/canvas.png?selected=1&outline=1&mode=Both", None),
        ("post", "overlay", {"mode": "Both"}),
        ("post", "switch", {"path": "cur.png"}),
        ("post", "exclusion_add", {"excl": {"shape": "circle", "cx": 9, "cy": 9, "r": 4}}),
        ("post", "inspection", {"enabled": True}),
        ("get", "api/state", None),
        ("post", "switch", {"path": path}),
        ("post", "export_grid", {}),
        ("post", "select", {"idx": None}),
        ("post", "nosuchop", {}),
        ("get", "api/nothing", None),
        ("get", "api/state", None),
    ]


@pytest.fixture(scope="module")
def responses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ui")
    steps = _sequence(tmp)
    out = []
    for srv in (UIServer(device="cpu"), JUIServer()):
        srv.start()
        try:
            got = []
            for kind, op, body in steps:
                got.append(_post(srv, op, body) if kind == "post" else _get(srv, op))
            out.append(got)
        finally:
            srv.stop()
    return steps, out[0], out[1]


def test_json_responses_match_reference(responses):
    steps, port, ref = responses
    for (kind, op, _), p, r in zip(steps, port, ref):
        if kind == "post":
            assert p == r, op
        elif op.startswith("api/state"):
            assert p[1] == r[1] == 200
            ps, rs = json.loads(p[0]), json.loads(r[0])
            assert ps.keys() == rs.keys()
            for key in rs:
                assert ps[key] == rs[key], key
    states = [json.loads(p[0]) for (k, op, _), p in zip(steps, port) if op == "api/state"]
    assert states[1]["has_insp"] and len(states[1]["verdicts"]) == 4
    assert any(line.startswith("Unit 2: defect area=") for line in states[-1]["log"])


def test_pngs_match_reference_pixels(responses):
    steps, port, ref = responses
    n = 0
    for (kind, op, _), p, r in zip(steps, port, ref):
        if ".png" not in op:
            continue
        assert p[1] == r[1] == 200 and p[2] == r[2] == "image/png", op
        a, b = _pixels(p[0]), _pixels(r[0])
        assert a.shape == b.shape and a.dtype == b.dtype, op
        np.testing.assert_array_equal(a, b, err_msg=op)
        n += 1
    assert n == 5


def test_app_shell_and_errors_match_reference(responses):
    steps, port, ref = responses
    for (kind, op, _), p, r in zip(steps, port, ref):
        if kind == "get" and op in ("", "api/nothing"):
            assert p == r, op
    errors = [p for (k, op, _), p in zip(steps, port) if k == "post" and p[1] != 200]
    assert [e[1] for e in errors] == [400, 400]  # the locked exclusion, the unknown op
