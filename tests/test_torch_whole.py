"""The whole-image route of ``tpu_inspect_torch.engine`` vs the JAX engine.

A unit of more than ``engine.WHOLE_MIN_PX`` pixels (a whole 4096x3000
capture) skips kernels A and C: kernels D and E run on the whole plane,
kernel F (``ops.cc.component_stats``) takes the largest-component stats and
kernel G (``ops.blob_select.blob_select``) the Green's filter and paint.
Here the route runs on the CPU (the kernels' plain versions) at small
sizes, with the gate lowered, and is held with tolerance 0, dtypes
included, against the JAX engine (``inspect_image``, ``segment_units``,
``detect_defects_batch`` on its CPU backend, where a whole-image unit takes
the same unfused path) for the four method combos, a circle exclusion, a
shifted capture, an empty and a full plane. ``test_torch_whole_ops.py``
holds kernels F, G and B of the route against the JAX package's
whole-image functions.
"""

import numpy as np
import pytest

import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng
from tpu_inspect.synthetic import crop_units

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.synthetic import make_mold_image

GRID = tcfg.GridParams(base_unit=(6, 5, 128, 96))  # one 96x128 unit
IMAGE_HW = (108, 142)
EXCLUSIONS = [{"shape": "circle", "cx": 40, "cy": 30, "r": 9}]
SEG_FIELDS = ("masks", "centroids", "centroid_valid", "shifts")
INSP_FIELDS = ("defect_masks", "valid", "areas", "verdicts")
COMBOS = [("otsu", "threshold"), ("adaptive", "threshold"), ("otsu", "canny"),
          ("adaptive", "canny")]
# a capture shifted by (3, -2), and segment_units / detect_defects_batch
# (one combo each: each JAX compile costs 1-3 s)
SHIFTED = {("otsu", "threshold")}


def _spy(monkeypatch):
    """Count the engine's calls of the route's kernels and of kernels A, C."""
    calls = dict.fromkeys(("component_stats", "blob_select", "seg_tail", "blob_filter"), 0)
    for name in calls:
        orig = getattr(teng, name)

        def wrapped(*a, _name=name, _orig=orig, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(teng, name, wrapped)
    return calls


@pytest.fixture()
def route(monkeypatch):
    """The gate lowered so a 96x128 unit takes the whole-image route."""
    monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
    return _spy(monkeypatch)


def _j(obj):
    return getattr(jcfg, type(obj).__name__)(**obj.__dict__)


def _assert_equal(got, ref, fields, label):
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f"{label} {f}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


def test_gate_at_its_default(monkeypatch):
    assert teng.WHOLE_MIN_PX == 1 << 20
    assert not teng._whole_route(315, 316)
    assert teng._whole_route(1, 2**20 + 1)
    assert teng._whole_route(3000, 4096)
    # kernel A's and C's int32 bounds route a unit below the pixel gate too
    assert teng._whole_route(20, 2**20 // 20)
    calls = _spy(monkeypatch)
    seg = tcfg.SegmentationParams(gaussian_blur=0, morph_kernel=0)
    teng.segment_units(np.zeros((1, 315, 316), np.uint8), seg, device="cpu")
    assert calls["seg_tail"] == 1 and calls["component_stats"] == 0
    crop = np.zeros((1, 2, 2**19 + 1), np.uint8)  # 2^20 + 2 px
    teng.segment_units(crop, seg, device="cpu")
    assert calls["seg_tail"] == 1 and calls["component_stats"] == 1


@pytest.mark.parametrize("seg_m,def_m", COMBOS)
def test_route_matches_jax_engine(route, seg_m, def_m):
    ref_img = make_mold_image(GRID, IMAGE_HW, seed=3, defect_rate=1.0)
    shifted = make_mold_image(GRID, IMAGE_HW, seed=4, defect_rate=1.0, shift=(3, -2))
    seg = tcfg.SegmentationParams(method=seg_m)
    dp = tcfg.DefectParams(method=def_m, min_area=3)
    s, i = teng.inspect_image(ref_img, GRID, seg, dp, exclusions=EXCLUSIONS, device="cpu")
    js, ji = jeng.inspect_image(ref_img, _j(GRID), _j(seg), _j(dp), exclusions=EXCLUSIONS)
    _assert_equal(s, js, SEG_FIELDS, "reference")
    _assert_equal(i, ji, INSP_FIELDS, "reference")
    assert i.verdicts.all(), "defect_rate=1.0 with min_area 3 gives an NG unit"
    assert route == {"component_stats": 2, "blob_select": 1, "seg_tail": 0, "blob_filter": 0}
    if (seg_m, def_m) not in SHIFTED:
        return
    s2, i2 = teng.inspect_image(
        shifted, GRID, seg, dp, exclusions=EXCLUSIONS,
        ref_centroids=s.centroid_dict(), is_reference=False, device="cpu",
    )
    js2, ji2 = jeng.inspect_image(
        shifted, _j(GRID), _j(seg), _j(dp), exclusions=EXCLUSIONS,
        ref_centroids=js.centroid_dict(), is_reference=False,
    )
    _assert_equal(s2, js2, SEG_FIELDS, "shifted")
    _assert_equal(i2, ji2, INSP_FIELDS, "shifted")
    assert (s2.shifts != 0).any(), "the shifted capture must move the exclusion"

    crops = crop_units(ref_img, _j(GRID))
    su = teng.segment_units(crops, seg, EXCLUSIONS, device="cpu")
    _assert_equal(su, jeng.segment_units(crops, _j(seg), EXCLUSIONS), SEG_FIELDS,
                  "segment_units")
    d = teng.detect_defects_batch(crops, su.masks, dp, device="cpu")
    _assert_equal(d, jeng.detect_defects_batch(crops, su.masks, _j(dp)), INSP_FIELDS,
                  "detect_defects_batch")
    assert route["seg_tail"] == 0 and route["blob_filter"] == 0


@pytest.mark.parametrize("value", [0, 255])
def test_route_empty_and_full_plane(route, value):
    # the combos' shapes and parameters, so the JAX engine reuses their compiles
    crops = np.full((1, 96, 128), value, np.uint8)
    seg = tcfg.SegmentationParams()
    dp = tcfg.DefectParams(min_area=3)
    s = teng.segment_units(crops, seg, EXCLUSIONS, device="cpu")
    _assert_equal(s, jeng.segment_units(crops, _j(seg), EXCLUSIONS), SEG_FIELDS,
                  f"plane {value}")
    for mask in (s.masks, crops):
        got = teng.detect_defects_batch(crops, mask, dp, device="cpu")
        _assert_equal(got, jeng.detect_defects_batch(crops, mask, _j(dp)), INSP_FIELDS,
                      f"plane {value}")
    assert route["component_stats"] > 0 and route["seg_tail"] == 0
