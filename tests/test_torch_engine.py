"""The port's engine end to end vs the JAX engine, bit-exact.

``tpu_inspect_torch.engine.inspect_image(device="cpu")`` (plain PyTorch
versions of the kernels) against ``tpu_inspect.engine.inspect_image`` (JAX
on its CPU backend, so its XLA fallbacks run) on a small 2x2 grid: a
reference capture, then a shifted capture aligned to the reference's
anchors, with one rect and one circle exclusion, for all four
otsu/adaptive x threshold/canny method combos. Every field is compared
with exact equality, dtypes included. ``engine.raw_segment`` and
``engine.defect_roi`` are held against the JAX functions of the same names
on a few 64x64 units (kernel A's route) and on one 96x128 unit with the
whole-image gate lowered (kernels D, E and F).
"""

import numpy as np
import pytest
import torch

import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng
from tpu_inspect.synthetic import crop_units

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.synthetic import make_mold_image

GRID = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
IMAGE_HW = (110, 120)
EXCLUSIONS = [
    {"shape": "rect", "x": 5, "y": 6, "w": 10, "h": 8},
    {"shape": "circle", "cx": 30, "cy": 25, "r": 6},
]
SEG_FIELDS = ("masks", "centroids", "centroid_valid", "shifts")
INSP_FIELDS = ("defect_masks", "valid", "areas", "verdicts")


def _j(obj):
    return getattr(jcfg, type(obj).__name__)(**obj.__dict__)


def _assert_equal(got, ref, fields, label):
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f"{label} {f}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


@pytest.fixture(scope="module")
def captures():
    ref_img = make_mold_image(GRID, IMAGE_HW, seed=3, defect_rate=1.0)
    shifted = make_mold_image(GRID, IMAGE_HW, seed=4, defect_rate=1.0, shift=(3, -2))
    return ref_img, shifted


@pytest.mark.parametrize("seg_kw,def_kw,expect_ng", [
    ({}, {"min_area": 3}, True),
    ({"gaussian_blur": 4, "morph_kernel": 5}, {"min_area": 0, "erode_px": 2,
                                               "median_k": 8, "threshold": 30}, False),
    # the three other method combos (adaptive block 201 > the 44x48 unit)
    ({"method": "adaptive"}, {"min_area": 3}, True),
    ({}, {"method": "canny", "min_area": 3}, True),
    ({"method": "adaptive", "adapt_block": 201, "adapt_C": -5},
     {"method": "canny", "min_area": 2, "erode_px": 2, "threshold": 60}, None),
])
def test_inspect_image_matches_jax_engine(captures, seg_kw, def_kw, expect_ng):
    ref_img, shifted = captures
    seg = tcfg.SegmentationParams(**seg_kw)
    dp = tcfg.DefectParams(**def_kw)
    s, i = teng.inspect_image(ref_img, GRID, seg, dp, exclusions=EXCLUSIONS, device="cpu")
    js, ji = jeng.inspect_image(ref_img, _j(GRID), _j(seg), _j(dp), exclusions=EXCLUSIONS)
    _assert_equal(s, js, SEG_FIELDS, "reference")
    _assert_equal(i, ji, INSP_FIELDS, "reference")
    if expect_ng is not None:
        assert i.verdicts.any() == expect_ng, "defect_rate=1.0 with min_area 3 gives an NG unit"

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
    assert (s2.shifts != 0).any(), "the shifted capture must move exclusions"


@pytest.mark.parametrize("seg_m,def_m", [
    ("otsu", "threshold"), ("adaptive", "threshold"), ("otsu", "canny"), ("adaptive", "canny"),
])
def test_unit_level_entry_points_match_jax_engine(captures, seg_m, def_m):
    ref_img, _ = captures
    crops = crop_units(ref_img, _j(GRID))
    seg = tcfg.SegmentationParams(method=seg_m)
    dp = tcfg.DefectParams(method=def_m, min_area=3)
    s = teng.segment_units(crops, seg, EXCLUSIONS, device="cpu")
    js = jeng.segment_units(crops, _j(seg), EXCLUSIONS)
    _assert_equal(s, js, SEG_FIELDS, "segment_units")
    d = teng.detect_defects_batch(crops, s.masks, dp, device="cpu")
    jd = jeng.detect_defects_batch(crops, js.masks, _j(dp))
    _assert_equal(d, jd, INSP_FIELDS, "detect_defects_batch")
    s3, d3 = teng.inspect_units(
        crops, seg, dp, EXCLUSIONS, ref_centroids=s.centroids,
        is_reference=False, device="cpu",
    )
    js3, jd3 = jeng.inspect_units(
        crops, _j(seg), _j(dp), EXCLUSIONS, ref_centroids=js.centroids,
        is_reference=False,
    )
    _assert_equal(s3, js3, SEG_FIELDS, "inspect_units")
    _assert_equal(d3, jd3, INSP_FIELDS, "inspect_units")
    assert s.centroid_dict() == js.centroid_dict()


def test_unported_methods_raise(captures):
    """The median windows that once raised NotImplementedError here
    (k*k >= 2048) now answer as the JAX engine does, through both entry
    points; no method of the port raises for being unported. (The
    diagnostic pass at k = 47 is held against the JAX package's in
    tests/test_torch_median_blur.py, where its compile is paid once.)"""
    ref_img = captures[0]
    seg, dp = tcfg.SegmentationParams(), tcfg.DefectParams(min_area=3, median_k=47)
    s, i = teng.inspect_image(ref_img, GRID, seg, dp, exclusions=EXCLUSIONS, device="cpu")
    js, ji = jeng.inspect_image(ref_img, _j(GRID), _j(seg), _j(dp), exclusions=EXCLUSIONS)
    _assert_equal(s, js, SEG_FIELDS, "median_k=47")
    _assert_equal(i, ji, INSP_FIELDS, "median_k=47")
    x, y, w, h = 4, 6, 48, 44  # unit 0
    d = teng.defect_intermediates(ref_img[y:y + h, x:x + w], s.masks[0], dp, device="cpu")
    assert not d["roi_empty"] and "resid_area" in d
    img =np.zeros((60, 60), np.uint8)
    grid = tcfg.GridParams(base_unit=(0, 0, 20, 20))
    # Canny reads no median window
    teng.inspect_image(img, grid, tcfg.SegmentationParams(),
                       tcfg.DefectParams(method="canny", median_k=47), device="cpu")
    seg_only, none = teng.inspect_image(img, grid, tcfg.SegmentationParams(), device="cpu")
    assert none is None and seg_only.masks.shape == (1, 20, 20)


# raw_segment and defect_roi on a few 64x64 units (kernel A's route), and
# on one 96x128 unit with the whole-image gate lowered (kernels D, E, F)
RAW_GRID = tcfg.GridParams(base_unit=(3, 4, 64, 64), units_x=2, units_y=2)
WHOLE_GRID = tcfg.GridParams(base_unit=(6, 5, 128, 96))


def _raw_crops(route, monkeypatch):
    if route == "whole":
        monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
        grid, hw = WHOLE_GRID, (108, 142)
    else:
        grid, hw = RAW_GRID, (140, 140)
    crops = crop_units(make_mold_image(grid, hw, seed=5, defect_rate=1.0), _j(grid))
    assert teng._whole_route(*crops.shape[1:]) == (route == "whole")
    return crops, torch.from_numpy(np.ascontiguousarray(crops))


@pytest.mark.parametrize("route", ["units", "whole"])
@pytest.mark.parametrize("method", ["otsu", "adaptive"])
def test_raw_segment_matches_jax(route, method, monkeypatch):
    crops, crops_t = _raw_crops(route, monkeypatch)
    seg = tcfg.SegmentationParams(method=method)
    got = teng.raw_segment(crops_t, seg).numpy()
    ref = np.asarray(jeng.raw_segment(crops, _j(seg).validated()))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("route", ["units", "whole"])
@pytest.mark.parametrize("erode_px", [0, 6])
def test_defect_roi_matches_jax(route, erode_px, monkeypatch):
    crops, crops_t = _raw_crops(route, monkeypatch)
    masks = teng.raw_segment(crops_t, tcfg.SegmentationParams())
    roi, empty = teng.defect_roi(masks, erode_px)
    j_roi, j_empty = jeng.defect_roi(masks.numpy(), erode_px)
    assert roi.dtype == torch.bool and empty.dtype == torch.bool
    np.testing.assert_array_equal(roi.numpy(), np.asarray(j_roi))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(j_empty))
    assert roi.numpy().any()
