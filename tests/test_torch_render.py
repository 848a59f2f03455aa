"""tpu_inspect_torch.render vs tpu_inspect.render on the same inputs.

The overlays, markers and thumbnails are numpy copies and must give equal
arrays; the erosion outline runs through kernels I and J (their plain
versions here, ``device="cpu"``) and must equal the JAX package's. Seeded
inputs; tolerance 0.
"""

import numpy as np
import pytest

import tpu_inspect.config as jcfg
from tpu_inspect import render as jrender
from tpu_inspect.geometry import BoxGrid as JBoxGrid

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import render as trender
from tpu_inspect_torch.geometry import BoxGrid

JGRID = jcfg.GridParams(base_unit=(6, 8, 48, 44), units_x=2, units_y=2, unit_space_x=3)
TGRID = tcfg.GridParams(base_unit=(6, 8, 48, 44), units_x=2, units_y=2, unit_space_x=3)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(7)
    image = rng.randint(0, 256, (110, 118), dtype=np.uint8)
    seg = ((rng.rand(4, 44, 48) > 0.4) * 255).astype(np.uint8)
    seg[:, 8:36, 8:40] = 255  # a mold surface with a hole
    seg[:, 18:24, 18:26] = 0
    seg[3] = 0
    defect = ((rng.rand(4, 44, 48) > 0.9) * 255).astype(np.uint8)
    return image, seg, defect


@pytest.mark.parametrize("mode", ["None", "Segmentation", "Defect", "Both"])
def test_render_canvas_matches_reference(scene, mode):
    image, seg, defect = scene
    dlist = [defect[0], None, defect[2], None]
    for selected in (None, 2):
        got = trender.render_canvas(image, TGRID, seg, dlist, mode, selected)
        ref = jrender.render_canvas(image, JGRID, seg, dlist, mode, selected)
        np.testing.assert_array_equal(got, ref)


def test_markers_thumbnails_and_tints_match_reference(scene):
    image, seg, defect = scene
    verdicts = np.array([True, False, True, False])
    np.testing.assert_array_equal(trender.render_inspection(image, TGRID, verdicts),
                                  jrender.render_inspection(image, JGRID, verdicts))
    np.testing.assert_array_equal(trender.render_inspection(image, TGRID, {1: True, 3: None}),
                                  jrender.render_inspection(image, JGRID, {1: True, 3: None}))
    for mode in ("None", "Segmentation", "Defect", "Both"):
        for size in (128, 33):
            np.testing.assert_array_equal(
                trender.thumbnail_icon(image[8:52, 6:54], seg[0], defect[0], mode, size),
                jrender.thumbnail_icon(image[8:52, 6:54], seg[0], defect[0], mode, size))
    np.testing.assert_array_equal(trender.combine_masks(seg[0], defect[0]),
                                  jrender.combine_masks(seg[0], defect[0]))
    assert trender.combine_masks(None, None) is None
    np.testing.assert_array_equal(trender.tint_mask(seg[1], trender.SEG_COLOR, 140),
                                  jrender.tint_mask(seg[1], jrender.SEG_COLOR, 140))
    boxes = ((0, 0, 40, 30), (50, 60, 40, 30), (100, 90, 40, 30))  # the last one clipped
    np.testing.assert_array_equal(
        trender.render_canvas(image, BoxGrid(boxes), seg[:3, :30, :40], mode="Both"),
        jrender.render_canvas(image, JBoxGrid(boxes), seg[:3, :30, :40], mode="Both"))


@pytest.mark.parametrize("erode_px", [0, 1, 3, 6, 30])
def test_erosion_outline_matches_reference(scene, erode_px):
    """Kernel I's erodes and kernel J's largest component (plain versions
    on the CPU); a large erode empties the mask (None)."""
    _, seg, _ = scene
    for u in range(seg.shape[0]):
        got = trender.erosion_outline_mask(seg[u], erode_px, device="cpu")
        ref = jrender.erosion_outline_mask(seg[u], erode_px)
        if ref is None:
            assert got is None
        else:
            assert got.dtype == ref.dtype == bool
            np.testing.assert_array_equal(got, ref)
    box = (6, 8, 48, 44)
    assert trender.erosion_outline(None, box, erode_px, device="cpu") == \
        jrender.erosion_outline(None, box, erode_px)
    kind, val = trender.erosion_outline(seg[0], box, min(erode_px, 6), device="cpu")
    jkind, jval = jrender.erosion_outline(seg[0], box, min(erode_px, 6))
    assert kind == jkind == "mask"
    np.testing.assert_array_equal(val, jval)
