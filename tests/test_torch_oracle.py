"""The port's OpenCV oracle copy and the port's engine against it.

``tpu_inspect_torch.oracle`` (numpy + cv2, the port's own configuration and
``geometry.exclusion_mask``) must equal ``tpu_inspect.oracle`` on the same
seeded inputs; the port's engine on the CPU (the kernels' plain versions)
must equal the oracle copy, as the JAX engine equals the JAX oracle
(``tests/test_engine_defect.py``; the seeded cross-product fuzz over the
reference's configuration is in ``tests/test_torch_fuzz.py``). Every
comparison is exact.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import tpu_inspect.config as jcfg
from tpu_inspect import oracle as joracle
from tpu_inspect.geometry import exclusion_mask as j_exclusion_mask

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch import oracle as toracle
from tpu_inspect_torch.geometry import exclusion_mask
from tpu_inspect_torch.ops.morphology import apply_stages, close_open_stages, ellipse_se
from tpu_inspect_torch.synthetic import crop_units, make_mold_image

ROOT = Path(__file__).resolve().parent.parent
GRID = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
IMAGE_HW = (110, 120)
EXCLUSIONS = [
    {"shape": "rect", "x": 5, "y": 6, "w": 10, "h": 8},
    {"shape": "circle", "cx": 30, "cy": 25, "r": 6},
]


def _j(obj):
    return getattr(jcfg, type(obj).__name__)(**obj.__dict__)


def _assert_defects_equal(got, ref, label):
    dms, areas, verdicts = got
    rdms, rareas, rverdicts = ref
    assert len(dms) == len(rdms), label
    for i, (a, b) in enumerate(zip(dms, rdms)):
        assert (a is None) == (b is None), f"{label} unit {i}: detection differs"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} unit {i}")
    np.testing.assert_array_equal(areas, rareas, err_msg=label)
    np.testing.assert_array_equal(verdicts, rverdicts, err_msg=label)


def _assert_vs_oracle(insp, ref, label):
    """An engine InspectionResult against the oracle's (masks or None,
    areas, verdicts)."""
    rdms, rareas, rverdicts = ref
    for i, dm in enumerate(rdms):
        assert bool(insp.valid[i]) == (dm is not None), f"{label} unit {i}: detection"
        if dm is not None:
            np.testing.assert_array_equal(insp.defect_masks[i], dm, err_msg=f"{label} unit {i}")
    np.testing.assert_array_equal(insp.areas, rareas, err_msg=label)
    np.testing.assert_array_equal(insp.verdicts, rverdicts, err_msg=label)


@pytest.fixture(scope="module")
def captures():
    ref_img = make_mold_image(GRID, IMAGE_HW, seed=3, defect_rate=1.0)
    shifted = make_mold_image(GRID, IMAGE_HW, seed=4, defect_rate=1.0, shift=(3, -2))
    return ref_img, shifted


@pytest.mark.parametrize("excl", [
    EXCLUSIONS,
    [{"shape": "rect", "x": -5, "y": 40, "w": 30, "h": 30}, {"shape": "circle", "r": 0}],
    [{"shape": "circle", "cx": 60, "cy": -3, "r": 9}, {"shape": "rect", "w": "x"}, None, 7],
    [],
])
@pytest.mark.parametrize("dxy", [(0, 0), (3, -2), (-50, 70)])
def test_exclusion_mask_matches_jax_package(excl, dxy):
    got = exclusion_mask(excl, 44, 48, *dxy)
    np.testing.assert_array_equal(got, j_exclusion_mask(excl, 44, 48, *dxy))
    assert got.dtype == bool and got.shape == (44, 48)


@pytest.mark.parametrize("seg_kw,def_kw", [
    ({}, {"min_area": 3}),
    ({"method": "adaptive", "adapt_block": 31, "adapt_C": 3}, {"min_area": 3, "erode_px": 2}),
    ({"gaussian_blur": 0, "morph_kernel": 0}, {"method": "canny", "threshold": 40}),
])
def test_oracle_copy_matches_jax_oracle(captures, seg_kw, def_kw):
    ref_img, shifted = captures
    seg, dp = tcfg.SegmentationParams(**seg_kw), tcfg.DefectParams(**def_kw)
    crops = crop_units(ref_img, GRID)
    masks, cents, shifts = toracle.segment_all_units(crops, seg, EXCLUSIONS)
    jmasks, jcents, jshifts = joracle.segment_all_units(crops, _j(seg), EXCLUSIONS)
    np.testing.assert_array_equal(masks, jmasks)
    np.testing.assert_array_equal(shifts, jshifts)
    assert cents == jcents and cents, "reference anchors"
    _assert_defects_equal(
        toracle.inspect_units(crops, masks, dp), joracle.inspect_units(crops, masks, _j(dp)),
        "reference",
    )
    crops2 = crop_units(shifted, GRID)
    m2, _, s2 = toracle.segment_all_units(crops2, seg, EXCLUSIONS, cents, is_reference=False)
    jm2, _, js2 = joracle.segment_all_units(crops2, _j(seg), EXCLUSIONS, jcents, is_reference=False)
    np.testing.assert_array_equal(m2, jm2)
    np.testing.assert_array_equal(s2, js2)
    g = crops[0]
    np.testing.assert_array_equal(toracle.fill_holes(g > 128), joracle.fill_holes(g > 128))
    assert toracle.mask_stats(masks[0]) == joracle.mask_stats(masks[0])
    assert toracle.largest_component_centroid(masks[1]) == joracle.largest_component_centroid(
        masks[1])


@pytest.mark.parametrize("seg_m,def_m", [("otsu", "threshold"), ("adaptive", "canny")])
def test_inspect_image_cpu_matches_oracle_copy(captures, seg_m, def_m):
    """The port's ``inspect_image(device="cpu")`` on the reference capture
    and on a shifted capture aligned to its anchors equals the oracle copy
    run on the same crops."""
    ref_img, shifted = captures
    seg = tcfg.SegmentationParams(method=seg_m)
    dp = tcfg.DefectParams(method=def_m, min_area=3)
    s, i = teng.inspect_image(ref_img, GRID, seg, dp, exclusions=EXCLUSIONS, device="cpu")
    crops = crop_units(ref_img, GRID)
    masks, cents, _ = toracle.segment_all_units(crops, seg, EXCLUSIONS)
    np.testing.assert_array_equal(s.masks, masks)
    assert s.centroid_dict() == cents
    _assert_vs_oracle(i, toracle.inspect_units(crops, masks, dp), "reference")
    s2, i2 = teng.inspect_image(
        shifted, GRID, seg, dp, exclusions=EXCLUSIONS, ref_centroids=cents,
        is_reference=False, device="cpu",
    )
    crops2 = crop_units(shifted, GRID)
    m2, _, sh2 = toracle.segment_all_units(crops2, seg, EXCLUSIONS, cents, is_reference=False)
    np.testing.assert_array_equal(s2.masks, m2)
    np.testing.assert_array_equal(s2.shifts, sh2)
    assert (sh2 != 0).any(), "the shifted capture must move exclusions"
    _assert_vs_oracle(i2, toracle.inspect_units(crops2, m2, dp), "shifted")


def test_oracle_copy_imports_no_jax():
    code = (
        "import sys, tpu_inspect_torch.oracle; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpu_inspect' or m.startswith('tpu_inspect.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6, 31])
def test_close_open_stages_match_cv2(k):
    """The port's close/open stage chain equals cv2's MORPH_CLOSE then
    MORPH_OPEN with the k x k ellipse, the even sizes (off-centre anchor)
    included."""
    rng = np.random.RandomState(k)
    x = (rng.rand(3, 40, 52) < 0.5).astype(np.uint8) * 255
    se = ellipse_se(k)
    ref = np.stack([
        cv2.morphologyEx(cv2.morphologyEx(u, cv2.MORPH_CLOSE, se), cv2.MORPH_OPEN, se) for u in x
    ])
    np.testing.assert_array_equal(apply_stages(torch.from_numpy(x), close_open_stages(k)).numpy(), ref)
