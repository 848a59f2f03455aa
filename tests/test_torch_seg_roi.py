"""Kernel K's contract (``ops.fused.seg_roi_tail``) and the chained engine
path of tpu_inspect_torch vs the JAX package, on the CPU.

The JAX side runs ``seg_roi_tail_paired_pallas`` in Pallas interpret mode
(``pl.pallas_call`` patched as ``tests/test_fused_interpret.py`` does) and
its ``_inspect_image_device`` with the chain flag forced on; the port runs
the plain version of kernel K. Tolerance: exact equality everywhere (masks,
integer stats, centroids, verdicts; dtypes included).
"""

import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_inspect import engine as jeng
from tpu_inspect.config import DefectParams as JDefect
from tpu_inspect.config import SegmentationParams as JSeg
from tpu_inspect.ops import threshold as jthr
from tpu_inspect.ops.gaussian import gaussian_blur_u8 as j_blur
from tpu_inspect.ops.morph_pallas import _close_open_stages

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.geometry import BoxGrid
from tpu_inspect_torch.ops.fused import seg_roi_tail, seg_roi_tail_plain
from tpu_inspect_torch.ops.morphology import close_open_stages, rect_erode_stages

_ORIG_PALLAS_CALL = pl.pallas_call


def _interpreted(*args, **kwargs):
    kwargs.setdefault("interpret", True)
    return _ORIG_PALLAS_CALL(*args, **kwargs)


@pytest.fixture()
def fp():
    """tpu_inspect.ops.fused_pallas reloaded with pallas_call forced to
    interpret (restored afterwards)."""
    with mock.patch.object(pl, "pallas_call", _interpreted):
        import tpu_inspect.ops.fused_pallas as mod

        importlib.reload(mod)
        yield mod
    importlib.reload(mod)


@pytest.mark.parametrize("erode,with_zone", [(2, True), (0, True), (2, False)])
def test_seg_roi_tail_matches_jax_interpret(fp, erode, with_zone):
    """The 12 outputs of the JAX kernel equal the port's 4 (seg mask, seg
    stats, ROI mask, ROI stats) at 5x40x44: an odd unit count, the seg
    stats taken before the zone and the ROI after it."""
    rng = np.random.RandomState(7)
    u, h, w = 5, 40, 44
    crops = rng.randint(0, 256, (u, h, w), dtype=np.uint8)
    crops[1] = 255  # an empty unit (nothing at or below the threshold)
    x = j_blur(jnp.asarray(crops), 3)
    thr = jthr.otsu_threshold(x)
    zone = np.zeros((h, w), np.uint8)
    zone[8:20, 10:30] = 1
    got_j = fp.seg_roi_tail_paired_pallas(
        x, _close_open_stages(3), jeng._roi_erode_stages(erode), thr,
        zone=jnp.asarray(zone) if with_zone else None, use_zone=with_zone,
    )
    got_j = [np.asarray(a) for a in got_j]
    xt = torch.from_numpy(np.array(x))
    thr_t = torch.from_numpy(np.asarray(thr).astype(np.int32))
    zone_t = torch.from_numpy(zone) if with_zone else None
    mask, st, roi, roi_st = seg_roi_tail(
        xt, close_open_stages(3), rect_erode_stages(erode), thr_t, zone_t
    )
    ours = [mask, st[:, 0], st[:, 1], st[:, 2], st[:, 3] > 0, roi, roi_st[:, 0],
            roi_st[:, 3] > 0, roi_st[:, 4], roi_st[:, 5], roi_st[:, 6], roi_st[:, 7]]
    for i, (a, b) in enumerate(zip(ours, got_j)):
        a = a.numpy()
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
    assert not st[1, 3] and roi_st[:, 3].any()


def test_seg_roi_tail_checks_its_zone():
    x = torch.zeros((2, 8, 9), dtype=torch.uint8)
    thr = torch.zeros((2,), dtype=torch.int32)
    for bad in (torch.zeros((8, 8), dtype=torch.uint8), torch.zeros((8, 9), dtype=torch.int32),
                torch.zeros((1, 8, 9), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            seg_roi_tail(x, (), (), thr, bad)
    out = seg_roi_tail(x, (), (), thr, torch.ones((8, 9), dtype=torch.bool))
    ref = seg_roi_tail_plain(x, (), (), thr, torch.ones((8, 9), dtype=torch.uint8))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert not out[0].any()  # every pixel excluded


def test_chained_inspect_image_matches_jax(fp, monkeypatch):
    """The port's inspect_image(device="cpu") with the chain flag on (kernel
    K's plain version, then the defect pass from its ROI) against the JAX
    package's chained ``_inspect_image_device``; the inputs of
    ``test_fused_interpret.py``'s chained engine test."""
    rng = np.random.RandomState(21)
    uh, uw = 40, 44
    image = rng.randint(0, 256, (100, 140), dtype=np.uint8)
    origins = np.array(
        [[2, 2], [48, 2], [94, 2], [2, 50], [48, 50], [94, 50]], dtype=np.int32
    )
    excl = [{"shape": "rect", "x": 5, "y": 6, "w": 10, "h": 8}]
    rects, circles = jeng.pack_exclusions(excl)
    u = origins.shape[0]
    monkeypatch.setattr(jeng, "_ENABLE_CHAIN", True)
    monkeypatch.setattr(jeng, "_seg_roi_chain_fits", lambda *_a, **_k: True)
    jax.clear_caches()
    mask, sums, has_fg, dxy, (dm, found, area, verdict) = jeng._inspect_image_device(
        jnp.asarray(image), jnp.asarray(origins), jnp.asarray(rects), jnp.asarray(circles),
        jnp.zeros((u, 2), jnp.float64), jnp.zeros((u,), bool),
        seg=JSeg(gaussian_blur=3, morph_kernel=3).validated(),
        defect=JDefect(median_k=5, erode_px=2, threshold=20, min_area=3).validated(),
        is_reference=True, unit_hw=(uh, uw), with_defects=True,
    )
    jax.clear_caches()

    calls = []
    real = teng._segment_roi
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", True)
    monkeypatch.setattr(teng, "_segment_roi", lambda *a, **k: calls.append(1) or real(*a, **k))
    grid = BoxGrid(tuple((int(x), int(y), uw, uh) for x, y in origins))
    seg_r, insp = teng.inspect_image(
        image, grid, tcfg.SegmentationParams(gaussian_blur=3, morph_kernel=3),
        tcfg.DefectParams(median_k=5, erode_px=2, threshold=20, min_area=3),
        exclusions=excl, device="cpu",
    )
    assert calls == [1]
    pairs = [
        (seg_r.masks, mask), (seg_r.centroids, jeng.centroids_from_sums(np.asarray(sums))),
        (seg_r.centroid_valid, has_fg), (seg_r.shifts, dxy), (insp.defect_masks, dm),
        (insp.valid, found), (insp.areas, np.asarray(area).astype(np.int64)),
        (insp.verdicts, verdict),
    ]
    for i, (a, b) in enumerate(pairs):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"field {i}")
    assert insp.valid.any()


def test_chain_gate(monkeypatch):
    """Kernel K runs only with the flag set, for otsu, off the whole-image
    route; the engine takes it only on the reference capture with defects."""
    seg, ad = tcfg.SegmentationParams().validated(), tcfg.SegmentationParams(method="adaptive")
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", False)
    assert not teng._seg_roi_chain_fits((48, 315, 316), seg)
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", True)
    assert teng._seg_roi_chain_fits((48, 315, 316), seg)
    assert not teng._seg_roi_chain_fits((48, 315, 316), ad.validated())
    assert not teng._seg_roi_chain_fits((1, 3000, 4096), seg)

    calls = []
    monkeypatch.setattr(teng, "_segment_roi", lambda *a, **k: calls.append(1))
    grid = tcfg.GridParams(base_unit=(2, 2, 20, 16), units_x=2)
    img = np.random.RandomState(3).randint(0, 256, (24, 50), dtype=np.uint8)
    teng.inspect_image(img, grid, seg, None, device="cpu")
    teng.inspect_image(img, grid, seg, tcfg.DefectParams(), is_reference=False,
                       ref_centroids={0: (9.0, 8.0)}, device="cpu")
    assert calls == []
