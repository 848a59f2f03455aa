"""The full median blur (kernel H's plain version) and the defect pass with
a median window of k*k >= 2048 vs the JAX package.

Same seeded numpy inputs through both packages (JAX on its CPU backend,
where ``median.median_blur_u8`` is the XLA histogram scan that the JAX
package's own tests hold ``median_blur_u8_pallas`` to); tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng
from tpu_inspect.ops import median as jmed

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.ops.median import median_blur_u8, median_blur_u8_plain
from tpu_inspect_torch.imageio import crops_for_grid
from tpu_inspect_torch.synthetic import make_mold_image

GRID = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)


@pytest.fixture(scope="module")
def crops():
    img = make_mold_image(GRID, (110, 120), seed=3, defect_rate=1.0)
    return crops_for_grid(img, GRID, "cpu").numpy()


@pytest.mark.parametrize("k", [1, 3, 5, 47, 49, 101])
def test_median_blur_matches_reference(k):
    """Exact medians with clamped windows, also where k exceeds the unit
    (37 x 29 here) and for a flat unit."""
    rng = np.random.RandomState(k)
    x = rng.randint(0, 256, (3, 37, 29), dtype=np.uint8)
    x[1] = 9
    x[2, :, :4] = 0
    got = median_blur_u8(torch.from_numpy(x), k)
    ref = np.asarray(jmed._median_blur_u8_scan(jnp.asarray(x), k))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.uint8


def test_median_blur_rows_per_step_and_bad_k():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(0, 256, (2, 19, 23), dtype=np.uint8))
    ref = median_blur_u8_plain(x, 7)
    for rows in (1, 5, 64):
        assert torch.equal(median_blur_u8_plain(x, 7, rows_per_step=rows), ref)
    assert median_blur_u8(x, 1) is x
    for k in (0, 4, -3):
        with pytest.raises(ValueError):
            median_blur_u8(x, k)


KW = dict(threshold=20, min_area=3, erode_px=2, median_k=47)
EXCL = [{"shape": "circle", "cx": 30, "cy": 25, "r": 6}]


@pytest.fixture(scope="module")
def reference(crops):
    """The JAX engine's inspect_units with median_k = 47 on the crops."""
    return jeng.inspect_units(crops, jcfg.SegmentationParams(), jcfg.DefectParams(**KW),
                              exclusions=EXCL)


def _port(crops):
    return teng.inspect_units(crops, tcfg.SegmentationParams(), tcfg.DefectParams(**KW),
                              exclusions=EXCL, device="cpu")


def _assert_same(port, reference, areas_dtype=True):
    (t_seg, t_insp), (j_seg, j_insp) = port, reference
    np.testing.assert_array_equal(t_seg.masks, j_seg.masks)
    for f in ("defect_masks", "valid", "areas", "verdicts"):
        a, b = getattr(t_insp, f), np.asarray(getattr(j_insp, f))
        if f != "areas" or areas_dtype:
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t_insp.valid.any()


def test_inspect_units_large_median_matches_reference(crops, reference):
    """The threshold method with k*k >= 2048: the full median over every
    row, |x - bg| > thr, then the blob filter; and the diagnostic pass."""
    port = _port(crops)
    _assert_same(port, reference)
    t_seg, t_insp = port
    u = int(np.flatnonzero(t_insp.valid)[0])
    got = teng.defect_intermediates(crops[u], t_seg.masks[u], tcfg.DefectParams(**KW),
                                    device="cpu")
    assert got["resid_area"] > 0
    assert got == jeng.defect_intermediates(crops[u], reference[0].masks[u],
                                            jcfg.DefectParams(**KW))


def test_whole_route_large_median_matches_reference(crops, reference, monkeypatch):
    """The same branch on the whole-image route (the gate lowered so that
    these units take it): kernel H, then kernels D, E, F, G and I in place
    of A and C (int64 areas on that route)."""
    monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
    _assert_same(_port(crops), reference, areas_dtype=False)


def test_even_large_median_k_rounds_up(crops):
    """An even median_k takes the next odd window (48 -> 49), as in the JAX
    engine (``engine.py:427-429``)."""
    res = [
        teng.inspect_units(crops, tcfg.SegmentationParams(),
                           tcfg.DefectParams(threshold=20, min_area=3, median_k=k),
                           device="cpu")[1]
        for k in (48, 49)
    ]
    for f in ("defect_masks", "valid", "areas", "verdicts"):
        np.testing.assert_array_equal(getattr(res[0], f), getattr(res[1], f))
