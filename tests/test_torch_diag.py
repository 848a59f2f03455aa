"""The port's ``engine.defect_intermediates`` vs the JAX engine's, exactly.

The per-unit diagnostic pass (ROI scalars, the residual area after the
ROI AND and 3x3 open, and the external contours skipped as too large) on
``device="cpu"`` against ``tpu_inspect.engine.defect_intermediates`` on the
JAX CPU backend, for the threshold and Canny methods, on units with an
empty ROI and with a blob whose contour area exceeds ``max_area``. Split
from test_torch_engine.py so that each file stays short.
"""

import numpy as np
import pytest

import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.synthetic import make_mold_image


def _j(obj):
    return getattr(jcfg, type(obj).__name__)(**obj.__dict__)


def _diag_units():
    """(crops, seg masks) [4, 64, 64]: a mold unit, a bright square inside a
    wide ROI (its contour area exceeds a small max_area), an empty seg mask
    (empty ROI) and a noise unit."""
    rng = np.random.RandomState(21)
    crops = np.clip(rng.normal(80, 4, (4, 64, 64)), 0, 255).astype(np.uint8)
    masks = np.zeros((4, 64, 64), np.uint8)
    grid = tcfg.GridParams(base_unit=(0, 0, 64, 64))
    crops[0] = make_mold_image(grid, (64, 64), seed=7, defect_rate=1.0)
    masks[0] = teng.segment_units(crops[:1], tcfg.SegmentationParams(), device="cpu").masks[0]
    crops[1, 20:44, 18:42] = 235
    masks[1, 6:58, 6:58] = 255
    crops[3] = rng.randint(0, 256, (64, 64))
    masks[3, 10:50, 3:60] = 255
    return crops, masks


@pytest.mark.parametrize("method", ["threshold", "canny"])
@pytest.mark.parametrize("frac", [0.98, 0.1])
def test_defect_intermediates_match_jax_engine(method, frac):
    crops, masks = _diag_units()
    dp = tcfg.DefectParams(method=method, min_area=5, erode_px=2, max_area_frac=frac)
    skipped = []
    for u in range(crops.shape[0]):
        got = teng.defect_intermediates(crops[u], masks[u], dp, device="cpu")
        ref = jeng.defect_intermediates(crops[u], masks[u], _j(dp))
        assert got == ref, f"unit {u}: {got} vs {ref}"
        assert ("resid_area" in got) == (method == "threshold" and not got["roi_empty"])
        skipped += got.get("skipped_large", [])
    assert teng.defect_intermediates(crops[2], masks[2], dp, device="cpu")["roi_empty"]
    assert bool(skipped) == (frac < 0.5), "the bright square is skipped as too large"

