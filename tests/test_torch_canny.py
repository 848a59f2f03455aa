"""The adaptive threshold and Canny ops of the port vs the JAX package.

Same seeded numpy inputs through ``tpu_inspect_torch`` (CPU tensors, so
kernel D runs as its plain version) and ``tpu_inspect`` (JAX on its CPU
backend, where the XLA fallbacks run), compared with exact equality, dtypes
included; Canny's NMS and hysteresis are integer. The float32 Gaussian
local mean rounds as OpenCV's filters do (fused multiply-adds, the column
pass by symmetric pairs), which the JAX package's tap-by-tap rounding
matches except where a sum lies within a rounding of a half: there the
port is held against ``cv2.adaptiveThreshold`` itself.
"""

import cv2

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_inspect.ops import canny as jcanny
from tpu_inspect.ops import gaussian as jgauss
from tpu_inspect.ops import threshold as jthr

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch.ops.canny import canny_u8
from tpu_inspect_torch.ops.gaussian import adaptive_gaussian_mean, gaussian_kernel_f64
from tpu_inspect_torch.ops.threshold import adaptive_threshold_inv
from tpu_inspect_torch.synthetic import make_mold_image

UNIT_HW = (44, 48)


@pytest.fixture(scope="module")
def units():
    """4 units of 44x48: a mold crop, seeded noise, a flat and a saturated
    unit."""
    grid = tcfg.GridParams(base_unit=(4, 6, UNIT_HW[1], UNIT_HW[0]), units_x=2)
    img = make_mold_image(grid, (60, 110), seed=5, defect_rate=1.0)
    x = np.zeros((4,) + UNIT_HW, np.uint8)
    x[0] = img[6 : 6 + UNIT_HW[0], 4 : 4 + UNIT_HW[1]]
    x[1] = np.random.RandomState(6).randint(0, 256, UNIT_HW, dtype=np.uint8)
    x[2] = 77
    x[3] = 255
    return x


def _eq(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gaussian_kernel_copy_matches_reference():
    for k in (1, 3, 5, 7, 9, 51, 201):
        np.testing.assert_array_equal(gaussian_kernel_f64(k), jgauss.gaussian_kernel_f64(k))


@pytest.mark.parametrize("block", [3, 51, 201])
def test_adaptive_gaussian_mean_matches_reference(units, block):
    # 201 > the unit's 44x48: the replicate pad (100) exceeds the plane
    _eq(adaptive_gaussian_mean(torch.from_numpy(units), block),
        jgauss.adaptive_gaussian_mean(jnp.asarray(units), block))


def _cv2_mean(x: np.ndarray, block: int) -> np.ndarray:
    """cv2.adaptiveThreshold's uint8 local mean, read back from its output
    at every C: a pixel is 255 exactly while C <= mean - x."""
    best = np.full(x.shape, -256, np.int64)
    for c in range(-255, 256):
        out = cv2.adaptiveThreshold(x, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                    cv2.THRESH_BINARY_INV, block, c)
        best = np.where(out > 0, c, best)
    return (best + x).astype(np.uint8)


@pytest.mark.parametrize("block", [9, 11, 51, 119, 201])
def test_adaptive_gaussian_mean_matches_opencv(units, block):
    rng = np.random.RandomState(block)
    planes = [units[0], units[1], rng.randint(0, 256, (37, 131)).astype(np.uint8),
              cv2.GaussianBlur(rng.randint(0, 256, (29, 70)).astype(np.uint8), (5, 5), 0)]
    for x in planes:
        got = adaptive_gaussian_mean(torch.from_numpy(np.ascontiguousarray(x))[None], block)
        np.testing.assert_array_equal(got[0].numpy(), _cv2_mean(x, block))


def test_adaptive_threshold_fuzz_trial_matches_opencv():
    """The fuzz tool's seed 3014 trial 91 (image class): unit 0 of its
    reference capture, blurred at 25, adaptive block 119, C = -1. The JAX
    package's tap-by-tap mean gives 199 at pixel (275, 12), where OpenCV's
    (and the port's) rounds to 198, so its mask differs there."""
    from tpu_inspect_torch.imageio import crops_for_grid
    from tpu_inspect_torch.ops.gaussian import gaussian_blur_u8
    from tpu_inspect_torch.tools import fuzz_parity as fp

    t = fp.trials(3014, 1, start=91)[0]
    crop = crops_for_grid(fp.capture(t, False), t.get("grid"), device="cpu")[:1]
    x = gaussian_blur_u8(crop, 25)
    want = cv2.adaptiveThreshold(x[0].numpy(), 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                 cv2.THRESH_BINARY_INV, 119, -1)
    np.testing.assert_array_equal(adaptive_threshold_inv(x, 119, -1)[0].numpy(), want)
    jax_mask = np.asarray(jthr.adaptive_threshold_inv(jnp.asarray(x.numpy()), 119, -1))[0]
    assert np.argwhere(jax_mask != want).tolist() == [[275, 12]]


@pytest.mark.parametrize("c", [-50, 0, 10, 50])
@pytest.mark.parametrize("block", [3, 51, 201])
def test_adaptive_threshold_inv_matches_reference(units, block, c):
    got = adaptive_threshold_inv(torch.from_numpy(units), block, c)
    _eq(got, jthr.adaptive_threshold_inv(jnp.asarray(units), block, c))


@pytest.mark.parametrize("thr", [0, 24, 100, 255])
def test_canny_matches_reference(units, thr):
    low, high = max(1, thr // 2), max(2, thr)
    got = canny_u8(torch.from_numpy(units), low, high)
    _eq(got, jcanny.canny_u8(jnp.asarray(units), low, high))
    assert not got[2].any() and not got[3].any(), "flat units have no edge"
    # cv2.Canny orders its thresholds itself
    torch.testing.assert_close(canny_u8(torch.from_numpy(units), high, low), got, rtol=0, atol=0)
