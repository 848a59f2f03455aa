"""The wrappers of kernels M (the u8 Gaussian blur) and N (the adaptive
threshold's Gaussian mean) on the CPU, where they run their plain versions.

Kernels M and N build and run only on a card (``tests/test_torch_cuda.py``
holds them against the plain versions there). Here: the public names on
CPU tensors return exactly the plain result (and launch nothing), the tap
tables and border index tables the kernels read equal the ones the plain
versions compute with (JAX's copies of the kernels included), and the
plain versions themselves are held against the JAX package (blur) and
``cv2.adaptiveThreshold`` (mean) in ``test_torch_ops.py`` and
``test_torch_canny.py``, and here at the widths where the kernels' vector
paths end.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_inspect.ops import gaussian as jgauss

from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops import gaussian, threshold

CPU = torch.device("cpu")


def _planes():
    """Seeded small planes: a batch with a flat and a saturated unit, width
    1, H = 1, and a unit narrower than the pads below."""
    rng = np.random.RandomState(15)
    x = rng.randint(0, 256, (3, 21, 33)).astype(np.uint8)
    x[1], x[2] = 77, 255
    return [torch.from_numpy(a) for a in (x, rng.randint(0, 256, (2, 17, 1)).astype(np.uint8),
                                          rng.randint(0, 256, (1, 1, 40)).astype(np.uint8),
                                          rng.randint(0, 256, (1, 2, 2)).astype(np.uint8))]


@pytest.mark.parametrize("kind,k,arg", [("blur", 3, 0.0), ("blur", 9, 1.7), ("blur", 31, 0.0),
                                        ("mean", 3, None), ("mean", 9, None), ("mean", 51, None),
                                        ("threshold", 51, 10), ("threshold", 201, -1)])
def test_public_wrappers_on_cpu_equal_plain(kind, k, arg):
    fast, plain = {
        "blur": (lambda x: gaussian.gaussian_blur_u8(x, k, arg),
                 lambda x: gaussian.gaussian_blur_u8_plain(x, k, arg)),
        "mean": (lambda x: gaussian.adaptive_gaussian_mean(x, k),
                 lambda x: gaussian.adaptive_gaussian_mean_plain(x, k)),
        "threshold": (lambda x: threshold.adaptive_threshold_inv(x, k, arg),
                      lambda x: threshold.adaptive_threshold_inv_plain(x, k, arg)),
    }[kind]
    reset_launches()
    for x in _planes():
        got, ref = fast(x), plain(x)
        assert got.device == CPU and got.dtype == ref.dtype == torch.uint8
        assert torch.equal(got, ref)
    assert not any(LAUNCHES.values())


# the widths where kernels M's and N's vector paths begin and end (4-byte
# words, a warp's 32 and 128 columns, the workload's 316) at H = 1 and 2,
# and a view x[1:] of a [3, 7, 5] plane (on the card its base is not 4-byte
# aligned)
_WIDTHS = (1, 2, 3, 4, 5, 15, 16, 17, 31, 32, 33, 127, 128, 129, 316)


def _width_planes():
    rng = np.random.RandomState(17)
    planes = [torch.from_numpy(rng.randint(0, 256, (1, h, w)).astype(np.uint8))
              for h in (1, 2) for w in _WIDTHS]
    return planes + [torch.from_numpy(rng.randint(0, 256, (3, 7, 5)).astype(np.uint8))[1:]]


def _cv2_mean(x: np.ndarray, block: int) -> np.ndarray:
    """cv2.adaptiveThreshold's uint8 local mean of one plane, read back from
    its output at every C: a pixel is 255 exactly while C <= mean - x."""
    best = np.full(x.shape, -256, np.int64)
    for c in range(-255, 256):
        out = cv2.adaptiveThreshold(x, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                    cv2.THRESH_BINARY_INV, block, c)
        best = np.where(out > 0, c, best)
    return (best + x).astype(np.uint8)


@pytest.mark.parametrize("kind,k", [("blur", 3), ("mean", 3), ("mean", 51)])
def test_plain_versions_at_the_kernels_edge_widths(kind, k):
    """At those widths the public names on the CPU equal the plain versions
    (kernels M's and N's contracts), and these equal the JAX package's blur
    (one jitted call over all the planes) and OpenCV's adaptive mean."""
    planes = _width_planes()
    assert planes[-1].is_contiguous() and planes[-1].storage_offset() == 35
    reset_launches()
    if kind == "blur":
        got = [gaussian.gaussian_blur_u8(x, k) for x in planes]
        ref = jax.jit(lambda xs: [jgauss.gaussian_blur_u8(x, k) for x in xs])(
            [jnp.asarray(x.numpy()) for x in planes])
        for x, g, r in zip(planes, got, ref):
            assert torch.equal(g, gaussian.gaussian_blur_u8_plain(x, k))
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    else:
        for x in planes:
            got = gaussian.adaptive_gaussian_mean(x, k)
            assert torch.equal(got, gaussian.adaptive_gaussian_mean_plain(x, k))
            assert torch.equal(threshold.adaptive_threshold_inv(x, k, 10),
                               threshold.adaptive_threshold_inv_plain(x, k, 10))
            for g, u in zip(got, x):
                np.testing.assert_array_equal(g.numpy(), _cv2_mean(u.numpy(), k))
    assert not any(LAUNCHES.values())


def test_size_one_windows_return_the_plane():
    x = _planes()[0]
    assert gaussian.gaussian_blur_u8(x, 1) is x
    assert gaussian.adaptive_gaussian_mean(x, 1) is x


@pytest.mark.parametrize("k,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (9, 0.0), (9, 1.7), (25, 0.0),
                                     (31, 0.0), (31, 4.5)])
def test_blur_tap_table_is_the_fixed_kernel(k, sigma):
    taps = gaussian._blur_taps(k, sigma, CPU)
    assert taps.dtype == torch.int32 and int(taps.sum()) == 256
    np.testing.assert_array_equal(taps.numpy(), gaussian.fixed_gaussian_kernel(k, sigma))
    np.testing.assert_array_equal(taps.numpy(), jgauss.fixed_gaussian_kernel(k, sigma))
    assert gaussian._blur_taps(k, sigma, CPU) is taps  # cached: uploaded once a device


@pytest.mark.parametrize("k", [3, 5, 9, 11, 51, 119, 201])
def test_mean_tap_table_is_opencvs(k):
    taps = gaussian._mean_taps(k, CPU)
    assert taps.dtype == torch.float32
    want = gaussian._TAB_9 if k == 9 else gaussian.gaussian_kernel_f64(k).astype(np.float32)
    np.testing.assert_array_equal(taps.numpy(), want)
    if k == 9:  # OpenCV's table, not the computed kernel
        np.testing.assert_array_equal(
            taps.numpy() * 256, [4, 13, 30, 51, 60, 51, 30, 13, 4])
    assert gaussian._mean_taps(k, CPU) is taps


@pytest.mark.parametrize("n,pad", [(1, 15), (2, 15), (3, 1), (31, 15), (316, 1)])
def test_reflect_tables_are_numpys(n, pad):
    """Kernel M's border tables are the plain version's own gather
    indices: numpy's reflect, which reflects again where pad > n - 1."""
    idx = gaussian._reflect101_index(n, pad, CPU)
    assert idx.dtype == torch.int32 and idx.shape == (n + 2 * pad,)
    np.testing.assert_array_equal(idx.numpy(), np.pad(np.arange(n), pad, mode="reflect"))
    assert int(idx.min()) >= 0 and int(idx.max()) <= n - 1
