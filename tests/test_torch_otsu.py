"""The Otsu threshold: the port's against the JAX package's on the CPU, and
the CUDA kernel (``csrc/otsu.cu``) against its plain version on a GPU.

The cases are seeded numpy units that reach every branch of OpenCV's
getThreshVal_Otsu_8u recurrence: random units, constant units (threshold
0: every step is guarded), two-level units, a unit whose one-pixel class
has a weight above 0 but under FLT_EPSILON (the guard that skips the
update), a three-level unit whose two splits tie (the strict '>' keeps the
first), one unit alone and odd unit sizes. The JAX package is imported inside the CPU
test only, so the ``cuda`` test runs on a machine without JAX:

    python -m pytest tests/test_torch_otsu.py -q --noconftest -m cuda

Tolerance is exact equality: a threshold is an integer, and both sides
run the same float64 operations in the same order.
"""

import numpy as np
import pytest
import torch

from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.gaussian import gaussian_blur_u8
from tpu_inspect_torch.ops.threshold import (
    histogram_u8,
    histogram_u8_plain,
    otsu_threshold,
    otsu_threshold_plain,
)
from tpu_inspect_torch.synthetic import standard_workload


def _cases():
    """(label, [U, H, W] uint8) pairs, drawn from one seed."""
    rng = np.random.RandomState(2024)
    out = [("random", rng.randint(0, 256, (5, 23, 31), dtype=np.uint8))]
    const = np.empty((4, 17, 19), np.uint8)
    for i, v in enumerate((0, 77, 128, 255)):
        const[i] = v
    out.append(("constant", const))
    two = np.where(rng.rand(3, 24, 31) > 0.5, 40, 200).astype(np.uint8)
    two[1] = np.where(rng.rand(24, 31) > 0.9, 3, 250)
    two[2] = np.where(rng.rand(24, 31) > 0.5, 0, 255)
    out.append(("two-level", two))
    # one outlier among 10^4 pixels: q1 = 1e-4 is above FLT_EPSILON; a
    # one-pixel class under it needs a unit of 2^23 px or more
    # (:func:`_guard_unit`)
    eps = np.full((2, 100, 100), 90, np.uint8)
    eps[0, 0, 0] = 10
    eps[1, 50, 50] = 250
    out.append(("outlier", eps))
    # ties: three equal levels, split {10} | {20, 30} or {10, 20} | {30}
    tie = np.zeros((2, 12, 12), np.uint8)
    tie[0].reshape(-1)[:48] = 10
    tie[0].reshape(-1)[48:96] = 20
    tie[0].reshape(-1)[96:] = 30
    tie[1].reshape(-1)[:72] = 100
    tie[1].reshape(-1)[72:] = 101
    out.append(("tie", tie))
    out.append(("one unit", rng.randint(30, 220, (1, 9, 7), dtype=np.uint8)))
    out.append(("odd sizes", rng.randint(0, 256, (3, 1, 1), dtype=np.uint8)))
    out.append(("odd sizes 2", rng.randint(0, 256, (2, 7, 3), dtype=np.uint8)))
    out.append(("narrow", rng.randint(100, 104, (3, 33, 65), dtype=np.uint8)))
    return out


def _guard_unit():
    """A 1x2900x2900 unit with one dark pixel: after bin 0 the class weight
    q1 = 1 / 8410000 is above 0 but under FLT_EPSILON, so the guard skips
    that step."""
    x = np.full((1, 2900, 2900), 200, np.uint8)
    x[0, 7, 9] = 0
    return x


@pytest.mark.parametrize("label,x", _cases(), ids=[c[0] for c in _cases()])
def test_otsu_matches_jax_package(label, x):
    import jax.numpy as jnp

    from tpu_inspect.ops import threshold as jthr

    t = torch.from_numpy(x)
    hist = histogram_u8(t)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jthr.histogram_u8(jnp.asarray(x))))
    got = otsu_threshold(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jthr.otsu_threshold(jnp.asarray(x))), label)
    assert got.dtype == np.int32
    if label == "constant":
        assert (got == 0).all(), "every step of a constant unit is guarded"
    if label == "tie":
        assert got[0] == 10, "the first of two equal maxima"


def test_otsu_guard_unit_matches_jax_package():
    import jax.numpy as jnp

    from tpu_inspect.ops import threshold as jthr

    x = _guard_unit()
    got = otsu_threshold(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jthr.otsu_threshold(jnp.asarray(x))))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Otsu kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_otsu_kernel_matches_plain(cuda):
    wl = standard_workload()
    crops = gather_crops(
        torch.from_numpy(wl["image"]).to(cuda), torch.from_numpy(wl["origins"]).to(cuda),
        wl["unit_hw"],
    )
    whole = torch.from_numpy(wl["image"]).to(cuda)[None].contiguous()
    planes = [(label, torch.from_numpy(x).to(cuda)) for label, x in _cases()]
    planes += [
        ("guard", torch.from_numpy(_guard_unit()).to(cuda)),
        ("48 blurred crops", gaussian_blur_u8(crops, 3).contiguous()),
        ("whole 3000x4096", whole),
        # units of 999 x 1001 px: every unit after the first starts off a
        # 4-byte boundary (the histogram's byte path)
        ("unaligned units", whole.reshape(-1)[: 3 * 999 * 1001].reshape(3, 999, 1001)),
    ]
    for label, x in planes:
        reset_launches()
        hist = histogram_u8(x)
        thr = otsu_threshold(x)
        assert LAUNCHES["otsu"] == 3, label  # histogram, then histogram + scan
        torch.cuda.synchronize()
        assert thr.device == x.device and thr.dtype == torch.int32
        assert torch.equal(hist, histogram_u8_plain(x)), label
        assert torch.equal(thr, otsu_threshold_plain(x)), label
