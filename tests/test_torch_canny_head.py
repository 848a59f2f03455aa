"""Kernel O's contract (Canny's gradient, non-maximum suppression and both
thresholds) on the CPU, where its wrapper runs the plain version.

Kernel O builds and runs only on a card (``tests/test_torch_cuda.py`` holds
it against the plain version there). Here: ``canny_u8`` (through
``canny_planes_plain``) against the JAX package's ``canny_u8`` with
tolerance 0 at the shapes where the two borders meet (1x1, 1xW, Hx1, 2x2,
widths 31-33) and on planes that put the sector test and the neighbour
comparisons on their edges (``synthetic.canny_edge_planes``), at the
path's thresholds ``(max(1, t // 2), max(2, t))`` for t = 0, 24 and 255
and a swapped pair; the planes' own invariants; and the wrapper's input
checks, which it shares with the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_inspect.ops import canny as jcanny

from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.canny import canny_planes, canny_planes_plain, canny_u8
from tpu_inspect_torch.synthetic import canny_edge_planes

THRESHOLDS = [(1, 2), (12, 24), (127, 255), (255, 127)]
SHAPES = {
    "1x1": (2, 1, 1),
    "1xW": (2, 1, 40),
    "Hx1": (2, 40, 1),
    "2x2": (3, 2, 2),
    "w31": (2, 29, 31),
    "w32": (2, 29, 32),
    "w33": (2, 29, 33),
}


def _planes(name: str) -> np.ndarray:
    if name == "edges":
        return canny_edge_planes(37, 45, seed=16)
    sh = SHAPES[name]
    x = np.random.RandomState(sum(sh)).randint(0, 256, sh).astype(np.uint8)
    x[-1] = ((np.indices(sh[1:]).sum(0) % 2) * 255).astype(np.uint8)  # a checkerboard
    return x


@pytest.mark.parametrize("low,high", THRESHOLDS)
@pytest.mark.parametrize("name", [*SHAPES, "edges"])
def test_canny_matches_reference_at_the_edges(name, low, high):
    x = _planes(name)
    got = canny_u8(torch.from_numpy(x), low, high)
    want = np.asarray(jcanny.canny_u8(jnp.asarray(x), low, high))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("low,high", THRESHOLDS)
def test_planes_nest_and_the_flat_plane_has_no_edge(low, high):
    x = torch.from_numpy(canny_edge_planes(21, 34, seed=3))
    strong, cand = canny_planes_plain(x, low, high)
    assert strong.dtype == cand.dtype == torch.bool
    assert not (strong & ~cand).any()  # strong is a subset of cand
    assert not cand[1].any()  # the constant plane
    assert cand[0].any() and cand[2:].any(dim=(1, 2)).all()  # every other plane has edges
    # the order of the thresholds does not matter
    for a, b in zip(canny_planes_plain(x, high, low), (strong, cand)):
        assert torch.equal(a, b)


def test_wrapper_on_cpu_is_the_plain_version():
    x = torch.from_numpy(canny_edge_planes(19, 33, seed=5))
    reset_launches()
    for low, high in THRESHOLDS:
        for a, b in zip(canny_planes(x, low, high), canny_planes_plain(x, low, high)):
            assert a.device.type == "cpu" and torch.equal(a, b)
    assert not any(LAUNCHES.values())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        canny_planes(x.transpose(1, 2), 12, 24)
    with pytest.raises(ValueError, match="uint8"):
        canny_planes(x.to(torch.int32), 12, 24)
    with pytest.raises(ValueError, match="uint8"):
        canny_u8(x[0], 12, 24)  # not [U, H, W]
