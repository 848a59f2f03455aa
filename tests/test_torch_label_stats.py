"""Kernel J's wrapper (``ops.cc.largest_component_sums``) on the CPU vs the
JAX package's ``cc.largest_component_sums``.

On its TPU branch the JAX function is ``largest_component_stats_pallas``;
on the CPU backend it is the XLA sort-based reference that the JAX
package's own tests hold the fused kernel to. Same seeded inputs;
tolerance 0. The port returns the stats row (area, sx, sy, has_fg, row_lo,
row_hi, col_lo, col_hi) in int64; the extents are checked against the mask.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_inspect.ops import cc as jcc

from tpu_inspect_torch.ops import cc as tcc


def _extents(mask: np.ndarray) -> list[int]:
    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return [h, 0, w, 0]
    return [int(ys.min()), int(ys.max()) + 1, int(xs.min()), int(xs.max()) + 1]


def _check(fg: np.ndarray):
    mask, stats = tcc.largest_component_sums(torch.from_numpy(fg))
    ref = jcc.largest_component_sums(jnp.asarray(fg))
    mask, stats = mask.numpy(), stats.numpy()
    assert mask.dtype == bool and stats.dtype == np.int64 and stats.shape == (fg.shape[0], 8)
    np.testing.assert_array_equal(mask, np.asarray(ref[0]))
    for col, r in zip((0, 1, 2, 3), ref[1:]):
        np.testing.assert_array_equal(stats[:, col], np.asarray(r).astype(np.int64))
    for u in range(fg.shape[0]):
        assert stats[u, 4:].tolist() == _extents(mask[u])
    # the same contract as kernels E then F
    lab = tcc.label_components(torch.from_numpy(fg))
    m2, s2 = tcc.component_stats(lab, torch.from_numpy(fg))
    np.testing.assert_array_equal(mask, m2.numpy())
    np.testing.assert_array_equal(stats, s2.numpy())
    return mask, stats


@pytest.mark.parametrize("p", [0.35, 0.5, 0.65])
def test_largest_component_sums_matches_reference(p):
    rng = np.random.RandomState(int(p * 100))
    fg = rng.rand(4, 41, 37) > p
    fg[0] = False  # empty unit: (0, 0, 0, 0, H, 0, W, 0)
    fg[1] = True  # full unit
    _, stats = _check(fg)
    assert stats[0].tolist() == [0, 0, 0, 0, 41, 0, 37, 0]
    assert stats[1, 0] == 41 * 37


def test_equal_area_tie_goes_to_block_raster_order():
    """Two single pixels of equal area: pixel raster order puts (2, 28)
    first, OpenCV's 2x2-block raster order (3, 0); and two equal squares
    whose order differs the same way."""
    fg = np.zeros((2, 8, 32), bool)
    fg[0, 2, 28] = True
    fg[0, 3, 0] = True
    fg[1, 2:4, 28:30] = True
    fg[1, 3:5, 0:2] = True
    mask, _ = _check(fg)
    assert mask[0, 3, 0] and not mask[0, 2, 28]
    assert mask[1, 3, 0] and not mask[1, 2, 28]


def test_eroded_seg_mask_like_the_erosion_preview():
    """A mold-like mask (a filled shape with a hole, one stray blob), odd
    sizes: the plane kernel J gets from the render's erode."""
    fg = np.zeros((1, 45, 51), bool)
    fg[0, 5:40, 6:44] = True
    fg[0, 15:25, 20:30] = False
    fg[0, 41:44, 46:50] = True
    _check(fg)


def test_refuses_units_above_the_one_cta_limit():
    fg = torch.zeros((1, 1025, 1024), dtype=torch.bool)
    with pytest.raises(ValueError, match="above"):
        tcc.largest_component_sums(fg)
    with pytest.raises(ValueError):
        tcc.largest_component_sums(torch.zeros((1, 8, 8), dtype=torch.int32))
