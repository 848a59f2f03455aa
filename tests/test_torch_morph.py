"""Kernel I's wrapper (``ops.morphology.morph_chain``) on the CPU vs the JAX
package's morphology, and the stage layout the kernel is launched with.

``morph_pallas._morph_chain`` (the TPU kernel) runs the JAX package's
close+open, open and rect-erode programs; on the CPU backend the JAX
package computes them with its XLA references (``ops.morphology``), which
its own tests hold the Pallas kernel to. Same seeded inputs; tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_inspect.ops import morphology as jmorph
from tpu_inspect.ops.morph_pallas import _close_open_stages, _open_stages

from tpu_inspect_torch.ops import morphology as tmorph


def _planes(seed, shape=(3, 34, 29)):
    rng = np.random.RandomState(seed)
    x = ((rng.rand(*shape) > 0.5) * 255).astype(np.uint8)
    x[0] = 0  # empty unit
    x[1, :, -1] = 255  # fg on the right and bottom edges
    x[1, -1, :] = 255
    x[2, :2] = 255  # fg on the top edge
    return x


@pytest.mark.parametrize("k", [3, 5, 9, 31])
def test_close_open_matches_reference(k):
    x = _planes(k)
    se = jmorph.ellipse_se(k)
    ref = jmorph.morph_open(jmorph.morph_close(jnp.asarray(x), se), se)
    stages = tmorph.close_open_stages(k)
    assert stages == _close_open_stages(k)
    np.testing.assert_array_equal(tmorph.morph_chain(torch.from_numpy(x), stages).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("k", [3, 7])
def test_open_matches_reference(k):
    x = _planes(10 + k)
    ref = jmorph.morph_open(jnp.asarray(x), jmorph.ellipse_se(k))
    stages = tmorph.open_stages(k)
    assert stages == _open_stages(k)
    np.testing.assert_array_equal(tmorph.morph_chain(torch.from_numpy(x), stages).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("n", [0, 1, 6, 20])
def test_erode_rect_matches_reference(n):
    """cv2.erode(x, None, iterations=n): the ROI tail's (2n+1)^2 erode and
    the erosion preview's 1-px inner erode; n = 0 returns the input."""
    x = _planes(20 + n)
    ref = jmorph.erode_rect3(jnp.asarray(x), n)
    got = tmorph.morph_chain(torch.from_numpy(x), tmorph.rect_erode_stages(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_stage_layout_walks_the_program():
    """Each stage's offset in ``stage_program`` points at its op word, with
    the op and the reach the kernel's halo is sized by."""
    for stages in (tmorph.close_open_stages(3), tmorph.close_open_stages(31),
                   tmorph.open_stages(3), tmorph.rect_erode_stages(6)):
        prog = tmorph.stage_program(stages)
        layout = tmorph._stage_layout(stages)
        assert len(layout) == prog[0] == len(stages)
        for (off, erode, rx, ry), (op, runs) in zip(layout, stages):
            assert prog[off] == (0 if op == "erode" else 1) and erode == (op == "erode")
            assert rx == max(max(-lo, hi) for _, lo, hi in runs)
            assert ry == max(abs(dy) for dy, _, _ in runs)
    assert tmorph._stage_layout(tmorph.rect_erode_stages(6)) == ((1, True, 6, 6),)


def test_tile_rows_fit_shared_memory():
    assert tmorph.morph_tile_rows(1, 1) == 32
    assert tmorph.morph_tile_rows(6, 6) == 32
    assert tmorph.morph_tile_rows(30, 30) == 32  # close_open(31): B (+) B reaches 30
    assert tmorph.morph_tile_rows(200, 200) == 8  # the largest ROI erode
    assert tmorph.morph_tile_rows(260, 260) is None
    for r in range(0, 224):  # (8 + 2r)(64 + 2r) <= 232448 up to r = 223
        th = tmorph.morph_tile_rows(r, r)
        assert th is not None and tmorph._morph_smem(th, r, r) <= tmorph._MORPH_SMEM_MAX


def test_morph_chain_rejects_bad_planes():
    x = torch.zeros((2, 8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tmorph.morph_chain(x.to(torch.int32), tmorph.open_stages(3))
    with pytest.raises(ValueError):
        tmorph.morph_chain(x[:, :, ::2], tmorph.open_stages(3))
    with pytest.raises(ValueError):
        tmorph.stage_program((("blur", ((0, -1, 1),)),))
