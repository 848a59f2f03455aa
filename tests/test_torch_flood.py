"""Kernels D and E's plain versions and the contour analysis vs the JAX
package.

``propagate_plain`` (kernel D's CPU path), ``label_components_plain``
(kernel E's) and ``analyze_blobs`` are held bit-exact, dtypes included,
against ``tpu_inspect``'s Canny hysteresis (``canny._propagate8``), its
exterior flood (``hole_fill.exterior_background``), its labeling
(``cc.label_components``) and its contour analysis, all on the JAX CPU
backend where the XLA fallbacks run, and against the Pallas kernels
themselves (``propagate_pallas``, ``label_components_pallas``) in Pallas
interpret mode. Inputs: 4 seeded units of at most 64x64, with an empty and
a full unit and a 1-px serpentine that is 8- but not 4-connected.
"""

import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_inspect.ops import canny as jcanny
from tpu_inspect.ops import cc as jcc
from tpu_inspect.ops import contour as jcontour
from tpu_inspect.ops import hole_fill as jfill

from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.cc import label_components, label_components_plain
from tpu_inspect_torch.ops.contour import analyze_blobs
from tpu_inspect_torch.ops.flood import propagate, propagate_plain
from tpu_inspect_torch.ops.hole_fill import exterior_background
from tpu_inspect_torch.synthetic import serpentine_plane

SHAPE = (4, 61, 64)
_ORIG_PALLAS_CALL = pl.pallas_call


def _interpreted(*args, **kwargs):
    kwargs.setdefault("interpret", True)
    return _ORIG_PALLAS_CALL(*args, **kwargs)


@pytest.fixture(scope="module")
def pallas_mods():
    """flood_pallas and cc_pallas reloaded with pallas_call interpreted."""
    with mock.patch.object(pl, "pallas_call", _interpreted):
        import tpu_inspect.ops.cc_pallas as cc_mod
        import tpu_inspect.ops.flood_pallas as flood_mod

        importlib.reload(flood_mod)
        importlib.reload(cc_mod)
        yield flood_mod, cc_mod
    importlib.reload(flood_mod)
    importlib.reload(cc_mod)


def _planes(kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(seed, domain) bool planes [4, 61, 64]."""
    rng = np.random.RandomState({"random": 1, "sparse": 2, "snake": 3}[kind])
    p = {"random": 0.45, "sparse": 0.7, "snake": 0.45}[kind]
    dom = rng.rand(*SHAPE) > p
    dom[0] = False  # empty unit
    dom[1] = True  # full unit
    if kind == "snake":
        dom[2] = serpentine_plane(*SHAPE[1:]) > 0
    seed = dom & (rng.rand(*SHAPE) > 0.98)
    if kind == "snake":
        seed[2] = False
        seed[2].flat[np.flatnonzero(dom[2]).max()] = True  # the path's far end
    seed[1, 30, 30] = True
    return seed, dom


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert got.numpy().dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["random", "sparse", "snake"])
def test_propagate8_matches_canny_hysteresis(kind):
    seed, dom = _planes(kind)
    got = propagate_plain(_t(seed), _t(dom), conn8=True)
    _eq(got, jcanny._propagate8(jnp.asarray(seed), jnp.asarray(dom)))
    # the wrapper takes uint8 planes and runs the plain version on the CPU
    _eq(propagate(_t(seed).to(torch.uint8) * 255, _t(dom).to(torch.uint8), True), np.asarray(got))
    if kind == "snake":
        assert got[2].sum() == dom[2].sum(), "the far end reaches the whole path"


@pytest.mark.parametrize("kind", ["random", "sparse", "snake"])
def test_border_flood_matches_exterior_background(kind):
    _, dom = _planes(kind)
    fg = ~dom
    ref = jfill.exterior_background(jnp.asarray(fg))
    _eq(propagate_plain(None, _t(dom), conn8=False, border_seed=True), ref)
    _eq(exterior_background(_t(fg)), ref)


@pytest.mark.parametrize("conn8", [True, False])
@pytest.mark.parametrize("border_seed", [False, True])
def test_propagate_matches_pallas_interpret(pallas_mods, conn8, border_seed):
    flood_mod, _ = pallas_mods
    seed, dom = _planes("snake")
    ref = flood_mod.propagate_pallas(
        None if border_seed else jnp.asarray(seed), jnp.asarray(dom), conn8=conn8,
        border_seed=border_seed,
    )
    _eq(propagate_plain(_t(seed), _t(dom), conn8, border_seed), ref)


@pytest.mark.parametrize("kind", ["random", "sparse", "snake"])
def test_label_components_matches_reference(pallas_mods, kind):
    _, cc_mod = pallas_mods
    _, fg = _planes(kind)
    got = label_components_plain(_t(fg))
    _eq(got, jcc.label_components(jnp.asarray(fg)))
    _eq(got, cc_mod.label_components_pallas(jnp.asarray(fg)))
    reset_launches()
    _eq(label_components(_t(fg)), np.asarray(got))
    assert LAUNCHES["label"] == 0, "a CPU tensor runs the plain version"


def _blob_units() -> np.ndarray:
    """Candidate planes with nesting, edge-touching blobs and noise."""
    rng = np.random.RandomState(12)
    fg = np.zeros(SHAPE, bool)
    fg[0] = rng.rand(*SHAPE[1:]) > 0.7
    fg[1, 4:40, 4:40] = True  # a ring holding a blob in its hole
    fg[1, 8:36, 8:36] = False
    fg[1, 15:25, 15:25] = True
    fg[1, 50:, 55:] = True  # a corner blob
    fg[2] = serpentine_plane(*SHAPE[1:]) > 0
    return fg


def test_analyze_blobs_matches_reference():
    fg = _blob_units()
    got = analyze_blobs(_t(fg))
    ref = jcontour.analyze_blobs(jnp.asarray(fg))
    for field in ("fill_labels", "fill_mask", "contour_area_x2", "is_root"):
        _eq(getattr(got, field), getattr(ref, field))
    assert got.is_root[1].sum() == 2, "the ring and the corner blob (the nested one is not external)"
