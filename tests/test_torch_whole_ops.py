"""Kernels F, G and B of the whole-image route vs the JAX whole-image functions.

The route of ``tpu_inspect_torch.engine`` (tested against the JAX engine in
``test_torch_whole.py``) takes its largest-component stats from kernel F
(``ops.cc.component_stats``), its Green's filter and paint from kernel G
(``ops.blob_select.blob_select``) and its candidates from kernel B on the
whole plane. Here their plain versions (the CPU) are held with tolerance 0,
dtypes included, against the JAX package's whole-image functions:
``cc.largest_component_sums`` and ``largest_component_sums_tiled`` (its tile
tables in Pallas interpret mode too) for F, ``contour.filter_and_select``
and ``_green_filter_tiled`` + its seed flood for G, and
``median_residual_mask_tiled`` in interpret mode for B.
"""

import functools
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_inspect.ops import canny as jcanny
from tpu_inspect.ops import cc as jcc
from tpu_inspect.ops import contour as jcontour
from tpu_inspect.ops import hole_fill as jfill
from tpu_inspect.synthetic import random_blob_mask

from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.ops import blob, contour
from tpu_inspect_torch.ops.blob_select import blob_select
from tpu_inspect_torch.ops.cc import (
    component_stats,
    label_components,
    largest_component_sums_tiled,
)
from tpu_inspect_torch.ops.median import median_residual_mask

_ORIG_PALLAS_CALL = pl.pallas_call


def _interpreted(*args, **kwargs):
    kwargs.setdefault("interpret", True)
    return _ORIG_PALLAS_CALL(*args, **kwargs)


@pytest.fixture(scope="module")
def interp():
    """cc_pallas and median_pallas reloaded with pallas_call interpreted."""
    with mock.patch.object(pl, "pallas_call", _interpreted):
        import tpu_inspect.ops.cc_pallas as ccp
        import tpu_inspect.ops.median_pallas as mp

        for m in (ccp, mp):
            importlib.reload(m)
        yield dict(ccp=ccp, mp=mp)
    for m in (ccp, mp):
        importlib.reload(m)


def _stat_planes():
    """[4, 40, 44] bool: random blobs cut across 16x20 tiles, an equal-area
    tie that only OpenCV's block-raster order resolves, an empty unit."""
    fg = np.zeros((4, 40, 44), bool)
    fg[0] = random_blob_mask(40, 44, seed=7, n_blobs=4) > 0
    fg[1] = random_blob_mask(40, 44, seed=8, n_blobs=4) > 0
    fg[1, :, 20:22] = False  # split fragments across tile columns
    # pixel raster puts (2, 28) first, the 2x2-block raster (3, 0)
    fg[2, 2, 28] = fg[2, 3, 0] = True
    return fg


def _check_stats(mask, stats, fg, ref):
    ref_mask, area, sx, sy, has = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    assert stats.dtype == torch.int64
    for col, r in zip(range(4), (area, sx, sy, has)):
        np.testing.assert_array_equal(stats[:, col].numpy(), r.astype(np.int64))
    _, h, w = fg.shape
    for u, m in enumerate(ref_mask):
        ys, xs = np.nonzero(m)
        ext = (ys.min(), ys.max() + 1, xs.min(), xs.max() + 1) if ys.size else (h, 0, w, 0)
        assert tuple(stats[u, 4:].tolist()) == ext


def test_component_stats_plain_matches_jax_whole_image_functions(interp):
    fg = _stat_planes()
    fg_t = torch.from_numpy(fg)
    mask, stats = component_stats(label_components(fg_t), fg_t)
    assert mask[2, 3, 0] and not mask[2, 2, 28]
    jfg = jnp.asarray(fg)
    jlab = jcc.label_components(jfg)
    # jit: one compile instead of hundreds of op-by-op dispatches
    _check_stats(mask, stats, fg, jax.jit(jcc.largest_component_sums)(jfg))
    for use_tables in (False, True):  # True: the tile tables, interpreted
        tiled = functools.partial(jcc.largest_component_sums_tiled, tile_hw=(16, 20),
                                  use_tables=use_tables)
        _check_stats(mask, stats, fg, jax.jit(tiled)(jfg, jlab))


def _tie_planes():
    """[4, 24, 40] bool: two 15-pixel components in one 2x2-block row whose
    block-rank order (through the later label's pixel in the row below)
    differs from their labels' raster order, a plane of isolated pixels on a
    2-pixel grid (every component ties at area 1), a full unit, an empty
    unit."""
    fg = np.zeros((4, 24, 40), bool)
    for y, x in [(3, 8), (4, 9), (4, 19), (3, 19), (3, 20), (2, 20)]:
        fg[0, y, x] = True
    fg[0, 5, 10:19] = True
    fg[0, 2, 10:18] = True
    fg[0, 3, 11:18] = True
    fg[1, 1::2, 1::2] = True
    fg[2] = True
    return fg


def test_component_stats_plain_ties_match_jax():
    """Kernel F's contract where only OpenCV's block-raster order decides:
    its plain version against the JAX package's ``largest_component_sums``."""
    fg = _tie_planes()
    fg_t = torch.from_numpy(fg)
    mask, stats = component_stats(label_components(fg_t), fg_t)
    assert mask[0, 3, 8] and not mask[0, 2, 10] and int(stats[0, 0]) == 15
    assert int(mask[1].sum()) == 1 and mask[1, 1, 1]
    _check_stats(mask, stats, fg, jax.jit(jcc.largest_component_sums)(jnp.asarray(fg)))


def test_component_stats_plain_int64_sums():
    fg = np.ones((1, 64, 40000), bool)
    fg_t = torch.from_numpy(fg)
    mask, stats = component_stats(label_components(fg_t), fg_t)
    assert stats[0, 1] == 64 * (39999 * 40000 // 2) > 2**31
    ref = jax.jit(jcc.largest_component_sums)(jnp.asarray(fg))
    assert np.asarray(ref[2]).dtype == np.int64
    _check_stats(mask, stats, fg, ref)


def _blob_planes():
    """[3, 40, 44] uint8 candidates and max_x2 [3]: nested blobs, 2x
    contour areas exactly at min_x2 (8) and max_x2, random blobs cut across
    16x16 vertex tiles, edge-touching blobs."""
    c = np.zeros((3, 40, 44), np.uint8)
    for u in (0, 1):
        c[u, 2:22, 2:22] = 255  # a ring (2x area 722) ...
        c[u, 5:19, 5:19] = 0
        c[u, 9:14, 9:14] = 255  # ... holding a nested blob
        c[u, 26:31, 4:9] = 255  # 5x5: 2x area 32
        c[u, 26:29, 14:17] = 255  # 3x3: 2x area 8
        c[u, 34:36, 20:22] = 255  # 2x2: 2x area 2
        c[u, 30:40, 38:44] = 255  # touches the right and bottom edges
    c[2] = random_blob_mask(40, 44, seed=5, n_blobs=6)
    # unit 0: 5x5 kept exactly at max, ring dropped; unit 1: all but the 2x2
    return c, np.array([32, 10_000, 400], np.int32)


def test_blob_select_plain_matches_jax_whole_image_filter(interp):
    cand, max_x2 = _blob_planes()
    min_x2 = 8
    out, area = teng._whole_blobs(torch.from_numpy(cand), torch.from_numpy(max_x2),
                                  min_x2=min_x2)
    out, area = out.numpy(), area.numpy()
    assert area.dtype == np.int32
    assert out[0, 27, 5] == 255 and out[0, 27, 15] == 255, "kept at max_x2 and min_x2"
    assert out[0, 3, 3] == 0 and out[0, 34, 20] == 0, "dropped above max_x2, below min_x2"
    assert out[1, 7, 7] == 255 and out[1, 10, 10] == 255, "the ring's hole and nested blob"

    fg = jnp.asarray(cand > 0)
    select = jax.jit(functools.partial(jcontour.filter_and_select, min_area_x2=min_x2))
    ref, found = select(fg, max_area_x2=jnp.asarray(max_x2))
    np.testing.assert_array_equal(out, np.where(np.asarray(ref), 255, 0).astype(np.uint8))
    np.testing.assert_array_equal(area, np.asarray(ref).sum(axis=(1, 2)))
    np.testing.assert_array_equal(area > 0, np.asarray(found))

    for use_tables in (False, True):  # True: the tile tables, interpreted
        tiled = functools.partial(_tiled_filter, min_x2=min_x2, use_tables=use_tables)
        painted, found = jax.jit(tiled)(fg, jnp.asarray(max_x2))
        np.testing.assert_array_equal(out, np.where(painted, 255, 0).astype(np.uint8))
        np.testing.assert_array_equal(area > 0, np.asarray(found))


def _tiled_filter(fg, max_x2, *, min_x2, use_tables):
    """The JAX package's whole-image Green's filter (``_green_filter_tiled``
    on 16x16 vertex tiles) and the seed flood of ``filter_and_select``
    (``contour.py:684-698``)."""
    _, h, w = fg.shape
    ext = jfill.exterior_background(fg)
    fill_labels = jcc.label_components(~ext)
    top = fg & (jcc.label_components(fg) == fill_labels)
    attr, contrib = jcontour._vertex_attribution(top, ext, fill_labels)
    bias = 1 << int(np.ceil(np.log2(h + w + 4)))
    kv, found = jcontour._green_filter_tiled(
        attr, contrib, h * w, bias, min_x2, max_x2, tile_vhw=(16, 16),
        use_tables=use_tables,
    )
    seeds = top & (kv[:, :-1, :-1] | kv[:, :-1, 1:] | kv[:, 1:, :-1] | kv[:, 1:, 1:])
    return jcanny._propagate8(seeds, ~ext), found


def test_median_residual_whole_plane_matches_tiled(interp):
    mp = interp["mp"]
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (2, 70, 81), dtype=np.uint8)
    k, thr = 9, 24
    bounds = [(10, 55, 5, 60), (25, 60, 50, 81)]  # ROI rows and columns
    roi = np.zeros(x.shape, bool)
    for u, (rl, rh, cl, ch) in enumerate(bounds):
        roi[u, rl:rh, cl:ch] = True
    col = [np.asarray([b[j] for b in bounds], np.int32) for j in range(4)]
    got = median_residual_mask(
        torch.from_numpy(x), k, thr, torch.from_numpy(col[0]), torch.from_numpy(col[1])
    ).numpy()
    with mock.patch.object(mp, "_ITEM_ENVELOPE", (40, 44)):
        ref = np.asarray(mp.median_residual_mask_tiled(
            jnp.asarray(x), k, thr, batch=6, row_lo=jnp.asarray(col[0]),
            row_hi=jnp.asarray(col[1]), col_lo=jnp.asarray(col[2]),
            col_hi=jnp.asarray(col[3]),
        ))
    assert (got[roi] > 0).any() and (got[roi] == 0).any()
    # rows and columns outside the ROI are unwritten in the JAX function
    np.testing.assert_array_equal(np.where(roi, got, 0), np.where(roi, ref, 0))
    assert not got[:, :10].any(), "rows above every unit's ROI rows are 0"


def test_route_kernels_reject_bad_planes():
    fg = torch.zeros((1, 4, 5), dtype=torch.bool)
    lab = torch.zeros((1, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        component_stats(lab.to(torch.int64), fg)
    with pytest.raises(ValueError, match="int32"):
        component_stats(lab[:, :3], fg)
    max_x2 = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="ext must match"):
        blob_select(lab, fg, torch.zeros((1, 4, 6), dtype=torch.bool), max_x2, min_x2=0)
    with pytest.raises(ValueError, match="max_x2"):
        blob_select(lab, fg, fg, max_x2.to(torch.int64), min_x2=0)
    out, area = blob_select(lab, fg, ~fg, max_x2, min_x2=0)
    assert out.dtype == torch.uint8 and not out.any() and area.tolist() == [0]


@pytest.mark.parametrize("planes", ["blobs", "ties", "wide"])
def test_largest_component_sums_tiled_matches_jax(planes):
    """``cc.largest_component_sums_tiled`` (kernel F on given labels) under
    the JAX package's contract, dtypes included, against its whole-image
    function on its sort path: random blobs across tiles, the block-raster
    ties with a full and an empty unit, and a 2x40000 plane whose
    coordinate sums take int64 (``max(H, W) * H * W >= 2**31``). The tile
    shape is the JAX package's to choose; the port ignores it."""
    if planes == "wide":
        fg = np.zeros((1, 2, 40000), bool)
        fg[0, :, 30000:] = True
        fg[0, 1, 100:160] = True
        tile_hw = (2, 2000)
    else:
        fg = _stat_planes() if planes == "blobs" else _tie_planes()
        tile_hw = (16, 20)
    fg_t = torch.from_numpy(fg)
    got = largest_component_sums_tiled(fg_t, label_components(fg_t), tile_hw=tile_hw,
                                       use_tables=True)
    jfg = jnp.asarray(fg)
    tiled = functools.partial(jcc.largest_component_sums_tiled, tile_hw=tile_hw,
                              use_tables=False)
    ref = jax.jit(tiled)(jfg, jcc.label_components(jfg))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)
    assert got[2].dtype == (torch.int64 if planes == "wide" else torch.int32)
    big = (2, 32768, 32768)  # u*h*w = 2**31: views of one element, nothing allocated
    with pytest.raises(ValueError, match="u\\*h\\*w"):
        largest_component_sums_tiled(torch.zeros((), dtype=torch.bool).expand(big),
                                     torch.zeros((), dtype=torch.int32).expand(big))


def _select_planes():
    """_blob_planes' candidates and bounds with an empty and a full unit."""
    cand, max_x2 = _blob_planes()
    fg = np.concatenate([cand > 0, np.zeros((1, 40, 44), bool), np.ones((1, 40, 44), bool)])
    return fg, np.concatenate([max_x2, [100, 10_000]]).astype(np.int32)


@pytest.mark.parametrize("route", ["kernel C", "fill regions and kernel G"])
def test_filter_and_select_matches_jax(route, monkeypatch):
    """``contour.filter_and_select`` against the JAX package's: kernel C's
    plain version, and with ``blob_filter_fits`` false the whole-image
    composition (kernels D, E, D, then G); nested blobs, 2x contour areas
    exactly at min_x2 (8) and max_x2, edge-touching blobs, random blobs, an
    empty unit and a full one (its 2x area 3354 kept)."""
    if route != "kernel C":
        monkeypatch.setattr(blob, "blob_filter_fits", lambda h, w: False)
    fg, max_x2 = _select_planes()
    out, found = contour.filter_and_select(torch.from_numpy(fg), 8, torch.from_numpy(max_x2))
    select = jax.jit(functools.partial(jcontour.filter_and_select, min_area_x2=8))
    ref, ref_found = (np.asarray(r) for r in select(jnp.asarray(fg), max_area_x2=jnp.asarray(max_x2)))
    assert out.dtype == torch.bool and found.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(found.numpy(), ref_found)
    assert found.tolist() == [True, True, True, False, True]
    # a plain list of bounds is taken as the JAX package takes an array
    out2, _ = contour.filter_and_select(torch.from_numpy(fg), 8, max_x2.tolist())
    assert torch.equal(out, out2)


def test_select_blobs_matches_jax():
    """``contour.select_blobs`` (kernel D seeded by the kept roots) against
    the JAX package's, each on its own package's blob analysis, the kept
    roots those with 8 <= 2x area <= 400."""
    from tpu_inspect_torch.ops.contour import analyze_blobs

    fg, _ = _select_planes()
    ana = analyze_blobs(torch.from_numpy(fg))
    jana = jcontour.analyze_blobs(jnp.asarray(fg))
    a2 = np.asarray(jana.contour_area_x2)
    np.testing.assert_array_equal(ana.contour_area_x2.numpy(), a2)
    keep = (a2 >= 8) & (a2 <= 400)
    got = contour.select_blobs(ana, torch.from_numpy(keep))
    ref = np.asarray(jcontour.select_blobs(jana, jnp.asarray(keep)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any() and not ref.all()
