"""Kernel I's wrapper (``ops.morphology.morph_chain``) on the CPU vs the JAX
package's morphology, its fused heads, and the tiling the kernel is
launched with.

``morph_pallas._morph_chain`` (the TPU kernel) runs the JAX package's
close+open, open and rect-erode programs; on the CPU backend the JAX
package computes them with its XLA references (``ops.morphology``), which
its own tests hold the Pallas kernel to. The port's chain takes a mask and
returns a bool plane: it is held against ``> 0`` of the JAX result on the
0/255 head plane. Same seeded inputs; tolerance 0.
"""

import cv2
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


def _jax_chain(x, chain, k):
    """The JAX package's close+open, open or rect erode of 0/255 planes,
    as a bool plane."""
    xj = jnp.asarray(x)
    if chain == "close_open":
        se = jmorph.ellipse_se(k)
        ref = jmorph.morph_open(jmorph.morph_close(xj, se), se)
    elif chain == "open":
        ref = jmorph.morph_open(xj, jmorph.ellipse_se(k))
    else:
        ref = jmorph.erode_rect3(xj, k)
    return np.asarray(ref) > 0


@pytest.mark.parametrize("k", [3, 5, 9, 31])
def test_close_open_matches_reference(k):
    x = _planes(k)
    stages = tmorph.close_open_stages(k)
    assert stages == _close_open_stages(k)
    got = tmorph.morph_chain(torch.from_numpy(x), stages)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), _jax_chain(x, "close_open", k))


@pytest.mark.parametrize("k", [3, 7])
def test_open_matches_reference(k):
    x = _planes(10 + k)
    stages = tmorph.open_stages(k)
    assert stages == _open_stages(k)
    np.testing.assert_array_equal(tmorph.morph_chain(torch.from_numpy(x), stages).numpy(),
                                  _jax_chain(x, "open", k))


@pytest.mark.parametrize("n", [0, 1, 6, 20])
def test_erode_rect_matches_reference(n):
    """cv2.erode(x, None, iterations=n): the ROI tail's (2n+1)^2 erode and
    the erosion preview's 1-px inner erode; n = 0 returns the head alone."""
    x = _planes(20 + n)
    got = tmorph.morph_chain(torch.from_numpy(x), tmorph.rect_erode_stages(n))
    np.testing.assert_array_equal(got.numpy(), _jax_chain(x, "erode", n))


@pytest.mark.parametrize("head", ["thr", "bool", "roi", "thr_roi"])
@pytest.mark.parametrize("chain,k", [("close_open", 3), ("open", 3), ("erode", 6)])
def test_fused_heads_match_reference(head, chain, k):
    """Each head the callers fuse (the seg tail's x <= thr per unit, a bool
    mask, the candidates' ROI AND) against the JAX program on the 0/255
    head plane the callers built before: thr at -1, 0, a middle value and
    255."""
    rng = np.random.RandomState(30 + k)
    gray = rng.randint(0, 256, (4, 33, 65)).astype(np.uint8)
    thr = np.array([-1, 0, 127, 255], np.int32)
    roi = (rng.rand(4, 33, 65) > 0.2).astype(np.uint8) * 255
    roi[2, :, :3] = 0
    if head.startswith("thr"):
        m = gray <= thr[:, None, None]
        x, kw = torch.from_numpy(gray), dict(thr=torch.from_numpy(thr))
    else:
        m = gray > 100
        x, kw = torch.from_numpy(m), {}
    if head.endswith("roi"):
        m = m & (roi > 0)
        kw["roi"] = torch.from_numpy(roi)
    stages = {"close_open": _close_open_stages, "open": _open_stages,
              "erode": tmorph.rect_erode_stages}[chain](k)
    got = tmorph.morph_chain(x, stages, **kw)
    want = _jax_chain(m.astype(np.uint8) * 255, chain, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmorph.morph_chain_plain(x, stages, **kw).numpy(), want)


@pytest.mark.parametrize("k", [2, 4])
def test_even_close_open_matches_cv2(k):
    """An even ``morph_kernel`` is four stages (its ellipse is not symmetric
    about its anchor): cv2's close then open with the k x k ellipse."""
    x = _planes(40 + k, (3, 37, 53))
    stages = tmorph.close_open_stages(k)
    assert len(stages) == 4
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    want = np.stack([
        cv2.morphologyEx(cv2.morphologyEx(p, cv2.MORPH_CLOSE, se), cv2.MORPH_OPEN, se) > 0
        for p in x
    ])
    np.testing.assert_array_equal(tmorph.morph_chain(torch.from_numpy(x), stages).numpy(), want)


def test_stage_layout_walks_the_program():
    """Each stage's reach (the kernel's halo is their sum) and whether
    ``apply_stages`` runs it in one pass from registers."""
    for stages in (tmorph.close_open_stages(3), tmorph.close_open_stages(31),
                   tmorph.open_stages(3), tmorph.rect_erode_stages(6),
                   tmorph.rect_erode_stages(200)):
        prog = tmorph.stage_program(stages)
        layout = tmorph._stage_layout(stages)
        assert len(layout) == prog[0] == len(stages)
        for (rx, ry, small), (op, runs) in zip(layout, stages):
            assert rx == max(max(-lo, hi) for _, lo, hi in runs)
            assert ry == max(abs(dy) for dy, _, _ in runs)
            groups = tmorph.group_runs(runs)
            assert small == all(-32 <= lo <= hi <= 32 and len(d) <= 3 for lo, hi, d in groups)
    # the default close/open and open in one pass; a rect's rows from its
    # column window, taken once a row
    assert all(s[2] for s in tmorph._stage_layout(tmorph.close_open_stages(3)))
    assert tmorph._stage_layout(tmorph.rect_erode_stages(1)) == ((1, 1, True),)
    assert tmorph._stage_layout(tmorph.rect_erode_stages(6)) == ((6, 6, False),)
    assert tmorph._stage_layout(tmorph.rect_erode_stages(200)) == ((200, 200, False),)


def test_chain_tiles_fit_shared_memory():
    """Every chain the config allows (``morph_kernel`` 0-31, ``erode_px``
    0-200) gets a tile within a block's shared memory on a whole capture,
    the 48 units and one unit; a reach beyond it gets none and raises."""
    chains = [tmorph.close_open_stages(k) for k in range(2, 32)]
    chains += [tmorph.rect_erode_stages(n) for n in range(0, 201)]
    chains += [tmorph.open_stages(3), ()]
    for u, h, w in ((1, 3000, 4096), (48, 315, 316), (1, 315, 316), (2, 37, 53)):
        for stages in chains:
            tiles = tmorph.morph_tiles(u, h, w, stages)
            assert tiles is not None, (u, h, w, len(stages))
            th, tww, ry, rx, big, smem = tiles
            assert 1 <= th <= h and 1 <= tww <= (w + 31) // 32 and smem <= tmorph._SMEM_MAX
    # the default chains keep small tiles and fill the card on a capture
    th, tww, ry, rx, big, smem = tmorph.morph_tiles(1, 3000, 4096, tmorph.close_open_stages(3))
    assert (ry, rx, big) == (4, 4, False) and smem <= 64 * 1024
    assert -(-3000 // th) * -(-128 // tww) >= 264
    big_tiles = tmorph.morph_tiles(1, 3000, 4096, tmorph.rect_erode_stages(200))
    assert big_tiles[4] and big_tiles[2] == 200
    assert tmorph.morph_tiles(1, 3000, 4096, tmorph.rect_erode_stages(300)) is None
    assert tmorph.morph_tiles(1, 3000, 4096, tmorph.rect_erode_stages(200) * 2) is None


def _tiled_model(x, stages, th, tww):
    """The kernel's tiling in plain ops: each output tile of th rows x tww
    words computed from its buffer alone (the tile plus the chain's summed
    reach, clipped to the plane; samples past the buffer are each stage's
    neutral, as ``apply_stages`` in the kernel reads them)."""
    layout = tmorph._stage_layout(tuple(stages))
    rx, ry = sum(s[0] for s in layout), sum(s[1] for s in layout)
    u, h, w = x.shape
    ww, rww = -(-w // 32), -(-rx // 32)
    out = torch.zeros_like(x)
    for y0 in range(0, h, th):
        for k0 in range(0, ww, tww):
            y1, k1 = min(h, y0 + th), min(ww, k0 + tww)
            by0, by1 = max(0, y0 - ry), min(h, y1 + ry)
            bx0, bx1 = 32 * max(0, k0 - rww), min(w, 32 * min(ww, k1 + rww))
            r = tmorph.morph_chain_plain(x[:, by0:by1, bx0:bx1].contiguous(), stages)
            xs = slice(32 * k0, min(w, 32 * k1))
            out[:, y0:y1, xs] = r[:, y0 - by0 : y1 - by0, 32 * k0 - bx0 : min(w, 32 * k1) - bx0]
    return out


@pytest.mark.parametrize("w", [1, 31, 33, 63, 65, 100])
def test_tile_halo_covers_the_chain(w):
    """Tiles of 8 rows and one word, and the tiles ``morph_tiles`` picks,
    give the plain chain's result: the halo (the summed reach) keeps every
    tile pixel clear of the buffer's edge inside the plane."""
    rng = np.random.RandomState(w)
    x = torch.from_numpy(rng.rand(2, 29, w) > 0.45)
    for stages in (tmorph.close_open_stages(3), tmorph.close_open_stages(4),
                   tmorph.open_stages(3), tmorph.rect_erode_stages(6),
                   tmorph.rect_erode_stages(40)):
        want = tmorph.morph_chain_plain(x, stages)
        assert torch.equal(_tiled_model(x, stages, 8, 1), want)
        th, tww = tmorph.morph_tiles(2, 29, w, stages)[:2]
        assert torch.equal(_tiled_model(x, stages, th, tww), want)


def test_morph_chain_rejects_bad_planes():
    x = torch.zeros((2, 8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tmorph.morph_chain(x.to(torch.int32), tmorph.open_stages(3))
    with pytest.raises(ValueError):
        tmorph.morph_chain(x[:, :, ::2], tmorph.open_stages(3))
    with pytest.raises(ValueError):
        tmorph.morph_chain(x, tmorph.open_stages(3), thr=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        tmorph.morph_chain(x, tmorph.open_stages(3), roi=x[:1])
    with pytest.raises(ValueError):
        tmorph.stage_program((("blur", ((0, -1, 1),)),))


@pytest.mark.parametrize("op,arg", [("erode", 5), ("dilate", 3), ("morph_open", 5), ("erode_rect3", 2),
                                    ("erode_rect3", 0)])
def test_mask_ops_match_reference(op, arg):
    """``erode``, ``dilate``, ``morph_open`` and ``erode_rect3`` (kernel I
    on the card, one launch each) equal the JAX package's functions of the
    same name on 0/255 planes, uint8 out."""
    x = _planes(11 + arg)
    param = arg if op == "erode_rect3" else jmorph.ellipse_se(arg)
    got = getattr(tmorph, op)(torch.from_numpy(x), param if op == "erode_rect3"
                              else tmorph.ellipse_se(arg))
    ref = np.asarray(getattr(jmorph, op)(jnp.asarray(x), param))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
