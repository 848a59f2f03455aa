"""Row-strip sharding of the whole-image configs
(``tpu_inspect_torch.parallel.strips``) on 4 gloo ranks on the CPU.

The cases mirror ``tests/test_parallel_strips.py`` (same images, seeds and
parameters): blur, threshold and morphology halos (an even ``morph_kernel``
included), the summed Otsu histogram, the adaptive threshold, row counts not
divisible by the ranks, the Canny defect method, and the flood that has to
converge across strips (a background corridor snaking through every
strip). The ranks are spawned once (``parallel.launch.run_spmd``,
``device="cpu"``: the kernels' plain versions) in a module fixture that
computes every case; each case is held, on every rank and with tolerance
0, against the port's oracle copy, the port's unsharded engine and, once
per public function, the JAX package's sharded function on 4 of the
virtual devices ``tests/conftest.py`` provides. A last strip too short for
its halo is refused with the JAX package's words.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tpu_inspect.config as jcfg
from tpu_inspect.parallel import strips as jstrips

from tpu_inspect_torch import engine
from tpu_inspect_torch.config import DefectParams, SegmentationParams
from tpu_inspect_torch.oracle import reference as oracle
from tpu_inspect_torch.parallel import launch
from tpu_inspect_torch.parallel.launch import Mesh
from tpu_inspect_torch.parallel.strips import defect_image_sharded, segment_image_sharded

WORLD = 4
SEG_CASES = [
    (256, 192, dict(gaussian_blur=3, morph_kernel=3)),
    # H % 4 != 0: the last strip is shorter
    (250, 192, dict(gaussian_blur=5, morph_kernel=5)),
    (256, 160, dict(method="adaptive", adapt_block=31, adapt_C=5, morph_kernel=0)),
    # an even kernel: close then open in four stages
    (248, 160, dict(gaussian_blur=0, morph_kernel=2)),
]
DEF_CASES = [
    (256, 192, dict(median_k=9, threshold=20, erode_px=3, min_area=4)),
    # H % 4 != 0 + canny (global hysteresis on the whole plane)
    (250, 192, dict(method="canny", threshold=24, erode_px=2, min_area=4)),
    (256, 160, dict(median_k=21, threshold=40, erode_px=0, min_area=2)),
]
MASK_SEG = SegmentationParams(gaussian_blur=3, morph_kernel=3).validated()


def _mold_like(h, w, seed):
    """A blobby two-tone image with internal holes (so the flood matters)."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 200, np.uint8)
    for _ in range(6):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry, rx = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
        yy, xx = np.ogrid[:h, :w]
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img[blob] = 60
    for _ in range(5):
        cy, cx = rng.randint(5, h - 5), rng.randint(5, w - 5)
        img[cy - 2 : cy + 2, cx - 2 : cx + 2] = 220
    img ^= rng.randint(0, 12, (h, w)).astype(np.uint8)
    return img


def _serpentine():
    """A bright corridor from the top border through every strip, and a
    sealed bright cavity, on a dark (foreground) plane."""
    h, w = 240, 120
    img = np.full((h, w), 40, np.uint8)
    x0 = 10
    for band in range(6):
        y0, y1 = band * 40, band * 40 + 40
        img[y0:y1, x0 : x0 + 8] = 230
        x0 = w - 18 - x0
        if band < 5:
            img[y1 - 4 : y1, min(x0, w - 18 - x0) : max(x0, w - 18 - x0) + 8] = 230
    img[0:2, 10:18] = 230
    img[100:110, 60:70] = 230
    return img


SERPENTINE_SEG = SegmentationParams(gaussian_blur=0, morph_kernel=0)


def _defect_inputs(h, w):
    img = _mold_like(h, w, seed=3 * h + w)
    return img, oracle.segment_unit(img, MASK_SEG)


@pytest.fixture(scope="module")
def runs():
    """Every case on 4 spawned gloo ranks: {name: [result of each rank]}."""
    calls = {}
    for i, (h, w, kw) in enumerate(SEG_CASES):
        calls[f"seg{i}"] = functools.partial(
            segment_image_sharded, _mold_like(h, w, seed=h + w), SegmentationParams(**kw))
    for i, (h, w, kw) in enumerate(DEF_CASES):
        calls[f"def{i}"] = functools.partial(
            defect_image_sharded, *_defect_inputs(h, w), DefectParams(**kw))
    calls["serpentine"] = functools.partial(segment_image_sharded, _serpentine(), SERPENTINE_SEG)
    out = launch.run_spmd(functools.partial(launch.run_calls, list(calls.values())), WORLD,
                          "gloo", device="cpu", timeout=300)
    return {name: [r[i] for r in out] for i, name in enumerate(calls)}


def _on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        if isinstance(first, tuple):
            np.testing.assert_array_equal(r[0], first[0])
            assert r[1:] == first[1:]
        else:
            np.testing.assert_array_equal(r, first)
    return first


def _strip_devices():
    return jstrips.strip_mesh(jax.devices()[:WORLD])


@pytest.mark.parametrize("case", range(len(SEG_CASES)))
def test_segment_image_sharded_matches_oracle(runs, case):
    h, w, kw = SEG_CASES[case]
    img = _mold_like(h, w, seed=h + w)
    seg = SegmentationParams(**kw)
    got = _on_every_rank(runs[f"seg{case}"])
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, oracle.segment_unit(img, seg.validated()))
    one = engine.raw_segment(torch.from_numpy(img)[None], seg)[0].numpy()
    np.testing.assert_array_equal(got, one)
    if case == 0:
        ref = jstrips.segment_image_sharded(img, jcfg.SegmentationParams(**kw),
                                            mesh=_strip_devices())
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("case", range(len(DEF_CASES)))
def test_defect_image_sharded_matches_oracle(runs, case):
    h, w, kw = DEF_CASES[case]
    img, mask = _defect_inputs(h, w)
    dp = DefectParams(**kw).validated()
    out, found, area, verdict = _on_every_rank(runs[f"def{case}"])
    ref = oracle.detect_defects(img, mask, dp)
    if ref is None:
        assert not found and area == 0 and not verdict
    else:
        assert found
        np.testing.assert_array_equal(out, ref)
        assert area == int((ref > 0).sum())
        assert verdict == (area >= int(dp.min_area))
    one = engine.detect_defects_batch(img[None], mask[None], dp, device="cpu")
    np.testing.assert_array_equal(out, one.defect_masks[0])
    assert (found, area, verdict) == (bool(one.valid[0]), int(one.areas[0]),
                                      bool(one.verdicts[0]))
    if case == 1:
        j_out = jstrips.defect_image_sharded(img, mask, jcfg.DefectParams(**kw),
                                             mesh=_strip_devices())
        np.testing.assert_array_equal(out, j_out[0])
        assert (found, area, verdict) == j_out[1:]


def test_sharded_flood_crosses_strips(runs):
    """Exterior reachability propagates through several one-row exchange
    rounds, while a sealed cavity still fills."""
    img = _serpentine()
    got = _on_every_rank(runs["serpentine"])
    np.testing.assert_array_equal(got, oracle.segment_unit(img, SERPENTINE_SEG.validated()))
    assert got[102, 62] == 255  # the cavity was enclosed: filled
    assert got[20, 12] == 0  # the corridor was exterior: background


def test_last_strip_too_short_is_refused():
    """13 rows on 4 strips leave the last strip 1 row: both packages refuse
    it, with the same words, before any rank exchanges anything."""
    img = _mold_like(13, 40, seed=1)
    mesh = Mesh(("strip",), (WORLD,), 0, torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        segment_image_sharded(img, SegmentationParams(), mesh=mesh)
    with pytest.raises(ValueError) as ref:
        jstrips.segment_image_sharded(img, jcfg.SegmentationParams(), mesh=_strip_devices())
    assert str(got.value) == str(ref.value)
    mask = np.zeros_like(img)
    with pytest.raises(ValueError) as got:
        defect_image_sharded(img, mask, DefectParams(), mesh=mesh)
    with pytest.raises(ValueError) as ref:
        jstrips.defect_image_sharded(img, mask, jcfg.DefectParams(), mesh=_strip_devices())
    assert str(got.value) == str(ref.value)
