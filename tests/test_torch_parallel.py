"""The unit mesh, the image x unit mesh and the sharded stream of
``tpu_inspect_torch.parallel`` on 4 gloo ranks on the CPU.

The cases mirror ``tests/test_parallel.py`` (same shapes, seeds and
parameters: 11 units for the padding, exclusions with alignment, a 2 x 4
grid over two frames, a three-frame stream). The ranks are spawned once
(``parallel.launch.run_spmd``, ``device="cpu"``: the kernels' plain
versions), in a module fixture that computes every case; each case is held,
on every rank and with tolerance 0 (dtypes included), against the port's
oracle copy, the port's unsharded engine on ``device="cpu"`` and, once per
public function, the JAX package's sharded function on the 8-virtual-device
mesh that ``tests/conftest.py`` provides.
"""

import functools

import numpy as np
import pytest

import tpu_inspect.config as jcfg
from tpu_inspect.parallel import mesh as jmesh
from tpu_inspect.streaming import stream_inspect_sharded as j_stream_sharded

from tpu_inspect_torch import engine
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.imageio import crops_for_grid
from tpu_inspect_torch.oracle import reference as oracle
from tpu_inspect_torch.parallel import launch
from tpu_inspect_torch.parallel.mesh import (
    image_unit_mesh,
    inspect_image_batch_sharded,
    inspect_units_sharded,
    pad_units,
    unit_mesh,
)
from tpu_inspect_torch.streaming import stream_inspect_sharded

WORLD = 4
SEG = SegmentationParams(gaussian_blur=3, morph_kernel=3)
DEF = DefectParams(threshold=12, min_area=4, erode_px=1)
J_SEG = jcfg.SegmentationParams(gaussian_blur=3, morph_kernel=3)
J_DEF = jcfg.DefectParams(threshold=12, min_area=4, erode_px=1)
EXCL = [
    {"shape": "rect", "x": 3, "y": 5, "w": 8, "h": 6},
    {"shape": "circle", "cx": 30, "cy": 12, "r": 4},
]
SEG_FIELDS = ("masks", "centroids", "centroid_valid", "shifts")
INSP_FIELDS = ("defect_masks", "valid", "areas", "verdicts")


def _crops(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, 40, 44), dtype=np.uint8)


def _batch_case():
    rng = np.random.RandomState(3)
    grid = GridParams(base_unit=(4, 6, 32, 30), units_x=4, units_y=2)
    images = rng.randint(0, 256, (2, 80, 150), dtype=np.uint8)
    anchors = {i: (15.0, 14.0) for i in range(grid.num_units)}
    return grid, images, anchors


def _stream_case():
    rng = np.random.RandomState(5)
    grid = GridParams(base_unit=(2, 2, 24, 20), units_x=2, units_y=2)
    frames = [rng.randint(0, 256, (50, 60), dtype=np.uint8) for _ in range(3)]
    return grid, frames


def _aligned_case():
    """The 16 units, the oracle's anchors from them, and the capture rolled
    by 2 columns."""
    crops = _crops(7, 16)
    _, anchors, _ = oracle.segment_all_units(crops, SEG, exclusions=EXCL, is_reference=True)
    return crops, anchors, np.roll(crops, 2, axis=2)


@pytest.fixture(scope="module")
def runs():
    """Every case on 4 spawned gloo ranks: {name: [result of each rank]}."""
    crops2_ref, anchors, crops2 = _aligned_case()
    grid_b, images, anchors_b = _batch_case()
    grid_s, frames = _stream_case()
    calls = {
        "unit_mesh": functools.partial(unit_mesh),
        "image_unit_mesh": functools.partial(image_unit_mesh, 2),
        "padded": functools.partial(inspect_units_sharded, _crops(0, 11), SEG, DEF),
        "reference": functools.partial(inspect_units_sharded, crops2_ref, SEG, DEF,
                                       exclusions=EXCL, is_reference=True),
        "aligned": functools.partial(inspect_units_sharded, crops2, SEG, DEF, exclusions=EXCL,
                                     ref_centroids=anchors, is_reference=False),
        "batch": functools.partial(inspect_image_batch_sharded, images, grid_b, SEG, DEF,
                                   exclusions=EXCL, ref_centroids=anchors_b),
        "stream": functools.partial(stream_inspect_sharded, frames, grid_s, SEG, DEF,
                                    exclusions=EXCL, fetch_masks=True),
    }
    out = launch.run_spmd(functools.partial(launch.run_calls, list(calls.values())), WORLD,
                          "gloo", device="cpu", timeout=300)
    return {name: [r[i] for r in out] for i, name in enumerate(calls)}


def _same(a, b, what):
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _held(got, ref, fields, what, areas_int64=True):
    """Field by field, dtypes included (the sharded areas are int64, the
    unit-level engine's int32)."""
    for f in fields:
        b = getattr(ref, f)
        if f == "areas" and areas_int64:
            b = b.astype(np.int64)
        _same(getattr(got, f), b, f"{what}: {f}")


def _on_every_rank(results):
    """Rank 0's result, after checking every rank returned the same."""
    first = results[0]
    for r in results[1:]:
        for a, b in zip(first, r):
            for f in getattr(a, "__dataclass_fields__", ()):
                _same(getattr(b, f), getattr(a, f), f)
    return first


def test_meshes_span_the_ranks(runs):
    for rank, m in enumerate(runs["unit_mesh"]):
        assert m.size == WORLD and m.shape == {"unit": WORLD}
        assert m.rank == rank and m.coord("unit") == rank and m.device.type == "cpu"
    for rank, m in enumerate(runs["image_unit_mesh"]):
        assert m.shape == {"image": 2, "unit": 2}
        assert (m.coord("image"), m.coord("unit")) == divmod(rank, 2)


def test_pad_units():
    assert pad_units(48, 8) == 48
    assert pad_units(47, 8) == 48
    assert pad_units(3, 8) == 8
    assert pad_units(11, WORLD) == 12


def test_sharded_inspect_matches_oracle(runs):
    """11 units on 4 ranks (one padded unit), against the oracle copy, the
    unsharded engine and the JAX package's sharded function."""
    crops = _crops(0, 11)
    seg_res, insp = _on_every_rank(runs["padded"])
    ref_masks, _, _ = oracle.segment_all_units(crops, SEG)
    np.testing.assert_array_equal(seg_res.masks, ref_masks)
    _, ref_areas, ref_verd = oracle.inspect_units(crops, ref_masks, DEF)
    np.testing.assert_array_equal(insp.areas, ref_areas)
    np.testing.assert_array_equal(insp.verdicts, ref_verd)
    s_one, i_one = engine.inspect_units(crops, SEG, DEF, device="cpu")
    _held(seg_res, s_one, SEG_FIELDS, "unsharded engine")
    _held(insp, i_one, INSP_FIELDS, "unsharded engine")
    j_seg, j_insp = jmesh.inspect_units_sharded(crops, J_SEG, J_DEF)
    _held(seg_res, j_seg, SEG_FIELDS, "JAX sharded", areas_int64=False)
    _held(insp, j_insp, INSP_FIELDS, "JAX sharded", areas_int64=False)


def test_sharded_inspect_with_exclusions_and_alignment(runs):
    """The real workflow: exclusions, then a capture aligned to the
    reference's anchors per global unit index."""
    crops, o_anchors, crops2 = _aligned_case()
    seg_ref, _ = _on_every_rank(runs["reference"])
    o_masks, _, _ = oracle.segment_all_units(crops, SEG, exclusions=EXCL, is_reference=True)
    np.testing.assert_array_equal(seg_ref.masks, o_masks)
    assert seg_ref.centroid_dict() == o_anchors
    seg2, insp2 = _on_every_rank(runs["aligned"])
    o_masks2, _, o_shifts = oracle.segment_all_units(
        crops2, SEG, exclusions=EXCL, ref_centroids=o_anchors, is_reference=False)
    np.testing.assert_array_equal(seg2.masks, o_masks2)
    np.testing.assert_array_equal(seg2.shifts, o_shifts)
    assert (seg2.shifts != 0).any()
    _, o_areas, o_verd = oracle.inspect_units(crops2, o_masks2, DEF)
    np.testing.assert_array_equal(insp2.areas, o_areas)
    np.testing.assert_array_equal(insp2.verdicts, o_verd)
    s_one, i_one = engine.inspect_units(crops2, SEG, DEF, exclusions=EXCL, ref_centroids=o_anchors,
                                        is_reference=False, device="cpu")
    _held(seg2, s_one, SEG_FIELDS, "unsharded engine")
    _held(insp2, i_one, INSP_FIELDS, "unsharded engine")


def test_image_batch_sharded_matches_oracle(runs):
    """The 2 x 2 ("image", "unit") mesh over two frames, anchored."""
    grid, images, anchors = _batch_case()
    got = runs["batch"][0]
    for r in runs["batch"][1:]:
        for a, b in zip(got, r):
            _same(b, a, "ranks")
    verd, areas, found, masks, dmasks = got
    assert verd.shape == (2, grid.num_units)
    for b in range(2):
        crops = crops_for_grid(images[b], grid, device="cpu").numpy()
        o_masks, _, _ = oracle.segment_all_units(
            crops, SEG, exclusions=EXCL, ref_centroids=anchors, is_reference=False)
        np.testing.assert_array_equal(masks[b], o_masks)
        _, o_areas, o_verd = oracle.inspect_units(crops, o_masks, DEF)
        np.testing.assert_array_equal(areas[b], o_areas)
        np.testing.assert_array_equal(verd[b], o_verd)
        s_one, i_one = engine.inspect_image(images[b], grid, SEG, DEF, exclusions=EXCL,
                                            ref_centroids=anchors, is_reference=False,
                                            device="cpu")
        _same(masks[b], s_one.masks, "masks")
        _same(dmasks[b], i_one.defect_masks, "defect masks")
        _same(areas[b], i_one.areas, "areas")
        _same(found[b], i_one.valid, "valid")
        _same(verd[b], i_one.verdicts, "verdicts")
    j_grid = jcfg.GridParams(base_unit=grid.base_unit, units_x=4, units_y=2)
    ref = jmesh.inspect_image_batch_sharded(images, j_grid, J_SEG, J_DEF, exclusions=EXCL,
                                            ref_centroids=anchors,
                                            mesh=jmesh.image_unit_mesh(2))
    for name, a, b in zip(("verdicts", "areas", "valid", "masks", "defect masks"), got, ref):
        _same(a, np.asarray(b), f"JAX sharded {name}")


def test_stream_inspect_sharded(runs):
    """A ragged last batch (3 frames in batches of 2) repeats the last
    frame; its padding result is dropped."""
    grid, frames = _stream_case()
    results = runs["stream"][0]
    assert [r.index for r in results] == [0, 1, 2]
    for other in runs["stream"][1:]:
        for a, b in zip(results, other):
            for f in ("verdicts", "areas", "valid", "seg_masks", "defect_masks"):
                _same(getattr(b, f), getattr(a, f), f)
    j_grid = jcfg.GridParams(base_unit=grid.base_unit, units_x=2, units_y=2)
    ref = list(j_stream_sharded(frames, j_grid, J_SEG, J_DEF, exclusions=EXCL, fetch_masks=True))
    for r, j, frame in zip(results, ref, frames):
        crops = crops_for_grid(frame, grid, device="cpu").numpy()
        o_masks, _, _ = oracle.segment_all_units(crops, SEG, exclusions=EXCL, is_reference=True)
        _, o_areas, o_verd = oracle.inspect_units(crops, o_masks, DEF)
        np.testing.assert_array_equal(r.areas, o_areas)
        np.testing.assert_array_equal(r.verdicts, o_verd)
        assert r.ng_count == int(o_verd.sum()) == j.ng_count
        for f in ("verdicts", "areas", "valid", "seg_masks", "defect_masks"):
            _same(getattr(r, f), np.asarray(getattr(j, f)), f"JAX stream {f}")


def test_sharded_paths_without_a_process_group():
    """No process group: the mesh is one rank on this process's device and
    the sharded functions equal the unsharded engine."""
    m = unit_mesh(device="cpu")
    assert (m.size, m.rank, m.device.type) == (1, 0, "cpu")
    crops = _crops(0, 11)
    seg_res, insp = inspect_units_sharded(crops, SEG, DEF, mesh=m)
    s_one, i_one = engine.inspect_units(crops, SEG, DEF, device="cpu")
    _held(seg_res, s_one, SEG_FIELDS, "one rank")
    _held(insp, i_one, INSP_FIELDS, "one rank")
    with pytest.raises(ValueError, match="1 ranks not divisible by 2 images"):
        image_unit_mesh(2, device="cpu")
