"""tpu_inspect_torch host helpers and torch-op stages vs the JAX package.

Same seeded numpy inputs through both packages (JAX on its CPU backend),
compared with exact equality. Also: the derived constant tables, the
no-jax import guarantee, the device rule and the nvcc error.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_inspect.config as jcfg
from tpu_inspect import engine as jeng
from tpu_inspect.geometry import grid_origins as j_grid_origins
from tpu_inspect.imageio import gather_crops as j_gather
from tpu_inspect.ops import cc as jcc
from tpu_inspect.ops import gaussian as jgauss
from tpu_inspect.ops import hole_fill as jfill
from tpu_inspect.ops import morphology as jmorph
from tpu_inspect.ops import threshold as jthr
from tpu_inspect.ops._contour_table import CONTOUR_TABLE_X2 as J_TABLE
from tpu_inspect.ops.morph_pallas import _close_open_stages, _open_stages
from tpu_inspect.ops.morph_pallas import minkowski_sum as j_minkowski
from tpu_inspect.synthetic import make_mold_image as j_make_mold
from tpu_inspect.synthetic import sample_grid_params as j_sample_grid

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.ops import cc, hole_fill, morphology, threshold
from tpu_inspect_torch.ops._contour_table import CONTOUR_TABLE_X2
from tpu_inspect_torch.ops.gaussian import (
    fixed_gaussian_kernel,
    gaussian_blur_u8,
    gaussian_blur_u8_plain,
)
from tpu_inspect_torch.synthetic import make_mold_image, sample_grid_params

ROOT = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constant_tables_match_reference():
    np.testing.assert_array_equal(CONTOUR_TABLE_X2, J_TABLE)
    assert CONTOUR_TABLE_X2.dtype == J_TABLE.dtype
    for k in (1, 3, 5, 7, 9, 21, 31):
        np.testing.assert_array_equal(
            fixed_gaussian_kernel(k), jgauss.fixed_gaussian_kernel(k)
        )
    for k in range(1, 32):
        np.testing.assert_array_equal(morphology.ellipse_se(k), jmorph.ellipse_se(k))
        se = morphology.ellipse_se(k)
        np.testing.assert_array_equal(
            morphology.minkowski_sum(se, se), j_minkowski(se, se)
        )
        if k % 2:
            assert morphology.close_open_stages(k) == _close_open_stages(k)
        else:
            # an even ellipse's anchor is off centre, where B (+) B is not
            # erode-twice: the port runs close then open as four stages,
            # the JAX package's split path's morph_close + morph_open (the
            # three stages differ from them at k = 2 and 4)
            runs = _close_open_stages(k)[0][1]
            assert morphology.close_open_stages(k) == (
                ("dilate", runs), ("erode", runs), ("erode", runs), ("dilate", runs))
            if k <= 4:
                x = (np.random.RandomState(k).rand(2, 40, 52) < 0.5).astype(np.uint8) * 255
                ref = jmorph.morph_open(jmorph.morph_close(jnp.asarray(x), se), se)
                np.testing.assert_array_equal(
                    morphology.apply_stages(_t(x), morphology.close_open_stages(k)).numpy(),
                    np.asarray(ref), err_msg=f"close/open k={k}")
        assert morphology.open_stages(k) == _open_stages(k)
    for n in (0, 1, 6, 13):
        assert morphology.rect_erode_stages(n) == jeng._roi_erode_stages(n)


def test_config_from_reference_and_geometry():
    seg = jcfg.SegmentationParams(gaussian_blur=4, morph_kernel=7)
    dp = jcfg.DefectParams(threshold=30, min_area=5, erode_px=2)
    grid = j_sample_grid()
    assert tcfg.from_reference(seg) == tcfg.SegmentationParams(
        gaussian_blur=4, morph_kernel=7
    )
    assert tcfg.from_reference(dp).validated() == tcfg.DefectParams(
        threshold=30, min_area=5, erode_px=2
    )
    assert tcfg.from_reference(grid) == sample_grid_params()
    ip = tcfg.from_reference(jcfg.InspectionParams(segmentation=seg, defect=dp))
    assert ip.segmentation.morph_kernel == 7 and ip.defect.erode_px == 2
    with pytest.raises(TypeError):
        tcfg.from_reference(object())
    np.testing.assert_array_equal(grid_origins(sample_grid_params()), j_grid_origins(grid))
    g = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
    img = make_mold_image(g, (110, 120), seed=3, defect_rate=1.0, shift=(2, -1))
    ref = j_make_mold(tcfg_to_j(g), (110, 120), seed=3, defect_rate=1.0, shift=(2, -1))
    np.testing.assert_array_equal(img, ref)


def tcfg_to_j(g):
    return jcfg.GridParams(**g.__dict__)


def test_gather_crops_clamps_like_dynamic_slice():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (50, 70), dtype=np.uint8)
    origins = np.array([[0, 0], [60, 3], [-5, 45], [10, 10]], dtype=np.int32)
    got = gather_crops(_t(img), _t(origins), (12, 16)).numpy()
    ref = np.asarray(j_gather(jnp.asarray(img), jnp.asarray(origins), unit_hw=(12, 16)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 3, 4, 9, 31])
def test_gaussian_blur_matches_reference(k):
    rng = np.random.RandomState(k)
    x = rng.randint(0, 256, (3, 20, 23), dtype=np.uint8)
    kk = k if k % 2 else k + 1
    ref = np.asarray(jgauss.gaussian_blur_u8(jnp.asarray(x), kk))
    # the plain version (kernel M's contract) and the public name on a CPU
    # tensor, which runs it
    np.testing.assert_array_equal(gaussian_blur_u8_plain(_t(x), kk).numpy(), ref)
    np.testing.assert_array_equal(gaussian_blur_u8(_t(x), kk).numpy(), ref)


def test_histogram_and_otsu_match_reference():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 256, (6, 24, 31), dtype=np.uint8)
    x[1] = 77  # uniform unit: threshold 0
    x[2] = np.where(rng.rand(24, 31) > 0.5, 40, 200)  # two-level unit
    x[3, :, :5] = 0
    hist = threshold.histogram_u8(_t(x)).numpy()
    np.testing.assert_array_equal(hist, np.asarray(jthr.histogram_u8(jnp.asarray(x))))
    got = threshold.otsu_threshold(_t(x)).numpy()
    ref = np.asarray(jthr.otsu_threshold(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    t = torch.tensor([100, 0, 255, 50, 128, 3], dtype=torch.int32)
    np.testing.assert_array_equal(
        threshold.threshold_binary_inv(_t(x), t).numpy(),
        np.asarray(jthr.threshold_binary_inv(jnp.asarray(x), jnp.asarray(t.numpy()))),
    )
    for thr in (0, 24, 255):
        np.testing.assert_array_equal(
            threshold.threshold_binary(_t(x), thr).numpy(),
            np.asarray(jthr.threshold_binary(jnp.asarray(x), thr)),
        )


@pytest.mark.parametrize(
    "stages_name",
    ["close_open3", "close_open7", "close_open31", "open3", "erode2", "erode6", "erode20"],
)
def test_apply_stages_matches_reference(stages_name):
    rng = np.random.RandomState(11)
    x = ((rng.rand(3, 30, 33) > 0.5) * 255).astype(np.uint8)
    x[1, :, -1] = 255  # fg on the right/bottom edges
    x[1, -1, :] = 255
    xj = jnp.asarray(x)
    if stages_name.startswith("close_open"):
        k = int(stages_name[len("close_open"):])
        stages = morphology.close_open_stages(k)
        se = jmorph.ellipse_se(k)
        ref = jmorph.morph_open(jmorph.morph_close(xj, se), se)
    elif stages_name == "open3":
        stages = morphology.open_stages(3)
        ref = jmorph.morph_open(xj, jmorph.ellipse_se(3))
    else:
        n = int(stages_name[len("erode"):])
        stages = morphology.rect_erode_stages(n)
        ref = jmorph.erode_rect3(xj, n)
    got = morphology.apply_stages(_t(x), stages).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_hole_fill_matches_reference():
    rng = np.random.RandomState(2)
    m = ((rng.rand(4, 26, 29) > 0.45) * 255).astype(np.uint8)
    m[0] = 0
    m[1, 5:20, 5:20] = 255
    m[1, 9:15, 9:15] = 0  # a hole
    got = hole_fill.fill_holes(_t(m)).numpy()
    ref = np.asarray(jfill.fill_holes(jnp.asarray(m))) > 0
    np.testing.assert_array_equal(got, ref)


def test_largest_component_tie_break_block_raster():
    # two single-pixel components of equal area: pixel-raster order puts
    # (2, 28) first, OpenCV's 2x2-block raster order puts (3, 0) first
    fg = np.zeros((2, 8, 32), bool)
    fg[0, 2, 28] = True
    fg[0, 3, 0] = True
    fg[1] = np.random.RandomState(3).rand(8, 32) > 0.6
    mask, stats = cc.largest_component(_t(fg))
    ref = jcc.largest_component_sums(jnp.asarray(fg))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[0]))
    assert mask[0, 3, 0] and not mask[0, 2, 28]
    for col, r in zip((0, 1, 2, 3), ref[1:]):
        np.testing.assert_array_equal(stats[:, col].numpy(), np.asarray(r).astype(np.int32))
    np.testing.assert_array_equal(
        cc.label_components(_t(fg)).numpy(),
        np.asarray(jcc.label_components(jnp.asarray(fg))),
    )


def test_exclusion_zone_matches_reference():
    rects, circles = teng.pack_exclusions(
        [{"shape": "rect", "x": 3, "y": 4, "w": 9, "h": 6},
         {"shape": "circle", "cx": 20, "cy": 11, "r": 5},
         {"shape": "circle", "cx": 2, "cy": 2, "r": 0},
         {"shape": "bogus"}, "not a dict"]
    )
    jr, jc = jeng.pack_exclusions(
        [{"shape": "rect", "x": 3, "y": 4, "w": 9, "h": 6},
         {"shape": "circle", "cx": 20, "cy": 11, "r": 5},
         {"shape": "circle", "cx": 2, "cy": 2, "r": 0},
         {"shape": "bogus"}, "not a dict"]
    )
    np.testing.assert_array_equal(rects, jr)
    np.testing.assert_array_equal(circles, jc)
    dx = np.array([0, 3, -4], np.int32)
    dy = np.array([0, -2, 5], np.int32)
    got = teng.exclusion_zone((24, 30), rects, circles, _t(dx), _t(dy)).numpy()
    ref = np.asarray(jeng.exclusion_zone(
        (24, 30), jnp.asarray(jr), jnp.asarray(jc), jnp.asarray(dx), jnp.asarray(dy)))
    np.testing.assert_array_equal(got, ref)
    sums = np.array([[10, 20, 3], [0, 0, 0]], np.int64)
    np.testing.assert_array_equal(
        teng.centroids_from_sums(sums), jeng.centroids_from_sums(sums))
    a, v = teng.ref_centroid_arrays({0: (1.5, 2.5), 9: (1, 1)}, 3)
    ja, jv = jeng.ref_centroid_arrays({0: (1.5, 2.5), 9: (1, 1)}, 3)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(v, jv)


def test_engine_import_loads_no_jax():
    code = (
        "import sys, tpu_inspect_torch.engine, tpu_inspect_torch.synthetic, "
        "tpu_inspect_torch.ops.canny, tpu_inspect_torch.ops.contour, "
        "tpu_inspect_torch.ops.flood, tpu_inspect_torch.session, "
        "tpu_inspect_torch.render, tpu_inspect_torch.ui.server, "
        "tpu_inspect_torch.persistence, tpu_inspect_torch.imageio, "
        "tpu_inspect_torch.viewport, tpu_inspect_torch.utils, "
        "tpu_inspect_torch.streaming, tpu_inspect_torch.cli, tpu_inspect_torch.native, "
        "tpu_inspect_torch.utils.profile, tpu_inspect_torch.tools.median_probe, "
        "tpu_inspect_torch.tools.kernel_bench, tpu_inspect_torch.parallel, "
        "tpu_inspect_torch.parallel.launch, tpu_inspect_torch.parallel.mesh, "
        "tpu_inspect_torch.parallel.strips, tpu_inspect_torch.bench, "
        "tpu_inspect_torch.tools.fuzz_parity; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpu_inspect' or m.startswith('tpu_inspect.') "
        "or m == 'cv2' or m.startswith('cv2.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_package_all_covers_jax_package():
    """The port's top-level names cover the JAX package's, each resolving
    (lazily, without building a kernel) to the port's own object."""
    import tpu_inspect
    import tpu_inspect_torch
    from tpu_inspect_torch.persistence import load_grid
    from tpu_inspect_torch.session import InspectionSession

    missing = set(tpu_inspect.__all__) - set(tpu_inspect_torch.__all__)
    assert not missing, missing
    for name in tpu_inspect_torch.__all__:
        assert getattr(tpu_inspect_torch, name).__module__.startswith("tpu_inspect_torch"), name
    assert tpu_inspect_torch.InspectionSession is InspectionSession
    assert tpu_inspect_torch.load_grid is load_grid
    with pytest.raises(AttributeError):
        tpu_inspect_torch.no_such_name


def test_parallel_names_cover_jax_package():
    """``tpu_inspect_torch.parallel`` exports the JAX package's multi-chip
    names, and the stream its sharded loop."""
    import tpu_inspect.parallel
    import tpu_inspect_torch.parallel
    from tpu_inspect_torch import streaming

    assert tpu_inspect_torch.parallel.__all__ == tpu_inspect.parallel.__all__
    for name in tpu_inspect_torch.parallel.__all__:
        obj = getattr(tpu_inspect_torch.parallel, name)
        assert obj.__module__.startswith("tpu_inspect_torch.parallel"), name
    assert streaming.stream_inspect_sharded.__module__ == "tpu_inspect_torch.streaming"


def test_resolve_device_raises_without_cuda(monkeypatch):
    from tpu_inspect_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        teng.inspect_image(
            np.zeros((10, 10), np.uint8),
            tcfg.GridParams(base_unit=(0, 0, 4, 4)),
            tcfg.SegmentationParams(),
        )
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_raises_clear_error_without_nvcc(monkeypatch, tmp_path):
    from tpu_inspect_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    real_isfile = build.os.path.isfile
    monkeypatch.setattr(
        build.os.path, "isfile",
        lambda p: False if str(p).endswith("nvcc") else real_isfile(p),
    )
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_kernel_error_flag_raises():
    from tpu_inspect_torch.kernels import build

    build.check_bounded("propagate", torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="iteration bound"):
        build.check_bounded("propagate", torch.ones((1,), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        build.check("label_components", 2)


def test_wrappers_reject_bad_inputs():
    from tpu_inspect_torch.ops.blob import blob_filter
    from tpu_inspect_torch.ops.cc import label_components
    from tpu_inspect_torch.ops.flood import propagate
    from tpu_inspect_torch.ops.fused import seg_tail
    from tpu_inspect_torch.ops.median import median_residual_mask

    x = torch.zeros((2, 8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        seg_tail(x.to(torch.int32))
    with pytest.raises(ValueError):
        seg_tail(x[:, :, ::2])  # not contiguous
    with pytest.raises(ValueError):
        seg_tail(x, thr=torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError):
        median_residual_mask(x, 4, 10)  # even k
    with pytest.raises(ValueError):
        median_residual_mask(x, 47, 10)  # k*k >= 2048
    with pytest.raises(ValueError):
        blob_filter(x, torch.zeros((2,), dtype=torch.int64), min_x2=0)
    with pytest.raises(ValueError):
        propagate(x, x[:1], conn8=True)  # seed and domain differ in shape
    with pytest.raises(ValueError):
        propagate(x.to(torch.int32), x, conn8=False)
    with pytest.raises(ValueError):
        label_components(x.to(torch.int32))
    with pytest.raises(ValueError):
        label_components((x > 0)[:, :, ::2])  # not contiguous


def test_host_copies_match_reference(tmp_path):
    """persistence, logging, viewport, geometry and the UI asset equal their
    originals in the JAX package."""
    import json

    from tpu_inspect import geometry as jgeo
    from tpu_inspect import persistence as jper
    from tpu_inspect import viewport as jvp
    from tpu_inspect.utils import logging as jlog

    from tpu_inspect_torch import geometry as tgeo
    from tpu_inspect_torch import persistence as tper
    from tpu_inspect_torch import viewport as tvp
    from tpu_inspect_torch.utils import logging as tlog

    assert (ROOT / "tpu_inspect_torch/ui/app.html").read_bytes() == (
        ROOT / "tpu_inspect/ui/app.html").read_bytes()
    # logging: the same lines, the same cap
    logs = (tlog.InspectionLog(max_lines=5), jlog.InspectionLog(max_lines=5))
    for lg in logs:
        lg.log("start")
        lg.unit_verdict(3, 25, 20)
        lg.unit_verdict(4, 5, 20)
        lg.unit_no_defects(7)
        lg.batch_summary(2, 48)
        lg.inspection_summary(8, 48)
        with tlog.stage_timer("stage", lg):
            pass
    assert list(logs[0].lines)[:-1] == list(logs[1].lines)[:-1]
    assert logs[0].tail(3)[:2] == logs[1].tail(3)[:2]
    assert logs[0].lines[-1].startswith("stage: ") and logs[0].lines[-1].endswith(" ms")
    # viewport
    vps = (tvp.Viewport(4096, 3000, 1200, 800), jvp.Viewport(4096, 3000, 1200, 800))
    for vp in vps:
        vp.zoom_in()
        vp.center_on_cell((1500, 900, 316, 315))
        vp.zoom_out(1.5)
    assert vars(vps[0]) == vars(vps[1])
    for vp in vps:
        assert vp.display_to_img(333.7, 91.2) == vps[1].display_to_img(333.7, 91.2)
        assert vp.visible_image_rect() == vps[1].visible_image_rect()
        assert vp.imgrect_to_display((5, 6, 70, 80)) == vps[1].imgrect_to_display((5, 6, 70, 80))
    # geometry
    boxes = [(0, 0, 40, 30), (50, 60, 40, 30)]
    for meta in ({}, {"base_unit": {"x": 0, "y": 0, "w": 40, "h": 30}, "units_x": 2},
                 {"base_unit": {"x": 0, "y": 0, "w": 40, "h": 30}, "units_x": 2,
                  "unit_space_x": 10}):
        g, jg = tgeo.infer_grid_params(boxes, meta), jgeo.infer_grid_params(boxes, meta)
        assert type(g).__name__ == type(jg).__name__
        assert tgeo.grid_boxes(g) == jgeo.grid_boxes(jg)
        np.testing.assert_array_equal(tgeo.grid_origins(g), jgeo.grid_origins(jg))
    for excl in ({"shape": "rect", "x": -4, "y": 50, "w": 90, "h": 3},
                 {"shape": "circle", "cx": 39, "cy": 2, "r": 9},
                 {"shape": "circle", "cx": 12, "cy": 12, "r": 0}, {"shape": "poly"}):
        assert tgeo.clamp_exclusion_to_base_unit(excl, 40, 30) == \
            jgeo.clamp_exclusion_to_base_unit(excl, 40, 30)
    with pytest.raises(ValueError):
        tgeo.BoxGrid(((0, 0, 4, 4), (5, 5, 4, 5)))
    # synthetic.crop_units
    from tpu_inspect.synthetic import crop_units as j_crop_units

    from tpu_inspect_torch.synthetic import crop_units

    img = make_mold_image(sample_grid_params(), (3000, 4096), seed=2)
    boxes = ((0, 0, 40, 30), (50, 60, 40, 30))
    for grid, jgrid in ((sample_grid_params(), j_sample_grid()),
                        (tgeo.BoxGrid(boxes), jgeo.BoxGrid(boxes))):
        got, ref = crop_units(img, grid), j_crop_units(img, jgrid)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # persistence: the same JSON documents, CSV rows and mask pixels
    grid = tcfg.GridParams(base_unit=(3, 4, 20, 16), units_x=2, blocks_y=2, block_space_y=5)
    jgrid = jcfg.GridParams(**grid.__dict__)
    excl = [{"shape": "rect", "x": 1, "y": 2, "w": 3, "h": 4}]
    cents = {0: (1.5, 2.25), 3: (7.0, 8.0)}
    doc = tper.GridDocument(tgeo.grid_boxes(grid), tper.grid_metadata(grid, 64, 48),
                            excl, cents)
    jdoc = jper.GridDocument(jgeo.grid_boxes(jgrid), jper.grid_metadata(jgrid, 64, 48),
                             excl, cents)
    assert tper.save_grid(doc, tmp_path / "t.json") == jper.save_grid(jdoc, tmp_path / "j.json")
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    box_meta = tper.grid_metadata(tgeo.BoxGrid(((0, 0, 5, 5),)), 9, 9)
    assert box_meta == jper.grid_metadata(jgeo.BoxGrid(((0, 0, 5, 5),)), 9, 9)
    for src in (tmp_path / "t.json", [{"x": 1, "y": 2, "w": 3, "h": 4}, {"bad": 1}],
                {"boxes": [{"index": 1, "x": 0, "y": 0, "w": 2, "h": 2},
                           {"index": 0, "x": 5, "y": 0, "w": 2, "h": 2}],
                 "exclusion_alignment": {"type": "other", "ref_centroids": {"0": {}}}}):
        a, b = tper.load_grid(src), jper.load_grid(src)
        assert (a.boxes, a.metadata, a.exclusions, a.ref_centroids, a.version) == \
            (b.boxes, b.metadata, b.exclusions, b.ref_centroids, b.version)
        assert tgeo.grid_boxes(a.grid_params) == jgeo.grid_boxes(b.grid_params)
        assert a.unit_shape == b.unit_shape
    rng = np.random.RandomState(4)
    masks = [((rng.rand(16, 20) > 0.5) * 255).astype(np.uint8), None,
             np.zeros((16, 20), np.uint8)]
    paths = (tper.export_masks_and_csv(masks, tmp_path / "tm"),
             jper.export_masks_and_csv(masks, tmp_path / "jm"))
    assert tper.load_masks_csv(paths[0]) == jper.load_masks_csv(paths[1])
    assert tper.export_thumbnails(masks, tmp_path / "tt") == 2
    import cv2

    for name in ("tm/mask_0000.png", "tm/mask_0002.png", "tt/unit_0000.png"):
        got = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, masks[int(name[-5])])
    combined = tper.export_combined_json(doc, masks, tmp_path / "c.json")
    jcombined = jper.export_combined_json(jdoc, masks)
    assert [m["index"] for m in combined["masks"]] == [m["index"] for m in jcombined["masks"]]
    assert {k: v for k, v in combined.items() if k != "masks"} == \
        {k: v for k, v in jcombined.items() if k != "masks"}
    for fn, src in ((tper.import_combined_json, tmp_path / "c.json"),
                    (jper.import_combined_json, jcombined)):
        d, ms = fn(src)
        assert d.boxes == doc.boxes and sorted(ms) == [0, 2]
        np.testing.assert_array_equal(ms[0], masks[0])


def test_png_encoder_and_gray_decode_match_cv2(tmp_path):
    """The port's PNG bytes decode (cv2) to the same pixels; the host
    decode and the BT.601 conversion equal the JAX package's."""
    import cv2

    from tpu_inspect.imageio import _to_gray_u8 as j_to_gray
    from tpu_inspect.imageio import crops_for_grid as j_crops_for_grid
    from tpu_inspect.imageio import decode_gray as j_decode_gray
    from tpu_inspect.ops.color import bgr_to_gray as j_bgr_to_gray

    from tpu_inspect_torch import imageio as tio
    from tpu_inspect_torch.ops.color import bgr_to_gray, rgb_to_gray
    from tpu_inspect_torch.png import encode_png

    rng = np.random.RandomState(8)
    gray = rng.randint(0, 256, (13, 17), dtype=np.uint8)
    rgb = rng.randint(0, 256, (9, 11, 3), dtype=np.uint8)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(encode_png(gray), np.uint8),
                                               cv2.IMREAD_UNCHANGED), gray)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(encode_png(rgb), np.uint8),
                                               cv2.IMREAD_UNCHANGED)[:, :, ::-1], rgb)
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))
    bgr = rng.randint(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(bgr_to_gray(_t(bgr)).numpy(),
                                  np.asarray(j_bgr_to_gray(jnp.asarray(bgr))))
    np.testing.assert_array_equal(rgb_to_gray(_t(bgr[..., ::-1])).numpy(),
                                  bgr_to_gray(_t(bgr)).numpy())
    for img in (gray, rgb, np.dstack([rgb, rgb[..., :1]]),
                (rng.rand(6, 5) * 65535).astype(np.uint16),
                rng.rand(6, 5).astype(np.float32) * 7 - 2):
        np.testing.assert_array_equal(tio._to_gray_u8(img), j_to_gray(img))
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, rgb)
    np.testing.assert_array_equal(tio.load_gray(path), j_to_gray(rgb))
    np.testing.assert_array_equal(tio.decode_gray(encode_png(gray)), j_decode_gray(
        cv2.imencode(".png", gray)[1].tobytes()))
    with pytest.raises(RuntimeError):
        tio.load_gray(str(tmp_path / "missing.png"))
    grid = tcfg.GridParams(base_unit=(2, 3, 5, 4), units_x=2, units_y=2, unit_space_x=1)
    np.testing.assert_array_equal(
        tio.crops_for_grid(gray, grid, "cpu").numpy(),
        np.asarray(j_crops_for_grid(gray, jcfg.GridParams(**grid.__dict__))))


@pytest.mark.parametrize("shape", ["rect", "rectangle", "circle"])
def test_exclusion_from_drawn_rect_matches_reference(shape):
    """``geometry.exclusion_from_drawn_rect`` equals the JAX package's on
    seeded drawn rects: inside, across the unit's edges, outside it (None)
    and degenerate (zero width)."""
    from tpu_inspect.geometry import exclusion_from_drawn_rect as j_from_rect

    from tpu_inspect_torch.geometry import exclusion_from_drawn_rect

    rng = np.random.RandomState(len(shape))
    base = (40, 30, 316, 315)
    drawn = [tuple(int(v) for v in rng.randint(-50, 400, 4)) for _ in range(40)]
    drawn += [(0, 0, 10, 10), (60, 50, 0, 20), (356, 345, 5, 5), (35, 25, 400, 400)]
    outs = [exclusion_from_drawn_rect(d, base, shape) for d in drawn]
    assert outs == [j_from_rect(d, base, shape) for d in drawn]
    assert None in outs and any(o is not None for o in outs)


def test_random_blob_mask_matches_reference():
    """``synthetic.random_blob_mask`` renders the JAX package's pixels from
    the same seed."""
    from tpu_inspect.synthetic import random_blob_mask as j_blobs

    from tpu_inspect_torch.synthetic import random_blob_mask

    for seed, (h, w), n, scale in [(0, (48, 56), 5, 0.2), (3, (40, 44), 1, 0.4),
                                   (7, (1, 9), 2, 0.2), (11, (64, 31), 6, 0.08)]:
        got = random_blob_mask(h, w, seed=seed, n_blobs=n, scale=scale)
        ref = j_blobs(h, w, seed=seed, n_blobs=n, scale=scale)
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_contour_area_matches_reference():
    """``BlobAnalysis.contour_area`` (the JAX package's property): twice the
    area as float64, halved."""
    from tpu_inspect.ops import contour as jcontour
    from tpu_inspect_torch.ops.contour import analyze_blobs

    rng = np.random.RandomState(4)
    fg = rng.rand(2, 21, 26) > 0.6
    got = analyze_blobs(_t(fg)).contour_area
    ref = jcontour.analyze_blobs(jnp.asarray(fg)).contour_area
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_result_invariant_keywords_of_the_reference():
    """The JAX package's result-invariant keywords are taken as it calls
    them, ``plan`` and ``rows_per_step``; a positional third argument no
    longer reaches the bound flag, which is keyword-only."""
    from tpu_inspect.ops import median as jmedian
    from tpu_inspect_torch.ops.median import median_blur_u8

    rng = np.random.RandomState(6)
    fg = rng.rand(2, 17, 23) > 0.55
    ref = np.asarray(jcc.label_components(jnp.asarray(fg), plan="rc"))
    np.testing.assert_array_equal(cc.label_components(_t(fg), plan="rc").numpy(), ref)
    np.testing.assert_array_equal(cc.label_components(_t(fg), "rc").numpy(), ref)
    x = rng.randint(0, 256, (2, 13, 15), dtype=np.uint8)
    for rows in (5, 3):
        got = median_blur_u8(torch.from_numpy(x), 5, rows_per_step=rows)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmedian.median_blur_u8(jnp.asarray(x), 5, rows_per_step=rows)))
    with pytest.raises(TypeError):
        cc.label_components(_t(fg), "rc", None)


def test_otsu_binary_inv_matches_reference():
    """``threshold.otsu_binary_inv`` (the Otsu kernel's threshold, then the
    compare) against the JAX package's, dtypes included: random, empty (all
    0), full (all 255), two-level and mold units."""
    rng = np.random.RandomState(21)
    x = rng.randint(0, 256, (6, 24, 31), dtype=np.uint8)
    x[1] = 0
    x[2] = 255
    x[3] = np.where(rng.rand(24, 31) > 0.5, 40, 200)
    mold = make_mold_image(sample_grid_params(), (300, 400), seed=2)
    x[4], x[5] = mold[232:256, 251:282], mold[260:284, 300:331]
    got = threshold.otsu_binary_inv(_t(x)).numpy()
    ref = np.asarray(jthr.otsu_binary_inv(jnp.asarray(x)))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("se_name", ["ellipse3", "ellipse7", "rect5", "cross3"])
def test_morph_close_matches_reference(se_name):
    """``morphology.morph_close`` (dilate then erode in one launch of kernel
    I) against the JAX package's on 0/255 planes: random, edge-touching,
    empty and full units."""
    se = {"ellipse3": jmorph.ellipse_se(3), "ellipse7": jmorph.ellipse_se(7),
          "rect5": np.ones((5, 5), np.uint8),
          "cross3": np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)}[se_name]
    rng = np.random.RandomState(13)
    x = ((rng.rand(4, 30, 33) > 0.55) * 255).astype(np.uint8)
    x[1, :, -1] = 255  # fg on the right/bottom edges
    x[1, -1, :] = 255
    x[2] = 0
    x[3] = 255
    got = morphology.morph_close(_t(x), se).numpy()
    ref = np.asarray(jmorph.morph_close(jnp.asarray(x), se))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_component_areas_matches_reference():
    """``cc.component_areas`` (a torch scatter) against the JAX package's on
    its own labels: random blobs, two equal-area components, empty and
    full units."""
    rng = np.random.RandomState(17)
    fg = rng.rand(4, 22, 27) > 0.55
    fg[1] = False
    fg[1, 2:5, 3:6] = fg[1, 10:13, 20:23] = True  # a tie at area 9
    fg[2] = False
    fg[3] = True
    labels = cc.label_components(_t(fg))
    got = cc.component_areas(labels, _t(fg)).numpy()
    jfg = jnp.asarray(fg)
    ref = np.asarray(jcc.component_areas(jcc.label_components(jfg), jfg))
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert sorted(got[1][got[1] > 0]) == [9, 9] and got[3].max() == 22 * 27


def _public_names(path: Path) -> set[str]:
    """Module-level public functions, classes and assigned names of a file."""
    import ast

    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_")}


def test_module_names_cover_jax_package():
    """Every module of the JAX package has a module of the same name in the
    port holding its public names, but the deliberate non-ports: the
    ``*_pallas.py`` modules (their kernels live in ``ops/*.py`` and
    ``csrc/``), the TPU trace parser ``utils/xprof.py`` and the TPU
    compile-failure switch ``ops/common.fused_disabled``."""
    jax_root, port_root = ROOT / "tpu_inspect", ROOT / "tpu_inspect_torch"
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root)
        if rel.name.endswith("_pallas.py") or str(rel) == "utils/xprof.py":
            continue
        names = _public_names(path) - _public_names(port_root / rel)
        if names:
            missing[str(rel)] = sorted(names)
    assert missing == {"ops/common.py": ["fused_disabled"]}
