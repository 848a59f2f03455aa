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
from tpu_inspect_torch.ops.gaussian import fixed_gaussian_kernel, gaussian_blur_u8
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
        assert morphology.close_open_stages(k) == _close_open_stages(k)
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
    got = gaussian_blur_u8(_t(x), kk).numpy()
    ref = np.asarray(jgauss.gaussian_blur_u8(jnp.asarray(x), kk))
    np.testing.assert_array_equal(got, ref)


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
        "tpu_inspect_torch.ops.flood; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'tpu_inspect' or m.startswith('tpu_inspect.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


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
