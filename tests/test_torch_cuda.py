"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips (with its reason) when no GPU is present. The file imports
neither jax nor tpu_inspect, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance is exact equality: every kernel computes integer results.
"""

import numpy as np
import pytest
import torch

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.blob import blob_filter, blob_filter_plain
from tpu_inspect_torch.ops.canny import canny_planes
from tpu_inspect_torch.ops.cc import label_components, label_components_plain
from tpu_inspect_torch.ops.flood import propagate, propagate_plain
from tpu_inspect_torch.ops.fused import seg_tail, seg_tail_plain
from tpu_inspect_torch.ops.median import median_residual_mask, median_residual_mask_plain
from tpu_inspect_torch.ops.morphology import close_open_stages, rect_erode_stages
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.synthetic import make_mold_image, serpentine_plane

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(rng, shape, p, cuda):
    return torch.from_numpy(((rng.rand(*shape) > p) * 255).astype(np.uint8)).to(cuda)


def _assert_equal(got, ref):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 64, 41)])
def test_seg_tail_matches_plain(cuda, shape):
    rng = np.random.RandomState(4)
    gray = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(cuda)
    thr = torch.from_numpy(rng.randint(60, 200, shape[0]).astype(np.int32)).to(cuda)
    blobs = _planes(rng, shape, 0.5, cuda)
    blobs[0] = 0  # empty unit
    for args, kw in [
        ((gray, close_open_stages(3)), dict(fill=True, thr=thr)),
        ((gray, close_open_stages(7)), dict(fill=True, thr=thr)),
        ((blobs, rect_erode_stages(2)), dict(out_largest=True)),
        ((blobs, ()), dict(out_largest=True)),
    ]:
        _assert_equal(seg_tail(*args, **kw), seg_tail_plain(*args, **kw))


def test_median_residual_matches_plain(cuda):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randint(0, 256, (3, 37, 53), dtype=np.uint8)).to(cuda)
    lo = torch.tensor([0, 4, 37], dtype=torch.int32, device=cuda)
    hi = torch.tensor([37, 30, 0], dtype=torch.int32, device=cuda)
    for k, thr in [(3, 0), (21, 24), (45, 255)]:
        _assert_equal(
            median_residual_mask(x, k, thr, lo, hi),
            median_residual_mask_plain(x, k, thr, lo, hi),
        )


def test_blob_filter_matches_plain(cuda):
    rng = np.random.RandomState(8)
    cand = _planes(rng, (3, 37, 53), 0.6, cuda)
    roi = _planes(rng, (3, 37, 53), 0.1, cuda)
    max_x2 = torch.tensor([50, 4000, 0], dtype=torch.int32, device=cuda)
    for kw in [dict(min_x2=6, roi=roi, pre_open=True), dict(min_x2=0)]:
        _assert_equal(blob_filter(cand, max_x2, **kw), blob_filter_plain(cand, max_x2, **kw))


@pytest.mark.parametrize("conn8", [True, False])
def test_propagate_matches_plain(cuda, conn8):
    rng = np.random.RandomState(9)
    shape = (4, 37, 53)
    dom = _planes(rng, shape, 0.4, cuda)
    seed = _planes(rng, shape, 0.97, cuda)
    dom[0] = 0  # empty domain
    dom[1] = 255  # full domain
    _assert_equal(propagate(seed, dom, conn8), propagate_plain(seed, dom, conn8))
    _assert_equal(
        propagate(None, dom, conn8, border_seed=True),
        propagate_plain(None, dom, conn8, border_seed=True),
    )
    snake = torch.from_numpy(serpentine_plane(61, 64)[None]).to(cuda)
    tip = torch.zeros_like(snake).flatten()
    tip[snake.flatten().nonzero().max()] = 1  # seed only the path's far end
    tip = tip.reshape(snake.shape)
    got = propagate(tip, snake, conn8)
    _assert_equal(got, propagate_plain(tip, snake, conn8))
    if conn8:
        assert torch.equal(got, snake > 0), "the whole serpentine is reached"


def test_label_components_matches_plain(cuda):
    rng = np.random.RandomState(10)
    fg = _planes(rng, (3, 41, 67), 0.55, cuda) > 0
    fg[0] = False
    x = torch.from_numpy(rng.randint(0, 256, (3, 41, 67), dtype=np.uint8)).to(cuda)
    _, cand = canny_planes(x, 12, 24)
    for plane in (fg, cand, ~fg):
        got = label_components(plane.contiguous())
        assert got.dtype == torch.int32
        _assert_equal(got, label_components_plain(plane))


def test_defect_intermediates_cuda_matches_cpu(cuda):
    grid = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
    img = make_mold_image(grid, (110, 120), seed=3, defect_rate=1.0)
    crops = gather_crops(
        torch.from_numpy(img), torch.from_numpy(grid_origins(grid)), (44, 48)
    ).numpy()
    seg = teng.segment_units(crops, tcfg.SegmentationParams(), device="cpu")
    for method in ("threshold", "canny"):
        dp = tcfg.DefectParams(method=method, min_area=3, erode_px=1, threshold=10)
        for u in range(crops.shape[0]):
            reset_launches()
            got = teng.defect_intermediates(crops[u], seg.masks[u], dp, device=cuda)
            assert LAUNCHES["label"] == 2 and LAUNCHES["propagate"] >= 1
            assert got == teng.defect_intermediates(crops[u], seg.masks[u], dp, device="cpu")


@pytest.mark.parametrize("method", ["otsu/threshold", "adaptive/threshold",
                                    "otsu/canny", "adaptive/canny"])
def test_inspect_image_cuda_matches_cpu(cuda, method):
    grid = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
    img = make_mold_image(grid, (110, 120), seed=3, defect_rate=1.0)
    excl = [{"shape": "rect", "x": 5, "y": 6, "w": 10, "h": 8},
            {"shape": "circle", "cx": 30, "cy": 25, "r": 6}]
    seg_m, def_m = method.split("/")
    seg = tcfg.SegmentationParams(method=seg_m)
    dp = tcfg.DefectParams(method=def_m, min_area=3)
    g_seg, g_insp = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device=cuda)
    c_seg, c_insp = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device="cpu")
    for f in ("masks", "centroids", "centroid_valid", "shifts"):
        np.testing.assert_array_equal(getattr(g_seg, f), getattr(c_seg, f), err_msg=f)
    for f in ("defect_masks", "valid", "areas", "verdicts"):
        np.testing.assert_array_equal(getattr(g_insp, f), getattr(c_insp, f), err_msg=f)
