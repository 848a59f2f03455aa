"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips (with its reason) when no GPU is present. The file imports
neither jax nor tpu_inspect, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance is exact equality: every kernel computes integer results.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_inspect_torch import config as tcfg
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.blob import blob_filter, blob_filter_plain
from tpu_inspect_torch.ops.blob_select import blob_select, blob_select_plain
from tpu_inspect_torch.ops.canny import canny_planes, canny_planes_plain, canny_u8
from tpu_inspect_torch.ops.contour import fill_regions
from tpu_inspect_torch.ops.cc import (
    component_stats,
    component_stats_plain,
    label_components,
    label_components_plain,
    largest_component,
    largest_component_sums,
)
from tpu_inspect_torch.ops.flood import propagate, propagate_plain
from tpu_inspect_torch.ops.gaussian import (
    adaptive_gaussian_mean,
    adaptive_gaussian_mean_plain,
    gaussian_blur_u8,
    gaussian_blur_u8_plain,
)
from tpu_inspect_torch.ops.fused import seg_roi_tail, seg_roi_tail_plain, seg_tail, seg_tail_plain
from tpu_inspect_torch.ops.median import (
    _median_residual,
    median_blur_u8,
    median_blur_u8_plain,
    median_residual_mask,
    median_residual_mask_plain,
)
from tpu_inspect_torch.ops.morphology import (
    apply_stages,
    close_open_stages,
    morph_chain,
    morph_chain_plain,
    open_stages,
    rect_erode_stages,
)
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.kernels import build, error_flag
from tpu_inspect_torch.ops.threshold import (
    adaptive_threshold_inv,
    adaptive_threshold_inv_plain,
    otsu_threshold,
)
from tpu_inspect_torch.streaming import stream_inspect
from tpu_inspect_torch.synthetic import (
    canny_edge_planes,
    make_mold_image,
    serpentine_plane,
    standard_workload,
)
from tpu_inspect_torch.tools.median_probe import MODES, STRIPS, probe

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("block", [9, 51, 119, 201])
def test_adaptive_mean_matches_cpu(cuda, block):
    """The adaptive Gaussian mean on the card (kernel N, one fused
    multiply-add instruction a step) equals ``device="cpu"`` (the plain
    version, each fused multiply-add exact in float64): unit 0 of the fuzz
    tool's seed 3014 trial 91 blurred at 25 (where the mean first differed
    from OpenCV's), and random planes of widths 1, 33 and 316 with a flat
    and a saturated one."""
    from tpu_inspect_torch.imageio import crops_for_grid
    from tpu_inspect_torch.tools import fuzz_parity as fp

    t = fp.trials(3014, 1, start=91)[0]
    crop = crops_for_grid(fp.capture(t, False), t.get("grid"), device="cpu")[:1]
    rng = np.random.RandomState(block)
    planes = [gaussian_blur_u8(crop, 25)] + [
        torch.from_numpy(rng.randint(0, 256, (3, 40, w)).astype(np.uint8)) for w in (1, 33, 316)]
    planes[-1][1], planes[-1][2] = 0, 255
    for x in planes:
        got = adaptive_gaussian_mean(x.to(cuda), block)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), adaptive_gaussian_mean(x, block), rtol=0, atol=0)


# edge shapes of kernels M and N: widths 1 and 31-33 (a warp's strip and
# its neighbours), H = 1, and units narrower than the pad (numpy's reflect
# reflects again there; the replicate border clamps)
_HEAD_SHAPES = ((3, 40, 1), (2, 1, 64), (2, 37, 31), (1, 33, 32), (2, 29, 33), (1, 2, 2),
                (1, 7, 2), (1, 1, 1))


@functools.lru_cache(maxsize=1)
def _workload_planes() -> tuple[torch.Tensor, torch.Tensor]:
    """The standard workload's 48 crops and its image as one 1x3000x4096
    unit, on the CPU (made once: the workload's image takes about a second
    to draw)."""
    wl = standard_workload()
    image = torch.from_numpy(wl["image"])
    crops = gather_crops(image, torch.from_numpy(wl["origins"]), wl["unit_hw"])
    return crops.contiguous(), image[None].contiguous()


def _workload_crops3() -> torch.Tensor:
    """The standard workload's first 3 crops."""
    return _workload_planes()[0][:3].contiguous()


# kernels M's and N's vector paths at their edges: widths around 4-byte
# words, a warp's 32 and 128 columns, and the workload's 316, at H = 1, 2
# and 40; and 130, where at block 3 the last word that N stages for its
# second strip of 64 columns reaches past the plane's last column
_HEAD_WIDTHS = tuple((1, hh, ww) for hh in (1, 2, 40)
                     for ww in (1, 2, 3, 4, 5, 15, 16, 17, 31, 32, 33, 127, 128, 129, 130, 316))


def _head_planes(cuda, seed, family="edges", blurred=False):
    """Planes of the card's own generator: ``edges``, the edge shapes with a
    flat and a saturated unit, a view ``x[1:]`` of a [3, 7, 5] plane (its
    base not 4-byte aligned), and the standard workload's first 3 crops,
    raw and blurred at 3 (the adaptive path's input); ``widths``, the
    widths of ``_HEAD_WIDTHS``; ``workload``, the standard workload's 48
    crops and its whole plane (blurred at 3 where ``blurred``: kernel N's
    input on the adaptive path)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if family == "widths":
        return [torch.randint(0, 256, s, generator=gen, device=cuda, dtype=torch.uint8)
                for s in _HEAD_WIDTHS]
    if family == "workload":
        planes = [p.to(cuda) for p in _workload_planes()]
        return [gaussian_blur_u8_plain(p, 3).contiguous() for p in planes] if blurred else planes
    planes = [torch.randint(0, 256, s, generator=gen, device=cuda, dtype=torch.uint8)
              for s in _HEAD_SHAPES + ((3, 7, 5),)]
    planes[2][1] = 77
    planes[4][1] = 255
    planes[-1] = planes[-1][1:]
    assert planes[-1].is_contiguous() and planes[-1].data_ptr() % 4
    crops = _workload_crops3().to(cuda)
    return planes + [crops, gaussian_blur_u8_plain(crops, 3).contiguous()]


@pytest.mark.parametrize("family", ["edges", "widths", "workload"])
@pytest.mark.parametrize("k,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (9, 0.0), (9, 1.7), (25, 0.0),
                                     (31, 0.0)])
def test_gauss_blur_kernel_matches_plain(cuda, k, sigma, family):
    """Kernel M (the bit-exact u8 blur) against its plain version on the
    card at every edge shape, every width of ``_HEAD_WIDTHS``, an unaligned
    view and the workload's planes: one launch a call, exact."""
    planes = _head_planes(cuda, k, family)
    reset_launches()
    for x in planes:
        got = gaussian_blur_u8(x, k, sigma)
        assert got.device.type == "cuda"
        _assert_equal(got, gaussian_blur_u8_plain(x, k, sigma))
    assert LAUNCHES["gauss_blur"] == len(planes)


@pytest.mark.parametrize("family", ["edges", "widths", "workload"])
@pytest.mark.parametrize("block", [3, 9, 51, 119, 201])
def test_adaptive_kernel_matches_plain(cuda, block, family):
    """Kernel N in both modes (the mean; the BINARY_INV compare fused at C
    -1 and 10) against the plain versions on the card at every edge shape,
    every width of ``_HEAD_WIDTHS``, an unaligned view and the workload's
    planes: one launch a call, exact."""
    planes = _head_planes(cuda, block, family, blurred=True)
    reset_launches()
    for x in planes:
        _assert_equal(adaptive_gaussian_mean(x, block), adaptive_gaussian_mean_plain(x, block))
        for c in (-1, 10):
            _assert_equal(adaptive_threshold_inv(x, block, c),
                          adaptive_threshold_inv_plain(x, block, c))
    assert LAUNCHES["adaptive"] == 3 * len(planes)


def test_head_kernels_refuse_what_they_do_not_take(cuda):
    """Kernels M, N and O take contiguous [U, H, W] uint8 planes, M an odd
    k of 3-31 and N an odd block: anything else raises, with no fallback to
    the plain version."""
    x = torch.zeros((2, 8, 9), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gaussian_blur_u8(x.transpose(1, 2), 3)
    with pytest.raises(ValueError, match="odd k of 3-31"):
        gaussian_blur_u8(x, 4)
    with pytest.raises(ValueError, match="uint8"):
        adaptive_gaussian_mean(x.to(torch.int32), 3)
    with pytest.raises(ValueError, match="odd"):
        adaptive_threshold_inv(x, 4, 0)
    with pytest.raises(ValueError, match="contiguous"):
        canny_planes(x.transpose(1, 2), 12, 24)
    with pytest.raises(ValueError, match="uint8"):
        canny_u8(x.to(torch.int32), 12, 24)


# kernel O's edge shapes: H = 1 and 2 at widths 1 and 31-33, Hx1, and
# planes whose edges lie exactly on its 32x64 tiles' edges (or one past)
_CANNY_SHAPES = tuple((2, hh, ww) for hh in (1, 2) for ww in (1, 31, 32, 33)) + (
    (3, 40, 1), (1, 1, 1), (1, 32, 64), (1, 64, 128), (2, 33, 65), (1, 31, 63), (1, 96, 129))


@pytest.mark.parametrize("low,high", [(1, 2), (12, 24), (127, 255), (255, 127)])
def test_canny_head_kernel_matches_plain(cuda, low, high):
    """Kernel O (Sobel, the L1 magnitude, NMS and both thresholds in one
    launch) against its plain version on the card: the standard workload's
    48 crops, the whole 3000x4096 capture, every edge shape (random planes
    of the card's generator with a checkerboard unit), the sector and tie
    planes of ``synthetic.canny_edge_planes`` at two sizes; one launch a
    call, exact. ``canny_u8`` on the crops launches O and D once each, and
    its first 3 units equal ``device="cpu"``'s."""
    gen = torch.Generator(device=cuda).manual_seed(low + high)
    planes = [torch.randint(0, 256, s, generator=gen, device=cuda, dtype=torch.uint8)
              for s in _CANNY_SHAPES]
    for pl in planes:
        pl[-1] = ((torch.arange(pl.shape[1], device=cuda)[:, None]
                   + torch.arange(pl.shape[2], device=cuda)[None, :]) % 2) * 255
    crops, whole = (t.to(cuda) for t in _workload_planes())
    planes += [crops, whole] + [torch.from_numpy(canny_edge_planes(hh, ww, seed=hh)).to(cuda)
                                for hh, ww in ((37, 45), (64, 128))]
    reset_launches()
    for x in planes:
        got = canny_planes(x, low, high)
        assert got[0].device.type == "cuda"
        _assert_equal(got, canny_planes_plain(x, low, high))
        assert not (got[0] & ~got[1]).any()
    assert LAUNCHES["canny_head"] == len(planes)
    reset_launches()
    edges = canny_u8(crops, low, high)
    torch.cuda.synchronize()
    assert LAUNCHES["canny_head"] == 1 and LAUNCHES["propagate"] == 1
    _assert_equal(edges[:3], canny_u8(crops[:3].cpu().contiguous(), low, high).to(cuda))


# kernel O's widths: around a word (1-5), a warp's 32 columns, its 64-column
# tile and two (63-65, 127-129), and the workload's 316, at H 1, 2, 3 and
# 40 (its tiles are 64 rows)
_CANNY_WIDTHS = tuple((2, hh, ww) for hh in (1, 2, 3, 40)
                      for ww in (1, 2, 3, 4, 5, 31, 32, 33, 63, 64, 65, 127, 128, 129, 316))


@pytest.mark.parametrize("low,high", [(-1, 0), (0, 2040), (2040, 2040), (12, 24)])
def test_canny_head_kernel_widths_match_plain(cuda, low, high):
    """Kernel O against its plain version at every width of
    ``_CANNY_WIDTHS`` (random planes with a checkerboard unit), on views
    ``x.reshape(-1)[k:]`` (k = 1, 2, 3: no row starts on a 4-byte boundary,
    the funnel-shift staging and the byte stores), and on the sector and
    tie planes of ``synthetic.canny_edge_planes``, at thresholds that keep
    every NMS survivor, none above high, and none at all: one launch a
    call, exact."""
    gen = torch.Generator(device=cuda).manual_seed(low + 2 * high + 7)
    planes = [torch.randint(0, 256, s, generator=gen, device=cuda, dtype=torch.uint8)
              for s in _CANNY_WIDTHS]
    for pl in planes:
        pl[-1] = ((torch.arange(pl.shape[1], device=cuda)[:, None]
                   + torch.arange(pl.shape[2], device=cuda)[None, :]) % 2) * 255
    flat = torch.randint(0, 256, (3 * 37 * 45 + 3,), generator=gen, device=cuda,
                         dtype=torch.uint8)
    for k in (1, 2, 3):
        planes.append(flat[k : k + 3 * 37 * 45].reshape(3, 37, 45))
        assert planes[-1].is_contiguous() and planes[-1].data_ptr() % 4 == k
    planes += [torch.from_numpy(canny_edge_planes(hh, ww, seed=hh + ww)).to(cuda)
               for hh, ww in ((37, 45), (64, 128), (70, 131))]
    reset_launches()
    for x in planes:
        got = canny_planes(x, low, high)
        _assert_equal(got, canny_planes_plain(x, low, high))
    assert LAUNCHES["canny_head"] == len(planes)


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


@pytest.mark.parametrize("shape", [(4, 37, 53), (2, 64, 41)])
def test_component_stats_matches_plain(cuda, shape):
    rng = np.random.RandomState(11)
    fg = _planes(rng, shape, 0.55, cuda) > 0
    fg[0] = False  # empty unit
    fg[1] = True  # full unit
    if shape[0] > 2:
        fg[2] = False
        fg[2, 2, 28] = fg[2, 3, 0] = True  # an equal-area tie in block order
    labels = label_components(fg)
    reset_launches()
    got = component_stats(labels, fg)
    assert LAUNCHES["cc_stats"] == 1
    _assert_equal(got, component_stats_plain(labels, fg))
    assert got[1].dtype == torch.int64


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 64, 41)])
def test_blob_select_matches_plain(cuda, shape):
    rng = np.random.RandomState(12)
    fg = _planes(rng, shape, 0.6, cuda) > 0
    fg[0] = False
    fg[-1, 4:24, 4:24] = True  # a ring holding a nested blob
    fg[-1, 7:21, 7:21] = False
    fg[-1, 11:16, 11:16] = True
    fill_labels, top, ext = fill_regions(fg)
    max_x2 = torch.tensor([50, 4000, 722][: shape[0]], dtype=torch.int32, device=cuda)
    for min_x2 in (0, 6, 32):
        reset_launches()
        got = blob_select(fill_labels, top, ext, max_x2, min_x2=min_x2)
        assert LAUNCHES["blob_select"] == 1
        _assert_equal(got, blob_select_plain(fill_labels, top, ext, max_x2, min_x2=min_x2))


def test_whole_plane_kernels_match_plain(cuda):
    """Kernels B, D, E, F and G on one whole 1x3000x4096 capture."""
    image = torch.from_numpy(standard_workload()["image"][None]).to(cuda)
    fg = (image < 140).contiguous()  # the 48 mold surfaces
    lo = torch.tensor([200], dtype=torch.int32, device=cuda)
    hi = torch.tensor([2800], dtype=torch.int32, device=cuda)
    _assert_equal(median_residual_mask(image, 21, 24, lo, hi),
                  median_residual_mask_plain(image, 21, 24, lo, hi))
    free = (~fg).contiguous()
    _assert_equal(propagate(None, free, False, border_seed=True),
                  propagate_plain(None, free, False, border_seed=True))
    seeds = torch.zeros_like(fg)
    seeds[0, 1500, ::64] = True
    _assert_equal(propagate(seeds, fg, True), propagate_plain(seeds, fg, True))
    for plane in (fg, free):  # the background is one huge component
        labels = label_components(plane)
        _assert_equal(labels, label_components_plain(plane))
        mask, stats = component_stats(labels, plane)
        _assert_equal((mask, stats), component_stats_plain(labels, plane))
    assert stats[0, 1] > 2**31
    fill_labels, top, ext = fill_regions(fg)
    max_x2 = torch.tensor([2 * 60_000], dtype=torch.int32, device=cuda)
    out, area = blob_select(fill_labels, top, ext, max_x2, min_x2=40)
    _assert_equal((out, area), blob_select_plain(fill_labels, top, ext, max_x2, min_x2=40))
    assert int(area[0]) > 0


@pytest.mark.parametrize("method", ["otsu/threshold", "adaptive/canny"])
def test_whole_route_cuda_matches_cpu(cuda, method, monkeypatch):
    monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
    grid = tcfg.GridParams(base_unit=(6, 5, 128, 96))
    img = make_mold_image(grid, (108, 142), seed=3, defect_rate=1.0)
    seg_m, def_m = method.split("/")
    seg = tcfg.SegmentationParams(method=seg_m)
    dp = tcfg.DefectParams(method=def_m, min_area=3)
    excl = [{"shape": "circle", "cx": 40, "cy": 30, "r": 9}]
    reset_launches()
    g_seg, g_insp = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device=cuda)
    assert LAUNCHES["cc_stats"] == 2 and LAUNCHES["blob_select"] == 1
    assert LAUNCHES["seg_tail"] == 0 and LAUNCHES["blob_filter"] == 0
    c_seg, c_insp = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device="cpu")
    for f in ("masks", "centroids", "centroid_valid", "shifts"):
        a, b = getattr(g_seg, f), getattr(c_seg, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("defect_masks", "valid", "areas", "verdicts"):
        a, b = getattr(g_insp, f), getattr(c_insp, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("k", [3, 47, 49, 101, 301])
def test_median_blur_matches_plain(cuda, k):
    """Kernel H: 16-bit bins up to k = 255 (k = 3 to 101 here), 32-bit bins
    above (k = 301), and windows larger than the unit."""
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randint(0, 256, (3, 37, 53), dtype=np.uint8)).to(cuda)
    x[1] = 7  # a flat unit
    reset_launches()
    got = median_blur_u8(x, k)
    assert LAUNCHES["median_blur"] == 1
    _assert_equal(got, median_blur_u8_plain(x, k))
    assert median_blur_u8(x, 1) is x


@pytest.mark.parametrize("stages_name", ["close_open3", "close_open31", "open3", "erode6",
                                         "erode200"])
def test_morph_chain_matches_plain(cuda, stages_name):
    rng = np.random.RandomState(14)
    x = _planes(rng, (3, 70, 45), 0.5, cuda)
    x[0] = 0
    x[1, :, -1] = 255  # fg on the right and bottom edges
    x[1, -1, :] = 255
    if stages_name.startswith("close_open"):
        stages = close_open_stages(int(stages_name[len("close_open"):]))
    elif stages_name == "open3":
        stages = open_stages(3)
    else:
        stages = rect_erode_stages(int(stages_name[len("erode"):]))
    reset_launches()
    got = morph_chain(x, stages)
    assert LAUNCHES["morph"] == 1  # one launch per chain
    _assert_equal(got, morph_chain_plain(x, stages))
    _assert_equal(got, apply_stages(x, stages) > 0)


@pytest.mark.parametrize("shape", [(4, 37, 53), (1, 315, 316), (3, 401, 421)])
def test_largest_component_sums_matches_plain(cuda, shape):
    """Kernel J: one unit and batches of units, each unit on a cluster of
    CTAs holding bands of its block rows in shared memory."""
    rng = np.random.RandomState(15)
    fg = _planes(rng, shape, 0.55, cuda) > 0
    if shape[0] > 1:
        fg[0] = False  # empty unit
        fg[1] = True  # full unit
        fg[2] = False
        fg[2, 2, 28] = fg[2, 3, 0] = True  # an equal-area tie in block order
    reset_launches()
    got = largest_component_sums(fg)
    assert LAUNCHES["label_stats"] == 1
    _assert_equal(got, largest_component(fg))
    _assert_equal(got, component_stats(label_components(fg), fg))
    if shape[0] > 1:
        assert got[0][2, 3, 0] and not got[0][2, 2, 28]


@pytest.mark.parametrize("erode", [0, 6, 12])
def test_seg_roi_tail_matches_plain(cuda, erode):
    """Kernel K against its plain version, with and without the zone; an
    empty and a full unit, an odd unit count, erode_px beyond the TPU
    kernel's pairing gap."""
    rng = np.random.RandomState(16)
    shape = (3, 37, 53)
    gray = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(cuda)
    gray[0] = 255  # nothing <= thr: an empty unit
    gray[1] = 0  # everything <= thr: a full unit
    thr = torch.from_numpy(rng.randint(60, 200, shape[0]).astype(np.int32)).to(cuda)
    zone = torch.from_numpy((rng.rand(37, 53) > 0.8).astype(np.uint8)).to(cuda)
    stages, roi_stages = close_open_stages(3), rect_erode_stages(erode)
    for z in (None, zone, zone > 0):
        reset_launches()
        got = seg_roi_tail(gray, stages, roi_stages, thr, z)
        assert LAUNCHES["seg_roi_tail"] == 1
        _assert_equal(got, seg_roi_tail_plain(gray, stages, roi_stages, thr, z))


def test_inspect_image_chained_cuda_matches_cpu(cuda, monkeypatch):
    """The chained path (kernel K in place of kernel A's two launches) on
    the card equals the split path and the CPU run."""
    grid = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
    img = make_mold_image(grid, (110, 120), seed=3, defect_rate=1.0)
    excl = [{"shape": "rect", "x": 5, "y": 6, "w": 10, "h": 8}]
    seg, dp = tcfg.SegmentationParams(), tcfg.DefectParams(min_area=3)
    split = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device=cuda)
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", True)
    reset_launches()
    chained = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device=cuda)
    assert LAUNCHES["seg_roi_tail"] == 1 and LAUNCHES["seg_tail"] == 0
    cpu = teng.inspect_image(img, grid, seg, dp, exclusions=excl, device="cpu")
    for ref in (split, cpu):
        for got_r, ref_r in zip(chained, ref):
            for f in vars(got_r):
                a, b = getattr(got_r, f), getattr(ref_r, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("prefetch", [1, 2])
def test_stream_cuda_matches_cpu(cuda, prefetch):
    """Pinned, reused upload buffers: every frame equals the CPU stream."""
    grid = tcfg.GridParams(base_unit=(4, 6, 48, 44), units_x=2, units_y=2)
    frames = [make_mold_image(grid, (110, 120), seed=s, defect_rate=1.0) for s in range(5)]
    kw = dict(defect=tcfg.DefectParams(min_area=3), fetch_masks=True, prefetch=prefetch)
    got = list(stream_inspect(frames, grid, device=cuda, **kw))
    ref = list(stream_inspect(frames, grid, device="cpu", **kw))
    assert [r.index for r in got] == list(range(5))
    for a, b in zip(got, ref):
        for f in ("verdicts", "areas", "valid", "seg_masks", "defect_masks"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("strip", STRIPS)
def test_median_probe_baseline_matches_plain(cuda, strip):
    """Kernel L's baseline equals kernel B at the same strip and B's plain
    version: k = 3, 21 and 45, word-edge widths and H = 1, a unit whose ROI
    is empty and one that covers every row. The ablations launch and return
    (they are timed, never compared)."""
    rng = np.random.RandomState(17)
    for shape in [(3, 37, 53), (3, 40, 1), (3, 40, 31), (3, 40, 32), (3, 40, 33), (3, 1, 40)]:
        u, h, w = shape
        x = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).to(cuda)
        lo = torch.tensor([0, min(4, h - 1), h], dtype=torch.int32, device=cuda)
        hi = torch.tensor([h, h - 1 if h > 1 else h, 0], dtype=torch.int32, device=cuda)
        for k, thr in [(3, 0), (21, 24), (45, 255)]:
            got = probe(x, k, thr, lo, hi, "baseline", strip)
            _assert_equal(got, _median_residual(x, k, thr, lo, hi, strip=strip))
            _assert_equal(got, median_residual_mask_plain(x, k, thr, lo, hi))
        reset_launches()
        for mode in MODES[1:]:
            assert probe(x, 21, 24, lo, hi, mode, strip).shape == x.shape
        torch.cuda.synchronize()
        assert LAUNCHES["median_probe"] == len(MODES) - 1


def _staircase(h, w):
    """A 1-px 8-connected diagonal staircase: every step is a corner-only
    link, one component as deep as the plane is wide."""
    m = np.zeros((h, w), np.uint8)
    for i in range(min(h, w)):
        m[i, i] = 255
    return m


def _spiral(n):
    """A 1-px square spiral wall with a 1-px corridor between its turns:
    one winding fg component, and a background corridor from the border
    (at row 1, column 0) to the centre that the border flood must follow
    turn by turn."""
    m = np.zeros((n, n), np.uint8)
    lens = [n - 1, n - 1, n - 1]
    step = n - 3
    while step > 0:
        lens += [step, step]
        step -= 2
    y = x = 0
    m[0, 0] = 255
    for i, length in enumerate(lens):
        dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[i % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            m[y, x] = 255
    return m


def _tails_equal(planes, cuda, stages_list=((),), roi_stages=(rect_erode_stages(1),)):
    """Kernels A, K and C on uint8 0/255 planes against their plain
    versions: A with and without the fill and out_largest, K on the planes
    as gray (x <= 127 is the plane), C plain and with the pre-open."""
    x = planes.to(cuda)
    for stages in stages_list:
        for fill, ol in ((False, True), (True, False), (True, True)):
            _assert_equal(seg_tail(x, stages, fill, ol), seg_tail_plain(x, stages, fill, ol))
    gray = 255 - x
    thr = torch.full((x.shape[0],), 127, dtype=torch.int32, device=cuda)
    for rs in roi_stages:
        _assert_equal(seg_roi_tail(gray, stages_list[0], rs, thr),
                      seg_roi_tail_plain(gray, stages_list[0], rs, thr))
    max_x2 = torch.full((x.shape[0],), 2 * x.shape[1] * x.shape[2], dtype=torch.int32,
                        device=cuda)
    for kw in (dict(min_x2=0), dict(min_x2=8, pre_open=True), dict(min_x2=0, roi=x)):
        _assert_equal(blob_filter(x, max_x2, **kw), blob_filter_plain(x, max_x2, **kw))


@pytest.mark.parametrize("case", ["staircase", "spiral", "spiral inverted", "serpentine"])
def test_tails_deep_planes_match_plain(cuda, case):
    """The redesigned A, K and C on planes whose labeling and flood are
    deepest: a 1-px diagonal staircase, a spiral (fg and background) and a
    long 1-px serpentine."""
    if case == "staircase":
        p = np.stack([_staircase(315, 316), _staircase(315, 316)[::-1].copy()])
    elif case == "spiral":
        p = _spiral(315)[None]
    elif case == "spiral inverted":
        p = 255 - _spiral(315)[None]
    else:
        p = (serpentine_plane(125, 316) * 255).astype(np.uint8)[None]
    _tails_equal(torch.from_numpy(np.ascontiguousarray(p)), cuda)


@pytest.mark.parametrize("w", [1, 31, 32, 33, 316])
def test_tails_word_edges_match_plain(cuda, w):
    """Widths at and around the 32-pixel word (and one), an odd height, an
    empty and a full unit: the last word's bits past W must stay out of
    every plane; stage programs of one pass and of doubling passes."""
    rng = np.random.RandomState(w)
    p = ((rng.rand(4, 37, w) > 0.45) * 255).astype(np.uint8)
    p[0] = 0
    p[1] = 255
    _tails_equal(
        torch.from_numpy(p), cuda,
        stages_list=((), close_open_stages(3), rect_erode_stages(2), rect_erode_stages(40),
                     close_open_stages(31)),
        roi_stages=(rect_erode_stages(0), rect_erode_stages(6), rect_erode_stages(40)),
    )


def _workload_tails(cuda, n_units=8):
    """The standard workload's first units on the card: (blurred gray, Otsu
    thresholds, seg masks from kernel A) as the main path makes them."""
    wl = standard_workload()
    crops = gather_crops(
        torch.from_numpy(wl["image"]).to(cuda), torch.from_numpy(wl["origins"]).to(cuda),
        wl["unit_hw"],
    )[:n_units].contiguous()
    x = gaussian_blur_u8(crops, 3).contiguous()
    thr = otsu_threshold(x)
    seg, _ = seg_tail(x, close_open_stages(3), fill=True, thr=thr)
    return crops, x, thr, seg


@pytest.mark.parametrize("erode", [0, 6, 12, 200])
def test_roi_erode_on_workload_matches_plain(cuda, erode):
    """The ROI tail (kernel A, out_largest) and the chained kernel K at
    erode_px 0, 6 (the default), 12 and 200 (the doubling passes) on the
    standard workload's seg masks."""
    _, x, thr, seg = _workload_tails(cuda)
    _assert_equal(seg, seg_tail_plain(x, close_open_stages(3), fill=True, thr=thr)[0])
    rs = rect_erode_stages(erode)
    _assert_equal(seg_tail(seg, rs, out_largest=True), seg_tail_plain(seg, rs, out_largest=True))
    _assert_equal(seg_roi_tail(x, close_open_stages(3), rs, thr),
                  seg_roi_tail_plain(x, close_open_stages(3), rs, thr))


def test_blob_filter_canny_form_matches_plain(cuda):
    """Kernel C's Canny form (no pre-open) on real Canny edges of the
    standard workload inside its ROI, and the residual form beside it."""
    crops, _, _, seg = _workload_tails(cuda)
    roi, st = seg_tail(seg, rect_erode_stages(6), out_largest=True)
    max_x2 = (2 * torch.floor(st[:, 0].double() * 0.98)).to(torch.int32).contiguous()
    edges = canny_u8(crops, 15, 30)
    assert int((edges > 0).sum()) > 1000
    kw = dict(min_x2=40, roi=roi)
    _assert_equal(blob_filter(edges, max_x2, **kw), blob_filter_plain(edges, max_x2, **kw))
    cand = median_residual_mask(crops, 21, 30)
    kw = dict(min_x2=40, roi=roi, pre_open=True)
    _assert_equal(blob_filter(cand, max_x2, **kw), blob_filter_plain(cand, max_x2, **kw))


def test_tails_global_variant_match_plain(cuda):
    """Units too large for the kernels' shared-memory layout run the same
    code on a global scratch (2 x 401 x 421: 227 KB holds neither layout)."""
    rng = np.random.RandomState(21)
    p = ((rng.rand(2, 401, 421) > 0.45) * 255).astype(np.uint8)
    p[1, 100:300, 50:350] = 0
    p[1, 150:250, 100:300] = 255
    _tails_equal(torch.from_numpy(p), cuda, stages_list=((), close_open_stages(3)),
                 roi_stages=(rect_erode_stages(6),))


def test_inspect_image_device_waits_nowhere(cuda):
    """After one warm-up call, one capture's default program (reference
    capture, otsu/threshold, exclusions) dispatches under
    torch.cuda.set_sync_debug_mode("error"): no call in it waits for the
    card (the bound flag is read after, where results are copied out). The
    same for the whole-image route: the seg pass then the defect pass of
    one resident 1x3000x4096 unit (kernels D, E, F and G on one flag)."""
    wl = standard_workload()
    image = torch.from_numpy(wl["image"]).to(cuda)
    origins = torch.from_numpy(wl["origins"]).to(cuda)
    seg, dp = tcfg.SegmentationParams().validated(), tcfg.DefectParams().validated()

    def run(err):
        return teng._inspect_image_device(image, origins, wl["unit_hw"], seg, dp,
                                          wl["exclusions"], None, True, True, err)

    def run_whole(err):
        whole = image[None]
        m = teng._segment(whole, seg, wl["exclusions"], None, True, err)[0]
        return teng._defect(whole, m, dp, err)

    for program in (run, run_whole):
        program(error_flag(cuda))
        torch.cuda.synchronize()
        err = error_flag(cuda)
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = program(err)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        build.check_bounded("inspect_image", err)
        if program is run:
            assert int(out[4][3].sum()) == 8, "NG 8/48 on the reference capture"
        else:
            assert LAUNCHES["label"] == 3 and LAUNCHES["propagate"] == 3
            assert LAUNCHES["morph"] == 3 and LAUNCHES["cc_stats"] == 2
            ref = teng.inspect_units(wl["image"][None], seg, dp, wl["exclusions"], device=cuda)[1]
            assert int(out[2][0]) == int(ref.areas[0])
            assert np.array_equal(out[0].cpu().numpy(), ref.defect_masks)


# kernel I's chains: every head, the config's reaches, word-edge widths
_MASK_CHAINS = {
    "close/open 2": close_open_stages(2), "close/open 3": close_open_stages(3),
    "close/open 4": close_open_stages(4), "close/open 31": close_open_stages(31),
    "open 3": open_stages(3), "erode 0": rect_erode_stages(0), "erode 1": rect_erode_stages(1),
    "erode 6": rect_erode_stages(6), "erode 200": rect_erode_stages(200),
}


@pytest.mark.parametrize("h,w", [(1, 45), (37, 1), (37, 31), (37, 32), (37, 33), (37, 48),
                                 (29, 53), (37, 63), (37, 64), (37, 65), (40, 4096)])
def test_mask_chain_heads_match_plain(cuda, h, w):
    """Kernel I, one launch a chain, against its plain version: random
    gray planes under the seg tail's threshold head (thr -1, 0, 127, 300
    per unit), bool and 0/255 masks, the candidates' ROI AND, at widths
    around a word's edge (48: a half word after 16-byte rows), H = 1 and
    4096, with every chain above (erode 200
    on a 29x53 plane reaches past the plane); units never mix."""
    rng = np.random.RandomState(h * 1000 + w)
    gray = torch.from_numpy(rng.randint(0, 256, (4, h, w), dtype=np.uint8)).to(cuda)
    thr = torch.tensor([-1, 0, 127, 300], dtype=torch.int32, device=cuda)
    mask = gray > 90
    mask[1] = False  # an empty unit
    mask[2] = True  # a full unit
    roi = _planes(rng, (4, h, w), 0.2, cuda)
    heads = [dict(x=gray, thr=thr), dict(x=mask), dict(x=mask.to(torch.uint8) * 255),
             dict(x=mask, roi=roi), dict(x=gray, thr=thr, roi=roi > 0)]
    for name, stages in _MASK_CHAINS.items():
        for kw in heads:
            reset_launches()
            got = morph_chain(stages=stages, **kw)
            assert LAUNCHES["morph"] == 1, name
            want = morph_chain_plain(stages=stages, **kw)
            torch.cuda.synchronize()
            assert got.dtype == torch.bool and torch.equal(got, want), (name, sorted(kw))


def test_mask_chain_reach_beyond_the_config_raises(cuda):
    x = torch.zeros((1, 3000, 4096), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="no tile"):
        morph_chain(x, rect_erode_stages(300))
    morph_chain(x, rect_erode_stages(200))  # the config's largest


def _stair_tie(h=10, w=24):
    """Two 15-pixel components in one 2x2-block row: the one whose label
    (raster-first pixel, (2, 20)) comes later holds the smaller block rank,
    through its pixel (3, 8) in the row below its label's."""
    fg = np.zeros((h, w), bool)
    for y, x in [(3, 8), (4, 9), (4, 19), (3, 19), (3, 20), (2, 20)]:
        fg[y, x] = True
    fg[5, 10:19] = True
    fg[2, 10:18] = True
    fg[3, 11:18] = True
    return fg


@pytest.mark.parametrize("case", ["ties", "isolated grid", "one component", "batch", "wide"])
def test_cc_stats_cases_match_plain(cuda, case):
    """Kernel F against its plain version: equal-area ties that only the
    block rank resolves (the (2, 28) / (3, 0) pair and a rank held by the
    row below the label), a plane of isolated pixels on a 2-pixel grid (the
    most components a plane holds), one component covering the plane, an
    empty unit in a batch of 5, and a plane wider than a CTA's segment."""
    rng = np.random.RandomState(17)
    if case == "ties":
        fg = np.zeros((2, 10, 40), bool)
        fg[0, :, :24] = _stair_tie()
        fg[1, 2, 28] = fg[1, 3, 0] = True
    elif case == "isolated grid":
        fg = np.zeros((2, 301, 518), bool)
        fg[:, ::2, ::2] = True
        fg[1, 300, 516] = False  # the last block's pixel: the tie goes elsewhere
    elif case == "one component":
        fg = np.ones((1, 257, 1031), bool)
    elif case == "batch":
        fg = rng.rand(5, 61, 76) > 0.5
        fg[3] = False
    else:
        fg = np.zeros((1, 33, 2500), bool)
        fg[0, 3:20, 5:2495] = True
        fg[0, 25, :] = True
        fg[0, 22:31, 100:200] = rng.rand(9, 100) > 0.3
    fg_t = torch.from_numpy(fg).to(cuda)
    labels = label_components(fg_t)
    reset_launches()
    got = component_stats(labels, fg_t)
    assert LAUNCHES["cc_stats"] == 1
    _assert_equal(got, component_stats_plain(labels, fg_t))
    if case == "ties":
        assert got[0][0, 3, 8] and not got[0][0, 2, 10]
        assert got[0][1, 3, 0] and not got[0][1, 2, 28]


def test_cc_stats_label_outside_the_plane_sets_the_flag(cuda):
    fg = torch.ones((2, 9, 12), dtype=torch.bool, device=cuda)
    labels = label_components(fg)
    labels[1, 4, 5] = 9 * 12  # one past the plane
    err = error_flag(cuda)
    component_stats(labels, fg, err=err)
    assert int(err.item()) == 3
    with pytest.raises(RuntimeError, match="flag 3"):
        component_stats(labels, fg)


# the six public names that call ported kernels, and the kernels each
# launches on the card (component_areas is a torch scatter)
_PUBLIC = {
    "filter_and_select": ("blob_filter",),
    "filter_and_select whole": ("propagate", "label", "blob_select"),
    "select_blobs": ("propagate",),
    "otsu_binary_inv": ("otsu",),
    "morph_close": ("morph",),
    "component_areas": (),
    "largest_component_sums_tiled": ("cc_stats",),
}


@pytest.mark.parametrize("name", list(_PUBLIC))
def test_public_name_matches_cpu(cuda, name, monkeypatch):
    """``contour.filter_and_select`` (kernel C, and with ``blob_filter_fits``
    false kernels D, E, D and G), ``contour.select_blobs``,
    ``threshold.otsu_binary_inv``, ``morphology.morph_close``,
    ``cc.component_areas`` and ``cc.largest_component_sums_tiled`` on the
    card against ``device="cpu"``, exact, dtypes included: random blobs, an
    empty and a full unit; each launches its kernels."""
    from tpu_inspect_torch.ops import blob, cc, contour, morphology, threshold
    from tpu_inspect_torch.synthetic import random_blob_mask

    if name == "filter_and_select whole":
        monkeypatch.setattr(blob, "blob_filter_fits", lambda h, w: False)
    fg = np.stack([random_blob_mask(61, 67, seed=s, n_blobs=6) > 0 for s in range(3)]
                  + [np.zeros((61, 67), bool), np.ones((61, 67), bool)])
    x = np.random.RandomState(31).randint(0, 256, fg.shape, dtype=np.uint8)
    x[3], x[4] = 0, 255
    max_x2 = np.array([60, 400, 2000, 100, 10_000], np.int32)

    def run(dev):
        f, xx = torch.from_numpy(fg).to(dev), torch.from_numpy(x).to(dev)
        if name.startswith("filter_and_select"):
            return contour.filter_and_select(f, 8, torch.from_numpy(max_x2).to(dev))
        if name == "select_blobs":
            ana = contour.analyze_blobs(f)
            return contour.select_blobs(ana, (ana.contour_area_x2 >= 8)
                                        & (ana.contour_area_x2 <= 400))
        if name == "otsu_binary_inv":
            return threshold.otsu_binary_inv(xx)
        if name == "morph_close":
            return morphology.morph_close(f.to(torch.uint8) * 255, morphology.ellipse_se(5))
        if name == "component_areas":
            return cc.component_areas(cc.label_components(f), f)
        return cc.largest_component_sums_tiled(f, cc.label_components(f))

    reset_launches()
    got = run(cuda)
    launches = dict(LAUNCHES)
    ref = run("cpu")
    got, ref = (t if isinstance(t, tuple) else (t,) for t in (got, ref))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.dtype == r.dtype and torch.equal(g.cpu(), r)
    assert all(launches[k] >= 1 for k in _PUBLIC[name]), launches
