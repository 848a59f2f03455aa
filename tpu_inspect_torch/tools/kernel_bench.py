"""Time one form of kernel B, C, D, E, F, G, H, I, J, M, N, O or the Otsu
kernel at a time, checked exact against its plain version: the rig to
iterate on a kernel without a whole chip_smoke run.

The port of ``tools/kernel_bench.py`` (which times the JAX package's Pallas
kernels one by one). Its planes are ``chip_smoke.py``'s: the standard
workload's 48 units of 315x316 and the same image as one 1x3000x4096
unit, made by the port's own engine on the card. Each form is run once
and held against its plain version (exact: both give integers), then timed
with CUDA events (``n`` calls in a row, median of ``reps``) beside the
plain version and its byte bound (each input read once, kernel B's only
on its ROI rows and their halo; the output written once, at 3.35 TB/s),
and, where one PyTorch call computes the same function (the Otsu
histogram's ``torch.bincount``), that call's time as ``library_ms``.

Usage::

    python -m tpu_inspect_torch.tools.kernel_bench [FORM ...] [--n N] [--reps R]
        [--device cpu] [--small] [--strips S,S,...]

With no FORM, every form runs (``--list`` names them). It runs on the card
unless ``--device cpu`` is given; on the CPU the wrappers run their plain
versions and the times are host walls of those, not device times.
``--small`` builds the planes from a 2x2 grid of 64x64 units and a 96x128
capture instead (what the CPU test drives). ``--strips`` runs each form of
B and H once for each strip length given (rows a thread walks; the
default is ``tpu_inspect_torch.ops.median.strip_rows``).

To time an older tree's kernels on the same forms, run this file from the
older tree's root with ``PYTHONPATH=.``: kernel I's forms then drive that
tree's byte-plane chain (one launch a stage) with the head and the ``> 0``
as torch ops, as its callers ran them, J's wrapper without a flag
argument reads its own flag each call, and M's, N's and O's forms time a
tree without them on its torch-op blur, adaptive threshold and Canny
planes.

The ``launch floor`` form is a one-thread kernel storing one byte: the
time no one-unit launch (kernel J's preview unit) can beat.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


def _roi_rows_bytes(x, k: int, lo, hi) -> int:
    """Bytes of ``x`` [U, H, W] uint8 a median residual over rows [lo, hi)
    of each unit must read: those rows and k // 2 more on each side."""
    _, h, w = x.shape
    r = k // 2
    lo, hi = lo.cpu().long(), hi.cpu().long()
    rows = ((hi + r).clamp(max=h) - (lo - r).clamp(min=0)).clamp(min=0)
    return int(torch.where(hi > lo, rows, 0).sum()) * w


def _max_x2(roi_st, dp) -> torch.Tensor:
    """Kernels C's and G's [U] int32 area cap: twice the ROI's
    ``max(min_area, floor(area * max_area_frac))`` (engine._defect_tail)."""
    return (2 * torch.clamp(torch.floor(roi_st[:, 0].to(torch.float64) * dp.max_area_frac),
                            min=dp.min_area).to(torch.int32)).contiguous()


def planes(dev: torch.device, small: bool = False) -> dict:
    """The named inputs of every kernel's forms on ``dev``, made as
    the main paths make them (otsu/threshold, the standard workload's
    exclusions; Canny at the default threshold). An int entry is a byte
    count standing in for the bytes a form reads of a plane."""
    from tpu_inspect_torch import engine
    from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
    from tpu_inspect_torch.geometry import grid_origins
    from tpu_inspect_torch.imageio import gather_crops
    from tpu_inspect_torch.ops.blob import candidate_mask
    from tpu_inspect_torch.ops.canny import canny_planes, canny_u8
    from tpu_inspect_torch.ops.contour import fill_regions
    from tpu_inspect_torch.ops.fused import tail_mask
    from tpu_inspect_torch.ops.gaussian import gaussian_blur_u8
    from tpu_inspect_torch.ops.hole_fill import exterior_background
    from tpu_inspect_torch.ops.cc import label_components, largest_component
    from tpu_inspect_torch.ops.median import median_residual_mask
    from tpu_inspect_torch.ops.morphology import close_open_stages, rect_erode_stages
    from tpu_inspect_torch.ops.threshold import histogram_u8_plain, otsu_threshold
    from tpu_inspect_torch.synthetic import make_mold_image, standard_workload

    seg = SegmentationParams().validated()
    dp = DefectParams().validated()
    if small:
        grid = GridParams(base_unit=(3, 4, 64, 64), units_x=2, units_y=2)
        image_np = make_mold_image(grid, (96, 128), seed=0, defect_rate=0.3)
        excl, (h, w) = [], (64, 64)
        origins_np = grid_origins(grid)
    else:
        wl = standard_workload()
        image_np, excl, (h, w), origins_np = wl["image"], wl["exclusions"], wl["unit_hw"], \
            wl["origins"]
    image = torch.from_numpy(image_np).to(dev)
    crops = gather_crops(image, torch.from_numpy(origins_np).to(dev), (h, w))
    seg_masks = engine._segment(crops, seg, excl, None, True)[0]
    roi, roi_st = engine._defect_roi(seg_masks, dp.erode_px)
    lo, hi = max(1, dp.threshold // 2), max(2, dp.threshold)
    strong, cand_c = canny_planes(crops, lo, hi)
    # kernel C's inputs, as engine._defect_tail gives them: the threshold
    # form's median residual over the ROI rows, the Canny form's edges, the
    # ROI and its max area
    cand_t = engine._candidates(crops, dp, roi_st)
    edges = canny_u8(crops, lo, hi)
    max_x2 = _max_x2(roi_st, dp)
    u0 = int(torch.nonzero(roi_st[:, 3] > 0)[0, 0])
    fg1 = (cand_c & (roi > 0))[u0 : u0 + 1].contiguous()
    fill1 = exterior_background(fg1).logical_not().contiguous()

    whole = image[None].contiguous()
    seg_w = engine._segment(whole, seg, excl, None, True)[0]
    x_w = gaussian_blur_u8(whole, seg.gaussian_blur)
    x = gaussian_blur_u8(crops, seg.gaussian_blur)
    thr_w = otsu_threshold(x_w)
    seg_pre_w = tail_mask(x_w, close_open_stages(seg.morph_kernel), thr_w)
    seg_fill_w = seg_pre_w | exterior_background(seg_pre_w).logical_not()
    roi_w, roi_st_w = engine._whole_tail(seg_w, rect_erode_stages(dp.erode_px),
                                         out_largest=True)
    cand_w = median_residual_mask(whole, dp.median_k, dp.threshold,
                                  roi_st_w[:, 4].to(torch.int32).contiguous(),
                                  roi_st_w[:, 5].to(torch.int32).contiguous())
    m_w = candidate_mask(cand_w, roi_w, True)
    fill_w, top_w, ext_w = fill_regions(m_w)
    # kernel G's inputs: the defect tail's fill regions, threshold and Canny
    # forms, and the ROI's max area (engine._defect)
    max_x2_w = _max_x2(roi_st_w, dp)
    m_cw = candidate_mask(canny_u8(whole, lo, hi), roi_w, False)
    fill_cw, top_cw, ext_cw = fill_regions(m_cw)
    # kernel J's: the erosion preview's unit (its seg mask eroded) and the
    # 48 eroded seg masks with an empty and a full unit in place of the
    # first two
    j_plane = tail_mask(seg_masks, rect_erode_stages(dp.erode_px))
    j_plane[0], j_plane[1] = False, True
    lin = torch.arange(m_w[0].numel(), dtype=torch.int32, device=dev).reshape(m_w.shape)
    rows = {"lo": roi_st[:, 4].to(torch.int32).contiguous(),
            "hi": roi_st[:, 5].to(torch.int32).contiguous(),
            "lo_w": roi_st_w[:, 4].to(torch.int32).contiguous(),
            "hi_w": roi_st_w[:, 5].to(torch.int32).contiguous()}
    # one unit with ROI rows, as the interactive calls and the diagnostic
    # pass take it
    rows.update(lo1=rows["lo"][u0 : u0 + 1], hi1=rows["hi"][u0 : u0 + 1])
    crop1 = crops[u0 : u0 + 1].contiguous()
    # the Otsu kernel's: the histograms its scan forms start from, and the
    # library call's offset index (unit * 256 + value), built here so that
    # its time is left out of the library form
    hist_x = histogram_u8_plain(x)
    x_idx = (x.reshape(x.shape[0], -1).to(torch.int64)
             + 256 * torch.arange(x.shape[0], device=dev)[:, None]).reshape(-1)
    # kernel I's inputs: the erosion preview's unit (its seg mask, and the
    # largest component of its erosion for the 1-px inner erode); kernel
    # F's: the whole route's two planes and their labels, and a plane of
    # isolated pixels on a 2-pixel grid (the most components a plane holds)
    seg1 = seg_masks[u0 : u0 + 1].contiguous()
    roi_pre_w = tail_mask(seg_w, rect_erode_stages(dp.erode_px)).contiguous()
    iso_w = torch.zeros_like(whole, dtype=torch.bool)
    iso_w[:, ::2, ::2] = True
    return {
        "x_w": x_w, "thr_w": thr_w, "seg_w": seg_w, "cand_w": cand_w, "roi_w": roi_w,
        "seg1": seg1, "seg1_in": largest_component(tail_mask(seg1, rect_erode_stages(dp.erode_px)))[0],
        "seg_lab_w": label_components(seg_fill_w), "roi_lab_w": label_components(roi_pre_w),
        "iso_w": iso_w, "iso_lab_w": label_components(iso_w),
        "crops": crops, "whole": whole, "crop1": crop1, "x": x, **rows,
        "hist_x": hist_x, "hist_x1": hist_x[u0 : u0 + 1].contiguous(), "x_idx": x_idx,
        "n_x": x.shape[1] * x.shape[2],
        "roi_rows21_1": _roi_rows_bytes(crop1, 21, rows["lo1"], rows["hi1"]),
        **{f"roi_rows{k}": _roi_rows_bytes(crops, k, rows["lo"], rows["hi"]) for k in (21, 45)},
        **{f"roi_rows{k}_w": _roi_rows_bytes(whole, k, rows["lo_w"], rows["hi_w"])
           for k in (21, 45)},
        "strong": strong, "cand": cand_c, "free": (seg_masks == 0).contiguous(),
        "cand_t": cand_t, "edges": edges, "roi": roi, "max_x2": max_x2,
        "fg1": fg1, "fill1": fill1, "free1": fg1.logical_not().contiguous(),
        "free_w": seg_pre_w.logical_not().contiguous(), "seg_fill_w": seg_fill_w.contiguous(),
        "roi_pre_w": roi_pre_w,
        "free_mw": m_w.logical_not().contiguous(), "m_w": m_w.contiguous(),
        "seed_w": (m_w & (fill_w == lin)).contiguous(), "fill_plane_w": ext_w.logical_not().contiguous(),
        "fill_w": fill_w, "top_w": top_w, "ext_w": ext_w, "max_x2_w": max_x2_w,
        "fill_cw": fill_cw, "top_cw": top_cw, "ext_cw": ext_cw,
        "j_plane": j_plane.contiguous(),
        "j_one": tail_mask(seg1, rect_erode_stages(dp.erode_px)).contiguous(),
    }


THR = 24  # DefectParams().threshold
MIN_X2 = 40  # 2 * DefectParams().min_area
LOW, HIGH = max(1, THR // 2), max(2, THR)  # the Canny method's thresholds


def _stages(name: str):
    from tpu_inspect_torch.ops import morphology as m

    kind, n = name.split()
    return {"co": m.close_open_stages, "open": m.open_stages, "erode": m.rect_erode_stages}[kind](
        int(n))

# form -> (kernel, input names, call on (kernel function, planes, strip));
# B's forms (the default k = 21 over the ROI rows, and k = 45, the largest
# k it takes; one unit as the interactive calls take it), C's two (the
# threshold and the Canny method's defect tail on the 48 units), then D's four
# paths (the 48 units' Canny hysteresis and the whole-image route's three),
# E's, H's (median_k = 47, the engine's smallest k on H, and 101; one
# unit; 47 on the whole plane), I's, F's, G's, J's, M's, N's, O's and the
# Otsu kernel's, and the launch floor
FORMS = {
    "B 48u k21 roi rows": ("median_residual", ("roi_rows21", "lo", "hi"),
                           lambda f, p, s: f(p["crops"], 21, THR, p["lo"], p["hi"], strip=s)),
    "B 48u k45 roi rows": ("median_residual", ("roi_rows45", "lo", "hi"),
                           lambda f, p, s: f(p["crops"], 45, THR, p["lo"], p["hi"], strip=s)),
    "B 1u k21 roi rows": ("median_residual", ("roi_rows21_1", "lo1", "hi1"),
                          lambda f, p, s: f(p["crop1"], 21, THR, p["lo1"], p["hi1"], strip=s)),
    "B whole k21 roi rows": ("median_residual", ("roi_rows21_w", "lo_w", "hi_w"),
                             lambda f, p, s: f(p["whole"], 21, THR, p["lo_w"], p["hi_w"],
                                               strip=s)),
    "B whole k45 roi rows": ("median_residual", ("roi_rows45_w", "lo_w", "hi_w"),
                             lambda f, p, s: f(p["whole"], 45, THR, p["lo_w"], p["hi_w"],
                                               strip=s)),
    "C 48u threshold form": ("blob_filter", ("cand_t", "max_x2", "roi"),
                             lambda f, p, s: f(p["cand_t"], p["max_x2"], min_x2=MIN_X2,
                                               roi=p["roi"], pre_open=True)),
    "C 48u canny form": ("blob_filter", ("edges", "max_x2", "roi"),
                         lambda f, p, s: f(p["edges"], p["max_x2"], min_x2=MIN_X2, roi=p["roi"],
                                           pre_open=False)),
    "D canny 48u": ("propagate", ("strong", "cand"),
                    lambda f, p, s: f(p["strong"], p["cand"], True)),
    "D border seg masks 48u": ("propagate", ("free",),
                               lambda f, p, s: f(None, p["free"], False, border_seed=True)),
    "D border diag unit": ("propagate", ("free1",),
                           lambda f, p, s: f(None, p["free1"], False, border_seed=True)),
    "D whole seg hole fill": ("propagate", ("free_w",),
                              lambda f, p, s: f(None, p["free_w"], False, border_seed=True)),
    "D whole defect exterior": ("propagate", ("free_mw",),
                                lambda f, p, s: f(None, p["free_mw"], False, border_seed=True)),
    "D whole top-level blobs": ("propagate", ("seed_w", "m_w"),
                                lambda f, p, s: f(p["seed_w"], p["m_w"], True)),
    "E diag fill plane": ("label", ("fill1",), lambda f, p, s: f(p["fill1"])),
    "E diag fg plane": ("label", ("fg1",), lambda f, p, s: f(p["fg1"])),
    "E canny candidates 48u": ("label", ("cand",), lambda f, p, s: f(p["cand"])),
    "E whole seg mask": ("label", ("seg_fill_w",), lambda f, p, s: f(p["seg_fill_w"])),
    "E whole ROI": ("label", ("roi_pre_w",), lambda f, p, s: f(p["roi_pre_w"])),
    "E whole fill regions": ("label", ("fill_plane_w",), lambda f, p, s: f(p["fill_plane_w"])),
    "H 48u k47": ("median_blur", ("crops",), lambda f, p, s: f(p["crops"], 47, strip=s)),
    "H 48u k101": ("median_blur", ("crops",), lambda f, p, s: f(p["crops"], 101, strip=s)),
    "H 1u k47": ("median_blur", ("crop1",), lambda f, p, s: f(p["crop1"], 47, strip=s)),
    "H whole k47": ("median_blur", ("whole",), lambda f, p, s: f(p["whole"], 47, strip=s)),
    # I: the whole route's three chains (close/open with the seg tail's
    # threshold head, the ROI erode, the candidates' open with the ROI
    # head), the config's largest ROI erode and close/open, and the erosion
    # preview's two erodes on one unit
    "I whole close/open k3 thr head": ("morph", ("x_w", "thr_w"),
                                       lambda f, p, s: f(p["x_w"], _stages("co 3"), p["thr_w"])),
    "I whole erode 13x13": ("morph", ("seg_w",), lambda f, p, s: f(p["seg_w"], _stages("erode 6"))),
    "I whole erode 401x401": ("morph", ("seg_w",),
                              lambda f, p, s: f(p["seg_w"], _stages("erode 200"))),
    "I whole open 3x3 roi head": ("morph", ("cand_w", "roi_w"),
                                  lambda f, p, s: f(p["cand_w"], _stages("open 3"), roi=p["roi_w"])),
    "I whole close/open k31 thr head": ("morph", ("x_w", "thr_w"),
                                        lambda f, p, s: f(p["x_w"], _stages("co 31"), p["thr_w"])),
    "I 1u erode 13x13": ("morph", ("seg1",), lambda f, p, s: f(p["seg1"], _stages("erode 6"))),
    "I 1u erode 3x3": ("morph", ("seg1_in",), lambda f, p, s: f(p["seg1_in"], _stages("erode 1"))),
    # F: the whole route's two calls, and the isolated-pixel grid
    "F whole seg mask": ("cc_stats", ("seg_lab_w", "seg_fill_w"),
                         lambda f, p, s: f(p["seg_lab_w"], p["seg_fill_w"])),
    "F whole ROI": ("cc_stats", ("roi_lab_w", "roi_pre_w"),
                    lambda f, p, s: f(p["roi_lab_w"], p["roi_pre_w"])),
    "F whole isolated px grid": ("cc_stats", ("iso_lab_w", "iso_w"),
                                 lambda f, p, s: f(p["iso_lab_w"], p["iso_w"])),
    # G: the whole route's defect tail, threshold and Canny forms
    "G whole defect tail": ("blob_select", ("fill_w", "top_w", "ext_w", "max_x2_w"),
                            lambda f, p, s: f(p["fill_w"], p["top_w"], p["ext_w"], p["max_x2_w"],
                                              min_x2=MIN_X2)),
    "G whole defect tail, Canny": ("blob_select", ("fill_cw", "top_cw", "ext_cw", "max_x2_w"),
                                   lambda f, p, s: f(p["fill_cw"], p["top_cw"], p["ext_cw"],
                                                     p["max_x2_w"], min_x2=MIN_X2)),
    # J: the erosion preview's unit and the 48 eroded units; the floor of a
    # one-unit launch
    "J preview unit": ("label_stats", ("j_one",), lambda f, p, s: f(p["j_one"])),
    "J 48u eroded, empty + full": ("label_stats", ("j_plane",), lambda f, p, s: f(p["j_plane"])),
    # M: the blur at the path's k = 3 on the 48 units and on the whole
    # plane, and at k = 31, the largest, on the 48 units; N: the adaptive
    # path's compare (C 10) on the 48 blurred units at the default block 51
    # and at 201, the largest, and on the blurred whole plane at block 51
    "M 48u k3": ("gauss_blur", ("crops",), lambda f, p, s: f(p["crops"], 3)),
    "M whole k3": ("gauss_blur", ("whole",), lambda f, p, s: f(p["whole"], 3)),
    "M 48u k31": ("gauss_blur", ("crops",), lambda f, p, s: f(p["crops"], 31)),
    "N 48u block51": ("adaptive", ("x",), lambda f, p, s: f(p["x"], 51, 10)),
    "N 48u block201": ("adaptive", ("x",), lambda f, p, s: f(p["x"], 201, 10)),
    "N whole block51": ("adaptive", ("x_w",), lambda f, p, s: f(p["x_w"], 51, 10)),
    # O: the Canny method's head at its default thresholds on the 48 units
    # and on the whole plane
    "O canny head 48u": ("canny_head", ("crops",), lambda f, p, s: f(p["crops"], LOW, HIGH)),
    "O canny head whole": ("canny_head", ("whole",), lambda f, p, s: f(p["whole"], LOW, HIGH)),
    # Otsu: the threshold (histogram and scan) on the 48 blurred crops, the
    # headline's input, and on the blurred whole plane; the histogram alone;
    # the scan alone on histograms built beforehand, of the 48 units and of
    # one unit (the serial chain's floor: the scan's units run side by side)
    "Otsu 48u": ("otsu", ("x",), lambda f, p, s: f(p["x"])),
    "Otsu whole": ("otsu", ("x_w",), lambda f, p, s: f(p["x_w"])),
    "Otsu hist 48u": ("otsu_hist", ("x",), lambda f, p, s: f(p["x"])),
    "Otsu hist whole": ("otsu_hist", ("x_w",), lambda f, p, s: f(p["x_w"])),
    "Otsu scan 48u": ("otsu_scan", ("hist_x",), lambda f, p, s: f(p["hist_x"], p["n_x"])),
    "Otsu scan 1u": ("otsu_scan", ("hist_x1",), lambda f, p, s: f(p["hist_x1"], p["n_x"])),
    "launch floor": ("launch_floor", (), lambda f, p, s: f(p["whole"].device)),
}
# the kernels whose forms take a strip length
STRIPPED = ("median_residual", "median_blur")
# form -> one PyTorch call computing the same function on the same input,
# its result reshaped as the kernel's: the histogram's bincount, over the
# offset index of ``planes`` for the 48 units, on the flat plane for one
LIBRARY = {
    "Otsu hist 48u": lambda p: torch.bincount(p["x_idx"], minlength=256 * p["x"].shape[0])
    .reshape(-1, 256),
    "Otsu hist whole": lambda p: torch.bincount(p["x_w"].reshape(-1), minlength=256)
    .reshape(1, 256),
}


def kernels() -> dict:
    """kernel name -> (wrapper, plain version, whether it takes a bound flag);
    B's and H's wrappers are the ones that take a strip length; the launch
    floor is the rig's own."""
    from tpu_inspect_torch.ops.cc import label_components, label_components_plain
    from tpu_inspect_torch.ops.flood import propagate, propagate_plain
    from tpu_inspect_torch.ops.median import (
        _median_blur,
        _median_residual,
        median_blur_u8_plain,
        median_residual_mask_plain,
    )

    from tpu_inspect_torch.ops import canny, gaussian, morphology, threshold
    from tpu_inspect_torch.ops.blob import blob_filter, blob_filter_plain
    from tpu_inspect_torch.ops.blob_select import blob_select, blob_select_plain
    from tpu_inspect_torch.ops.cc import (
        component_stats,
        component_stats_plain,
        largest_component,
        largest_component_sums,
    )

    def stripless(plain):  # the plain versions walk no strips
        return lambda *a, strip=None, **kw: plain(*a, **kw)

    chain = morphology.morph_chain
    chain_plain = getattr(morphology, "morph_chain_plain", None)
    if chain_plain is None:  # an older tree: byte planes in and out
        chain, chain_plain = _byte_chain(chain), _byte_chain(morphology.apply_stages)
    # a tree without M, N or O: its torch-op versions are the timed ones
    blur_plain = getattr(gaussian, "gaussian_blur_u8_plain", gaussian.gaussian_blur_u8)
    adaptive_plain = getattr(threshold, "adaptive_threshold_inv_plain",
                             threshold.adaptive_threshold_inv)
    canny_plain = getattr(canny, "canny_planes_plain", canny.canny_planes)
    return {"propagate": (propagate, propagate_plain, True),
            "label": (label_components, label_components_plain, True),
            "median_residual": (_median_residual, stripless(median_residual_mask_plain), False),
            "median_blur": (_median_blur, stripless(median_blur_u8_plain), False),
            "blob_filter": (blob_filter, blob_filter_plain, True),
            "morph": (chain, chain_plain, False),
            "cc_stats": (component_stats, component_stats_plain, True),
            "blob_select": (blob_select, blob_select_plain, True),
            # an older tree's J takes no flag: it reads its own each call
            "label_stats": (largest_component_sums, largest_component,
                            "err" in inspect.signature(largest_component_sums).parameters),
            "gauss_blur": (gaussian.gaussian_blur_u8, blur_plain, False),
            "adaptive": (threshold.adaptive_threshold_inv, adaptive_plain, False),
            "canny_head": (canny.canny_planes, canny_plain, False),
            "otsu": (threshold.otsu_threshold, threshold.otsu_threshold_plain, False),
            "otsu_hist": (threshold.histogram_u8, threshold.histogram_u8_plain, False),
            "otsu_scan": (threshold.otsu_threshold_from_hist,
                          threshold.otsu_threshold_from_hist_plain, False),
            "launch_floor": (_launch_floor, _launch_floor_plain, False)}


def _launch_floor(dev: torch.device) -> torch.Tensor:
    """The rig's floor: one launch of a one-thread kernel storing one zero
    byte (``tik_launch_floor``); on the CPU its plain version."""
    if dev.type != "cuda":
        return _launch_floor_plain(dev)
    from tpu_inspect_torch.kernels import build

    out = torch.empty((1, 1, 1), dtype=torch.uint8, device=dev)
    build.check("launch_floor", build.lib().tik_launch_floor(
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    return out


def _launch_floor_plain(dev: torch.device) -> torch.Tensor:
    return torch.zeros((1, 1, 1), dtype=torch.uint8, device=dev)


def _byte_chain(chain):
    """The mask chain's contract over a byte-plane stage chain: the head
    (``x <= thr`` or ``x > 0`` as 0/255, or ``x`` where ``roi > 0``) and the
    ``> 0`` of the result as the torch ops its callers ran."""
    def run(x, stages, thr=None, roi=None):
        if thr is not None:
            v = torch.where(x.to(torch.int32) <= thr.reshape(-1, 1, 1), 255, 0).to(torch.uint8)
        elif roi is not None:
            v = torch.where(roi > 0, x, torch.zeros_like(x))
        else:
            v = torch.where(x > 0, 255, 0).to(torch.uint8)
        return chain(v, stages) > 0

    return run


def _ms(fn, dev: torch.device, n: int, reps: int) -> float:
    """Median ms per call over ``reps`` runs of ``n`` calls in a row: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(times)


def bench(forms=tuple(FORMS), device="cuda", small: bool = False, n: int = 20,
          reps: int = 5, profile: bool = False, strips=(None,)) -> list[dict]:
    """Check and time each of ``forms`` (B's and H's once for each of
    ``strips``, None their default); returns one dict a form and strip
    (form, kernel, strip, shape, max_abs_err, ms, ms_flag_each_call,
    plain_ms, bound_ms, library_ms, where; library_ms None where
    ``LIBRARY`` has no call for the form). For a kernel with a bound flag, ``ms``
    passes every call one flag, read after the timing (as the engine's
    entry points read theirs once a call), and ``ms_flag_each_call`` lets
    the wrapper read its own flag after each launch, a host wait a call
    (None for B and H, which have no flag). With ``profile`` (card only)
    each row also has ``device``: [name, ms, launches] per kernel and call
    under ``torch.profiler``. Raises if a form differs from its plain
    version (or its library call from the kernel) or a kernel set its
    flag."""
    from functools import partial

    from tpu_inspect_torch.device import resolve_device
    from tpu_inspect_torch.kernels import build, error_flag

    unknown = [f for f in forms if f not in FORMS]
    if unknown:
        raise ValueError(f"kernel_bench: unknown forms {unknown}; known: {list(FORMS)}")
    dev = resolve_device(device)
    p = planes(dev, small)
    fns = kernels()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host wall)"
    rows = []
    for form in forms:
        name, inputs, call = FORMS[form]
        fast, plain, flagged = fns[name]
        ref = call(plain, p, None)
        plain_ms = _ms(lambda: call(plain, p, None), dev, max(1, n // 10), reps)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for strip in strips if name in STRIPPED else (None,):
            got = call(fast, p, strip)
            gots = got if isinstance(got, tuple) else (got,)
            err = max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max()) if g.numel() else 0
                      for g, r in zip(gots, refs))
            if any(g.dtype != r.dtype for g, r in zip(gots, refs)) or err:
                raise RuntimeError(f"kernel_bench: {form} (strip {strip}) differs from its plain "
                                   f"version (max |err| {err})")
            moved = sum(p[k] if isinstance(p[k], int) else p[k].numel() * p[k].element_size()
                        for k in inputs)
            moved += sum(g.numel() * g.element_size() for g in gots)
            library_ms = None
            if form in LIBRARY:
                lib = LIBRARY[form](p)
                if lib.dtype != gots[0].dtype or not torch.equal(lib, gots[0]):
                    raise RuntimeError(f"kernel_bench: {form}'s library call differs from the "
                                       f"kernel")
                library_ms = _ms(lambda: LIBRARY[form](p), dev, n, reps)
            flag = error_flag(dev)
            one_flag = partial(fast, err=flag) if flagged and dev.type == "cuda" else fast
            rows.append({
                "form": form, "kernel": name, "strip": strip, "shape": list(gots[0].shape),
                "max_abs_err": err,
                "ms": _ms(lambda: call(one_flag, p, strip), dev, n, reps),
                "ms_flag_each_call": (_ms(lambda: call(fast, p, strip), dev, n, reps)
                                      if flagged else None),
                "plain_ms": plain_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "library_ms": library_ms, "where": where,
            })
            if profile and dev.type == "cuda":
                from tpu_inspect_torch.utils.profile import profile_device

                prof = profile_device(lambda: call(one_flag, p, strip), reps)
                rows[-1]["device"] = [[k[:60], ms, c] for k, ms, c in prof.rows]
            build.check_bounded(f"kernel_bench {form}", flag)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m tpu_inspect_torch.tools.kernel_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("forms", nargs="*", help="forms to run (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="small planes (a CPU run)")
    ap.add_argument("--n", type=int, default=20, help="calls in a row per timing")
    ap.add_argument("--reps", type=int, default=5, help="timings per form (median)")
    ap.add_argument("--profile", action="store_true",
                    help="device time per kernel under torch.profiler (card only)")
    ap.add_argument("--strips", default="",
                    help="comma-separated strip lengths for B's and H's forms (default: theirs)")
    ap.add_argument("--list", action="store_true", help="print the forms and exit")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(FORMS))
        return []
    strips = tuple(int(v) for v in args.strips.split(",") if v) or (None,)
    rows = bench(tuple(args.forms) or tuple(FORMS), args.device, args.small, args.n, args.reps,
                 args.profile, strips)
    for r in rows:
        shape = "x".join(map(str, r["shape"]))
        flag = r["ms_flag_each_call"]
        flag = "no flag" if flag is None else f"{flag:.4f} reading the flag each call"
        strip = "" if r["strip"] is None else f" S={r['strip']}"
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        print(f"{r['form'] + strip:32s} {shape:>12s} {r['ms']:9.4f} ms ({flag}; plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us{lib}) exact, on "
              f"{r['where']}")
        for name, ms, count in r.get("device", []):
            print(f"    {ms:9.4f} ms x{count:g}  {name}")
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
