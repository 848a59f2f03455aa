"""The inspection tool's chain, as its OpenCV calls compute it, over the
units of one capture: the plain reference that decides ``correct``.

Segmentation (segmentation.py:75-111, indexing_ui.py:2203-2368): Gaussian
blur, Otsu or adaptive Gaussian inverse threshold, close then open with an
ellipse, hole fill; the largest 8-connected component's centroid is the
unit's anchor on the reference capture, and on other captures the
exclusions move by the rounded difference to it. Defects
(indexing_ui.py:1471-1572, :1634-1709): the ROI (the seg mask eroded,
its largest component), the candidates (``|x - medianBlur(x, k)| > thr``
with a 3x3 elliptic open, or Canny), each external contour kept when its
area lies in ``[min_area, max(min_area, int(0.98 * roi_area))]`` and drawn
filled; the verdict is NG when the drawn area reaches ``min_area``.

A contour's area is the area of the polygon through its pixel centres. By
Pick's theorem a region of ``N`` pixels whose outer border visits ``P``
pixel centres (with repeats) encloses ``N - P / 2 - 1`` (0 for a single
pixel); a filled external contour paints exactly the pixels that the
background's flood fill from the border does not reach.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import components as cc
from benchmark.reference import pixel


def unit_boxes(grid: dict) -> list[tuple[int, int, int, int]]:
    """Unit rects (x, y, w, h) in the tool's index order (indexing_ui.py:
    2171-2191): a row of units spans every block across before moving
    down."""
    bx0, by0, w, h = grid["base_unit"]
    ux, uy = grid["units_x"], grid["units_y"]
    pitch_x = ux * w + (ux - 1) * grid["unit_space_x"] + grid["block_space_x"]
    pitch_y = uy * h + (uy - 1) * grid["unit_space_y"] + grid["block_space_y"]
    return [
        (bx0 + bx * pitch_x + i * (w + grid["unit_space_x"]),
         by0 + by * pitch_y + j * (h + grid["unit_space_y"]), w, h)
        for by in range(grid["blocks_y"]) for j in range(uy)
        for bx in range(grid["blocks_x"]) for i in range(ux)
    ]


def crops(image: torch.Tensor, grid: dict) -> torch.Tensor:
    """The units' crops [U, h, w] of a capture [H, W] (the grid lies inside
    the capture)."""
    return torch.stack([image[y:y + h, x:x + w] for x, y, w, h in unit_boxes(grid)])


def exclusion_zone(shape, exclusions, dx: np.ndarray, dy: np.ndarray, device) -> torch.Tensor:
    """[U, h, w] bool keep-out planes (indexing_ui.py:2316-2338): each
    exclusion moved by its unit's (dx, dy); a rect clamped to the unit, a
    circle by the integer disc test, r <= 0 a no-op."""
    h, w = shape
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    ddx = torch.as_tensor(dx, device=device, dtype=torch.int64)[:, None, None]
    ddy = torch.as_tensor(dy, device=device, dtype=torch.int64)[:, None, None]
    zone = torch.zeros((len(dx), h, w), dtype=torch.bool, device=device)
    for e in exclusions:
        if e["shape"] == "rect":
            x0, y0 = e["x"] + ddx, e["y"] + ddy
            zone |= (xs >= x0) & (xs < x0 + e["w"]) & (ys >= y0) & (ys < y0 + e["h"])
        elif e["r"] > 0:
            zone |= (xs - (e["cx"] + ddx)) ** 2 + (ys - (e["cy"] + ddy)) ** 2 <= e["r"] ** 2
    return zone


def segment(x: torch.Tensor, seg: dict, exclusions, anchors=None, low: bool = False) -> dict:
    """The segmentation pass over crops ``x`` [U, h, w] uint8. ``anchors``:
    None on the reference capture, else ([U, 2] float64 centroids, [U] bool
    valid) of it. Returns host arrays: ``mask`` [U, h, w] bool (exclusions
    applied), ``centroid`` [U, 2] float64 and ``has_fg`` [U] bool (before
    the exclusions), ``shift`` [U, 2] int32 (dx, dy). ``low``: see
    :func:`inspect`."""
    u = x.shape[0]
    b = pixel.gaussian_blur_u8(x, seg["gaussian_blur"] | 1, low) if seg["gaussian_blur"] > 0 else x
    if seg["method"] == "adaptive":
        m = pixel.adaptive_threshold_inv(b, max(3, seg["adapt_block"] | 1), seg["adapt_C"], low)
    else:
        thr = pixel.otsu_thresholds(pixel.histograms(b), b.shape[1] * b.shape[2], low)
        m = b.to(torch.int32) <= torch.as_tensor(thr, device=x.device)[:, None, None]
    if seg["morph_kernel"] > 0:
        se = pixel.ellipse_se(seg["morph_kernel"])
        m = pixel.morph_open(pixel.morph_close(m, se), se)
    m = cc.fill_holes(m)
    _, area, sx, sy = cc.largest(m)
    area, sx, sy = (t.cpu().numpy() for t in (area, sx, sy))
    cnt = np.maximum(area, 1).astype(np.float64)
    centroid = np.stack([sx / cnt, sy / cnt], axis=-1)
    has_fg = area > 0
    shift = np.zeros((u, 2), np.int32)
    if anchors is not None:
        ref, ok = anchors
        # int(round(c1 - c0)): half to even, as Python's round and np.rint
        ok = ok & has_fg
        shift[ok] = np.rint(centroid[ok] - ref[ok]).astype(np.int32)
    if exclusions:
        m = m & ~exclusion_zone(m.shape[1:], exclusions, shift[:, 0], shift[:, 1], x.device)
    return {"mask": m, "centroid": centroid, "has_fg": has_fg, "shift": shift}


def defects(x: torch.Tensor, seg_mask: torch.Tensor, defect: dict, low: bool = False) -> dict:
    """The defect pass over crops ``x`` and their seg masks (bool).
    Returns ``mask`` [U, h, w] bool (kept blobs, filled), ``area`` [U]
    int64, ``found`` [U] bool (a blob was kept) and ``verdict`` [U] bool
    (NG), the last three on the host."""
    rect = np.ones((3, 3), np.uint8)
    roi = seg_mask
    for _ in range(defect["erode_px"]):
        roi = pixel.erode(roi, rect)
    roi, roi_area, _, _ = cc.largest(roi)
    thr = defect["threshold"]
    if defect["method"] == "canny":
        strong, cand = pixel.canny_planes(x, max(1, thr // 2), max(2, thr))
        lab = cc.components(cand, conn8=True)
        hit = torch.zeros(lab.numel() + 1, dtype=torch.bool, device=x.device)
        hit[lab[strong]] = True
        hit[0] = False
        fg = hit[lab] & roi
    else:
        k = defect["median_k"] | 1
        bg = pixel.median_blur_u8(x, k)
        fg = (x.to(torch.int16) - bg.to(torch.int16)).abs() > thr
        fg = pixel.morph_open(fg & roi, pixel.ellipse_se(3))
    fill = ~cc.exterior(fg)
    regions = cc.components(fill, conn8=True)
    n = regions.numel() + 1
    npx = torch.bincount(regions.reshape(-1), minlength=n)
    visits = torch.bincount(regions.reshape(-1), weights=cc.contour_visits(fill).reshape(-1).double(),
                            minlength=n).to(torch.int64)
    area2 = torch.where(npx == 1, 0, 2 * npx - visits - 2)
    min_area = defect["min_area"]
    frac = np.float32 if low else np.float64
    max_area = np.maximum(min_area, np.floor(roi_area.cpu().numpy().astype(frac)
                                             * frac(defect["max_area_frac"])).astype(np.int64))
    cap = torch.as_tensor(2 * max_area, device=x.device)
    unit = torch.div(torch.arange(n, device=x.device) - 1, x[0].numel(), rounding_mode="floor")
    keep = (area2 >= 2 * min_area) & (area2 <= cap[unit.clamp(min=0)])
    keep[0] = False
    mask = keep[regions]
    area = mask.sum(dim=(1, 2)).cpu().numpy()
    found = area > 0
    return {"mask": mask, "area": area.astype(np.int64), "found": found,
            "verdict": found & (area >= min_area)}


def inspect(image: torch.Tensor, cfg: dict, anchors=None, low: bool = False) -> dict:
    """One capture [H, W] uint8 through the whole chain: the
    :func:`segment` and :func:`defects` results of its units under
    configuration ``cfg`` (its ``grid``, ``segmentation``, ``defect`` and
    ``exclusions``), masks on the host.

    ``low`` computes every floating or fixed-point step one rung lower
    (:mod:`benchmark.reference.pixel`): the benchmark's control."""
    x = crops(image, cfg["grid"])
    s = segment(x, cfg["segmentation"], cfg["exclusions"], anchors, low)
    d = defects(x, s["mask"], cfg["defect"], low)
    return {
        "seg_mask": s["mask"].cpu().numpy(), "centroid": s["centroid"], "has_fg": s["has_fg"],
        "shift": s["shift"], "defect_mask": d["mask"].cpu().numpy(), "area": d["area"],
        "found": d["found"], "verdict": d["verdict"],
    }
