"""Qt-free numpy/OpenCV restatement of the reference inspection chain.

Copy of :mod:`tpu_inspect.oracle.reference` for the port, with the
configuration and ``exclusion_mask`` taken from the port's own modules.
Every function documents the reference call sites (file:line into the
reference tool's sources) whose observable behavior it reproduces. This
module is the oracle: the port's engine must match it bit-for-bit.
"""

from __future__ import annotations

import cv2
import numpy as np

from tpu_inspect_torch.config import DefectParams, SegmentationParams
from tpu_inspect_torch.geometry import exclusion_mask


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 -> gray uint8, OpenCV fixed-point weights.

    The reference converts every crop via cv2.cvtColor(BGR2GRAY)
    (segmentation.py:23). OpenCV computes
    ``(R*4899 + G*9617 + B*1868 + 2^13) >> 14``.
    """
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Fill 0-regions fully enclosed by foreground (segmentation.py:27-72).

    The reference flood-fills the inverted mask from every border background
    pixel (4-connected); whatever background remains unreached is a hole.
    Padding the inverted mask with one background ring and flood-filling once
    from the corner reaches exactly the same set (the ring 4-connects all
    border background pixels), so this is semantically identical.
    """
    m = (np.asarray(mask) > 0).astype(np.uint8) * 255
    h, w = m.shape
    if h == 0 or w == 0:
        return m
    inv = cv2.bitwise_not(m)
    padded = cv2.copyMakeBorder(inv, 1, 1, 1, 1, cv2.BORDER_CONSTANT, value=255)
    ff_mask = np.zeros((h + 4, w + 4), dtype=np.uint8)
    cv2.floodFill(padded, ff_mask, (0, 0), 0)  # 4-connected by default
    holes = padded[1:-1, 1:-1]
    return cv2.bitwise_or(m, holes)


def segment_unit(gray: np.ndarray, params: SegmentationParams) -> np.ndarray:
    """Per-unit segmentation (segmentation.py:75-100).

    Chain: optional Gaussian blur (even kernel bumped to odd, :79) ->
    Otsu inverse-binary (:82) or adaptive-Gaussian inverse threshold with
    block ``max(3, adapt_block | 1)`` (:84-86) -> morphological CLOSE then
    OPEN with a k x k ellipse SE, one iteration each (:91-95) -> hole fill.
    Unknown methods fall back to Otsu (:87-89).
    """
    img = np.asarray(gray, dtype=np.uint8)
    gb = int(params.gaussian_blur)
    if gb > 0:
        k = gb if gb % 2 == 1 else gb + 1
        img = cv2.GaussianBlur(img, (k, k), 0)
    if params.method == "adaptive":
        bs = max(3, int(params.adapt_block) | 1)
        mask = cv2.adaptiveThreshold(
            img,
            255,
            cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
            cv2.THRESH_BINARY_INV,
            bs,
            int(params.adapt_C),
        )
    else:
        _, mask = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    mk = int(params.morph_kernel)
    if mk > 0:
        k = max(1, mk)
        se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, se, iterations=1)
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, se, iterations=1)
    return fill_holes(mask)


def mask_stats(mask: np.ndarray) -> dict:
    """Pixel count + float64 mean centroid (segmentation.py:103-111)."""
    ys, xs = np.where(np.asarray(mask) > 0)
    if xs.size == 0:
        return {"area": 0, "centroid": (0, 0)}
    return {"area": int(xs.size), "centroid": (float(xs.mean()), float(ys.mean()))}


def largest_component_centroid(bin_mask: np.ndarray):
    """Centroid of the largest 8-connected component (indexing_ui.py:2235-2256).

    Returns (cx, cy) floats, or None when the mask is empty. Area ties keep
    the smallest label (np.argmax takes the first maximum).
    """
    if bin_mask is None or bin_mask.size == 0:
        return None
    src = (np.asarray(bin_mask) > 0).astype(np.uint8)
    nlab, labels, stats, _ = cv2.connectedComponentsWithStats(src, connectivity=8)
    if nlab <= 1:
        return None
    areas = stats[1:, cv2.CC_STAT_AREA]
    best = 1 + int(np.argmax(areas))
    ys, xs = np.where(labels == best)
    if xs.size == 0:
        return None
    return (float(xs.mean()), float(ys.mean()))


def apply_exclusions(
    mask: np.ndarray, exclusions, dx: int = 0, dy: int = 0
) -> np.ndarray:
    """Zero out exclusion zones shifted by (dx, dy) (indexing_ui.py:2316-2338)."""
    out = np.asarray(mask).copy()
    h, w = out.shape
    out[exclusion_mask(exclusions, h, w, dx, dy)] = 0
    return out


def detect_defects(
    gray: np.ndarray,
    seg_mask: np.ndarray | None,
    params: DefectParams,
    stats_out: dict | None = None,
) -> np.ndarray | None:
    """Foreign-material defect detection (indexing_ui.py:1471-1572).

    ROI prep: binarize the segmentation mask, erode ``erode_px`` iterations
    of the default 3x3 rect kernel (:1497), keep only the largest
    8-connected component so exclusion holes stay holes (:1500-1512); abort
    with None when the ROI is empty (:1514-1516).

    'threshold' method (:1519-1535): residual = |gray - medianBlur(gray, 21)|,
    binary threshold, AND ROI, open with 3x3 ellipse.
    'canny' method (:1536-1539): Canny(gray, max(1, thr//2), max(2, thr)) AND ROI.

    Blob filter (:1540-1558): external contours; keep those with
    ``min_area <= contourArea <= max(min_area, 0.98 * roi_area)``; kept blobs
    are redrawn filled (their internal holes fill in). Returns None when no
    blob is kept (:1559-1560).
    """
    gray = np.asarray(gray, dtype=np.uint8)
    seg_bin = None
    if seg_mask is not None:
        seg_bin = (np.asarray(seg_mask) > 0).astype(np.uint8) * 255
        if params.erode_px > 0:
            seg_bin = cv2.erode(seg_bin, None, iterations=int(params.erode_px))
        cc_src = (seg_bin > 0).astype(np.uint8)
        nlab, labels, stats, _ = cv2.connectedComponentsWithStats(cc_src, connectivity=8)
        if nlab > 1:
            areas = stats[1:, cv2.CC_STAT_AREA]
            best = 1 + int(np.argmax(areas))
            seg_bin = (labels == best).astype(np.uint8) * 255
        if seg_bin.sum() == 0:
            if stats_out is not None:
                stats_out["roi_empty"] = True
            return None

    thr = int(params.threshold)
    if params.method == "threshold":
        k = int(params.median_k)
        if k % 2 == 0:
            k += 1
        bg = cv2.medianBlur(gray, k)
        resid = cv2.absdiff(gray, bg)
        _, mask = cv2.threshold(resid, thr, 255, cv2.THRESH_BINARY)
        if seg_bin is not None:
            mask = cv2.bitwise_and(mask, seg_bin)
        se3 = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, se3, iterations=1)
    else:
        mask = cv2.Canny(gray, max(1, thr // 2), max(2, thr))
        if seg_bin is not None:
            mask = cv2.bitwise_and(mask, seg_bin)

    cnts, _ = cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    out = np.zeros_like(mask)
    min_area = int(params.min_area)
    roi_area = (
        int((seg_bin > 0).sum()) if seg_bin is not None else int(gray.size)
    )
    max_area = max(min_area, int(roi_area * params.max_area_frac))
    found = False
    for c in cnts:
        a = cv2.contourArea(c)
        if min_area <= a <= max_area:
            cv2.drawContours(out, [c], -1, 255, -1)
            found = True
    if stats_out is not None:
        stats_out["roi_area"] = roi_area
        stats_out["max_area"] = max_area
    if not found:
        return None
    return out


def segment_all_units(
    crops_gray: np.ndarray,
    params: SegmentationParams,
    exclusions=(),
    ref_centroids: dict[int, tuple[float, float]] | None = None,
    is_reference: bool = True,
):
    """The reference's segmentation pass over all units (indexing_ui.py:2203-2368).

    ``crops_gray`` is [units, H, W] uint8. On the reference image
    (is_reference=True) the pre-exclusion largest-component centroid of each
    unit is recorded as the alignment anchor (:2282-2289); on other images
    the per-unit shift ``(dx, dy) = round(c1 - c0)`` is applied to the
    exclusions (:2291-2338). Python's round() (banker's rounding) is used,
    matching ``int(round(...))`` at :2310-2311.

    Returns (masks [U,H,W] uint8, centroids {idx: (cx,cy)}, shifts [U,2] int).
    """
    masks = []
    centroids: dict[int, tuple[float, float]] = {}
    shifts = []
    for idx in range(crops_gray.shape[0]):
        mask = segment_unit(crops_gray[idx], params)
        c1 = largest_component_centroid(mask)
        dx = dy = 0
        if is_reference:
            if c1 is not None:
                centroids[idx] = c1
        else:
            c0 = (ref_centroids or {}).get(idx)
            if c0 is not None and c1 is not None:
                dx = int(round(c1[0] - c0[0]))
                dy = int(round(c1[1] - c0[1]))
        mask = apply_exclusions(mask, exclusions, dx, dy)
        masks.append(mask)
        shifts.append((dx, dy))
    return np.stack(masks), centroids, np.array(shifts, dtype=np.int32)


def inspect_units(
    crops_gray: np.ndarray,
    seg_masks: np.ndarray,
    params: DefectParams,
):
    """Defect pass + X/O verdicts over all units (indexing_ui.py:1634-1709).

    Verdict: NG iff the defect-pixel area >= min_area (:1699); a None defect
    mask means OK (:1686-1688). Returns (defect_masks list of [H,W] | None,
    areas [U] int64, verdicts [U] bool).
    """
    defect_masks = []
    areas = []
    verdicts = []
    for idx in range(crops_gray.shape[0]):
        dm = detect_defects(crops_gray[idx], seg_masks[idx], params)
        defect_masks.append(dm)
        area = 0 if dm is None else mask_stats(dm)["area"]
        areas.append(area)
        verdicts.append(dm is not None and area >= int(params.min_area))
    return defect_masks, np.array(areas, dtype=np.int64), np.array(verdicts)
