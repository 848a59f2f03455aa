"""Batched inspection pipeline on PyTorch + CUDA (the port's main path).

Port of :mod:`tpu_inspect.engine`'s split path (``_inspect_image_device``
with the chain flag off): one call goes from the raw grayscale image to
per-unit masks, defect blobs and X/O verdicts::

    gather crops -> Gaussian -> Otsu (the Otsu kernel: histogram and
    scan; or the adaptive Gaussian-mean threshold) -> seg tail (kernel A:
    x <= thr or x > 0, close+open, hole fill, largest-CC sums) ->
    alignment shifts -> exclusion zone -> ROI
    tail (kernel A: (2n+1)^2 erode, largest CC) -> max area -> median
    residual (kernel B; or Canny, whose hysteresis is kernel D) -> blob
    filter (kernel C: ROI AND, 3x3 open for the residual, contourArea
    filter, filled paint) -> verdicts

The threshold method with a median window of k*k >= 2048 (``median_k``
>= 47), where kernel B's two rank queries do not apply, takes the full
median instead: the background is kernel H's k x k median blur of every
row, and the candidates are ``|x - bg| > thr`` (the JAX package's
``engine.py:461-465``), then the same blob filter.

The whole-image route: a unit of more than ``WHOLE_MIN_PX`` pixels (a
whole 4096x3000 capture, ``bench.py``'s config1 and config1defect), or one
too large for kernel A's or C's int32 sums, takes the port of the JAX
package's unfused whole-plane path instead of kernels A and C, on both
devices alike (:func:`_whole_route`):

    seg tail: x <= thr (or x > 0), close+open (kernel I), hole fill
    (kernel D, border form), labels (kernel E), largest-CC mask and int64
    stats (kernel F); ROI tail: the same with the erode and no fill;
    defect tail: candidates (kernel B on the whole plane, kernel H's full
    median, or Canny), ROI AND, 3x3 open (kernel I), exterior (kernel D),
    fill labels (kernel E), top-level blobs (kernel D seeded with each fill
    region's first pixel), Green's filter and filled paint (kernel G)

:func:`_inspect_image_device` is the program of one capture, shared by
:func:`inspect_image` and the capture stream
(:mod:`tpu_inspect_torch.streaming`). On the reference capture with the
chain flag set (``_ENABLE_CHAIN``, read once at import from
``TPU_INSPECT_ENABLE_CHAIN``, as the JAX package does) and the otsu method,
the seg tail, the exclusion zone and the ROI tail run chained in ONE launch
of kernel K (:func:`_segment_roi`, ``csrc/seg_roi_tail.cu``) in place of
kernel A's two; the defect pass then starts from K's ROI
(:func:`_defect_from_roi`). With the flag unset the split path above runs.
On the card, repeated calls of the program (any route) with the same grid,
recipe, exclusions and anchors replay one captured CUDA graph
(:mod:`tpu_inspect_torch.graphs`, keyed by :func:`_frame_key`).

:func:`defect_intermediates` is the per-unit diagnostic pass; its contour
analysis runs kernel D (exterior flood) and kernel E (labeling, twice), and
its 3x3 open kernel I. Kernel J (labels and the largest component's stats
in one launch) serves the session's erosion preview
(:func:`tpu_inspect_torch.render.erosion_outline_mask`).

Every stage is bit-exact vs the JAX package. On ``device="cuda"`` the
kernels are the hand-written CUDA sources in ``csrc/``; on ``device="cpu"``
their plain PyTorch versions run.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.device import resolve_device
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.imageio import gather_crops
from tpu_inspect_torch.graphs import FRAMES
from tpu_inspect_torch.kernels import build, device_constant, error_flag
from tpu_inspect_torch.ops.blob import blob_filter, blob_filter_fits, candidate_mask
from tpu_inspect_torch.ops.blob_select import blob_select
from tpu_inspect_torch.ops.canny import canny_u8
from tpu_inspect_torch.ops.cc import component_stats, label_components
from tpu_inspect_torch.ops.common import as_odd
from tpu_inspect_torch.ops.contour import analyze_blobs, fill_regions
from tpu_inspect_torch.ops.fused import seg_roi_tail, seg_tail, seg_tail_fits, tail_mask
from tpu_inspect_torch.ops.gaussian import gaussian_blur_u8
from tpu_inspect_torch.ops.hole_fill import exterior_background
from tpu_inspect_torch.ops.median import median_blur_u8, median_residual_mask
from tpu_inspect_torch.ops.morphology import (
    close_open_stages,
    morph_chain,
    rect_erode_stages,
)
from tpu_inspect_torch.ops.threshold import (
    adaptive_threshold_inv,
    otsu_threshold,
    threshold_binary,
)
from tpu_inspect_torch.utils.trace import span


@dataclass
class SegmentationResult:
    """Host-side view of one segmentation pass."""

    masks: np.ndarray  # [U, H, W] uint8 0/255, exclusions applied
    centroids: np.ndarray  # [U, 2] float64 pre-exclusion largest-CC centroid
    centroid_valid: np.ndarray  # [U] bool
    shifts: np.ndarray  # [U, 2] int32 (dx, dy) applied to exclusions

    def centroid_dict(self) -> dict[int, tuple[float, float]]:
        """Anchors in the persistence format {idx: (cx, cy)}."""
        return {
            int(i): (float(c[0]), float(c[1]))
            for i, (c, v) in enumerate(zip(self.centroids, self.centroid_valid))
            if v
        }


@dataclass
class InspectionResult:
    """Host-side view of one defect/inspection pass."""

    defect_masks: np.ndarray  # [U, H, W] uint8 0/255 (all-zero when not valid)
    valid: np.ndarray  # [U] bool: reference returned a mask (not None)
    areas: np.ndarray  # [U] defect pixel area, 0 when not valid (int64 from
    # inspect_image, int32 from the unit-level entry points, as in the JAX engine)
    verdicts: np.ndarray  # [U] bool: True = NG

    def defect_mask_list(self) -> list[np.ndarray | None]:
        """Masks in the reference's Optional form (None where no detection)."""
        return [
            self.defect_masks[i] if self.valid[i] else None
            for i in range(self.defect_masks.shape[0])
        ]


# ---------------------------------------------------------------------------
# Host-side helpers (numpy copies of tpu_inspect.engine's)
# ---------------------------------------------------------------------------


def pack_exclusions(exclusions) -> tuple[np.ndarray, np.ndarray]:
    """Split exclusion dicts into (rects [Nr,4] int32, circles [Nc,3] int32).

    Malformed entries are dropped, zero-size rects / r<=0 circles kept (they
    apply as no-ops exactly like the reference's bounds checks,
    indexing_ui.py:2325, :2332). Padded to a power-of-two count with no-op
    entries, like the JAX engine's arrays.
    """
    rects, circles = [], []
    for e in exclusions or ():
        try:
            if e.get("shape") == "rect":
                rects.append(
                    [int(e.get("x", 0)), int(e.get("y", 0)), int(e.get("w", 0)), int(e.get("h", 0))]
                )
            else:
                circles.append(
                    [int(e.get("cx", 0)), int(e.get("cy", 0)), int(e.get("r", 0))]
                )
        except (AttributeError, TypeError, ValueError):
            continue

    def cap(n: int) -> int:
        return 0 if n == 0 else 1 << (n - 1).bit_length()

    rects += [[0, 0, 0, 0]] * (cap(len(rects)) - len(rects))
    circles += [[0, 0, 0]] * (cap(len(circles)) - len(circles))
    return (
        np.array(rects, dtype=np.int32).reshape(-1, 4),
        np.array(circles, dtype=np.int32).reshape(-1, 3),
    )


def centroids_from_sums(sums: np.ndarray) -> np.ndarray:
    """[U, 3] integer (sx, sy, area) -> exact f64 mean centroids [U, 2],
    divided on the host so persisted anchors bit-match the reference's
    numpy means (segmentation.py:103-111)."""
    sums = np.asarray(sums)
    cnt = np.maximum(sums[:, 2], 1).astype(np.float64)
    return np.stack(
        [sums[:, 0].astype(np.float64) / cnt, sums[:, 1].astype(np.float64) / cnt],
        axis=-1,
    )


def ref_centroid_arrays(ref_centroids, u: int) -> tuple[np.ndarray, np.ndarray]:
    """Normalize alignment anchors into ([U,2] float64, [U] bool valid).

    Accepts the persistence dict form {idx: (cx, cy)} (sparse), a dense
    [U,2] array (all valid), or None (no anchors).
    """
    if isinstance(ref_centroids, dict):
        arr = np.zeros((u, 2), dtype=np.float64)
        valid = np.zeros((u,), dtype=bool)
        for k, v in ref_centroids.items():
            if 0 <= int(k) < u:
                arr[int(k)] = (float(v[0]), float(v[1]))
                valid[int(k)] = True
        return arr, valid
    if ref_centroids is None:
        return np.zeros((u, 2), dtype=np.float64), np.zeros((u,), dtype=bool)
    return (
        np.asarray(ref_centroids, dtype=np.float64),
        np.ones((u,), dtype=bool),
    )


def anchor_key(ref_centroids):
    """The alignment anchors as a hashable value equal for equal anchors:
    None, ``("dict", frozenset of the items)`` for the persistence dict
    form, ``("array", shape, float64 bytes)`` for a dense array."""
    if ref_centroids is None:
        return None
    if isinstance(ref_centroids, dict):
        try:
            return "dict", frozenset(ref_centroids.items())
        except TypeError:  # unhashable values (lists, arrays)
            return "dict", frozenset((k, tuple(v)) for k, v in ref_centroids.items())
    a = np.ascontiguousarray(ref_centroids, dtype=np.float64)
    return "array", a.shape, a.tobytes()


@device_constant(maxsize=8)
def _anchor_tensors(key, u: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ref_centroid_arrays` of the anchors :func:`anchor_key` gave
    ``key``, on ``device``: uploaded once per anchor set."""
    if key is None:
        anchors = None
    elif key[0] == "dict":
        anchors = dict(key[1])
    else:
        anchors = np.frombuffer(key[2], dtype=np.float64).reshape(key[1]).copy()
    ref_arr, ref_ok = ref_centroid_arrays(anchors, u)
    dev = torch.device(device)
    return _upload(ref_arr, dev), _upload(ref_ok, dev)


@device_constant(maxsize=8)
def origins_on(grid: GridParams, device: str) -> torch.Tensor:
    """The grid's unit origins [U, 2] on ``device``, uploaded once per grid:
    the same tensor for every call, so calls on one grid share a frame
    key (:func:`_frame_key`)."""
    return torch.from_numpy(grid_origins(grid)).to(device)


def exclusion_zone(shape, rects: np.ndarray, circles: np.ndarray,
                   dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Rasterize per-unit shifted exclusions. Returns [U, H, W] bool on
    dx's device (U = len(dx)).

    Semantics of the apply loop (indexing_ui.py:2316-2338): rect bounds are
    shifted (empty when degenerate); circles use the integer disc test with
    no clamping; r <= 0 is a no-op.
    """
    h, w = shape
    dev = dx.device
    xs = torch.arange(w, device=dev, dtype=torch.int64)[None, None, :]
    ys = torch.arange(h, device=dev, dtype=torch.int64)[None, :, None]
    dxe = dx.to(torch.int64)[:, None, None]
    dye = dy.to(torch.int64)[:, None, None]
    zone = torch.zeros((dx.shape[0], h, w), dtype=torch.bool, device=dev)
    for ex, ey, ew, eh in rects.tolist():
        zone |= (
            (xs >= ex + dxe) & (xs < ex + ew + dxe)
            & (ys >= ey + dye) & (ys < ey + eh + dye)
        )
    for cx, cy, r in circles.tolist():
        if r > 0:
            zone |= (xs - (cx + dxe)) ** 2 + (ys - (cy + dye)) ** 2 <= r * r
    return zone


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------


def _median_k(defect: DefectParams) -> int:
    k = int(defect.median_k)
    return k + 1 if k % 2 == 0 else k


def _morph_k(seg: SegmentationParams) -> int:
    """Effective morph kernel size (0/1 disables, segmentation.py:91-93)."""
    if not (seg.morph_kernel and seg.morph_kernel > 0):
        return 1
    return max(1, int(seg.morph_kernel))


# Units above this many pixels take the whole-image route. A 315x316 grid
# unit (99.5 kpx) stays on kernels A and C, whose one CTA per unit suits
# many small units; a whole 4096x3000 capture (12.3 Mpx) is one unit, which
# would run on one of the card's 132 SMs there. A fixed gate, not a
# setting: only the tests lower it, to drive the route at small sizes.
WHOLE_MIN_PX = 1 << 20


def _whole_route(h: int, w: int) -> bool:
    """Whether an h x w unit takes the whole-image route: above
    ``WHOLE_MIN_PX`` pixels, or too large for kernel A's or C's int32 sums.
    A fixed gate on the shape, the same on every device."""
    return h * w > WHOLE_MIN_PX or not (seg_tail_fits(h, w) and blob_filter_fits(h, w))


def _whole_tail(x, stages=(), fill=False, out_largest=False, thr=None, *, err=None):
    """:func:`ops.fused.seg_tail`'s contract on the whole-image route
    (kernels D, E and F on whole planes), with int64 stats: the port of the
    JAX package's ``raw_segment`` + ``largest_component_sums`` and
    ``_defect_roi_fallback``. ``err``: the bound flag kernels D, E and F
    set, read by the caller; without one each launch reads its own. Spans:
    ``whole.mask`` (the compare and kernel I), ``whole.fill``, ``whole.label``,
    ``whole.stats`` (kernel F and the output plane)."""
    with span("whole.mask"):
        m = tail_mask(x, stages, thr, chain=morph_chain)
    if fill:
        with span("whole.fill"):
            m = m | ~exterior_background(m, err=err)
    with span("whole.label"):
        labels = label_components(m, err=err)
    with span("whole.stats"):
        best, stats = component_stats(labels, m, err=err)
        out = best if out_largest else m
        return out.to(torch.uint8) * 255, stats


def _whole_blobs(fg, max_x2, *, min_x2: int, roi=None, pre_open=False, err=None):
    """:func:`ops.blob.blob_filter`'s contract on the whole-image route (the
    port of ``contour.filter_and_select`` at whole-image size): the fill
    regions (:func:`tpu_inspect_torch.ops.contour.fill_regions`), then
    kernel G for the Green's filter and the paint. ``err`` as for
    :func:`_whole_tail`. Spans: ``whole.mask`` (the ROI AND and kernel I's
    open), ``whole.regions`` (kernels D, E, the seed plane, D),
    ``whole.select`` (kernel G)."""
    with span("whole.mask"):
        m = candidate_mask(fg, roi, pre_open, chain=morph_chain)
    with span("whole.regions"):
        regions = fill_regions(m, err)
    with span("whole.select"):
        return blob_select(*regions, max_x2, min_x2=min_x2, err=err)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array on ``dev`` without waiting for the copy: through
    pinned memory, non-blocking, on the card (the allocator keeps the pinned
    block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _seg_mask(crops, seg, err=None):
    """The pre-exclusion segmentation of [U, H, W] crops: Gaussian, Otsu (or
    the adaptive threshold), close+open, hole fill -> (mask u8 0/255, stats
    [U, 8]: int32 from kernel A, int64 on the whole-image route). ``err``:
    the bound flag the tail's kernels set
    (:func:`tpu_inspect_torch.kernels.error_flag`), read by the caller;
    without one each launch reads its own."""
    with span("seg.head"):
        x = crops
        if seg.gaussian_blur and seg.gaussian_blur > 0:
            x = gaussian_blur_u8(x, as_odd(seg.gaussian_blur))
        if seg.method == "adaptive":
            # the adaptive plane is already 0/255: the tail binarizes x > 0
            bs = max(3, int(seg.adapt_block) | 1)
            x, thr = adaptive_threshold_inv(x, bs, int(seg.adapt_C)), None
        else:
            thr = otsu_threshold(x)
    with span("seg.tail"):
        k = _morph_k(seg)
        stages = close_open_stages(k) if k > 1 else ()
        tail = _whole_tail if _whole_route(*crops.shape[1:]) else seg_tail
        return tail(x, stages=stages, fill=True, out_largest=False, thr=thr, err=err)


def _segment(crops, seg, exclusions, ref_centroids, is_reference, err=None):
    """Segmentation pass on [U, H, W] crops -> (mask u8, sums [U,3] int64,
    has_fg [U] bool, shifts [U,2] int32), all on the crops' device. ``err``
    as for :func:`_seg_mask`."""
    u, h, w = crops.shape
    dev = crops.device
    mask, st = _seg_mask(crops, seg, err)
    with span("seg.align"):
        rects, circles = pack_exclusions(exclusions)
        area, sx, sy = st[:, 0], st[:, 1], st[:, 2]
        has_fg = st[:, 3] > 0

        if is_reference:
            dx = torch.zeros((u,), dtype=torch.int32, device=dev)
            dy = torch.zeros((u,), dtype=torch.int32, device=dev)
        else:
            # dx, dy = int(round(c1 - c0)) with Python's banker's rounding
            # (indexing_ui.py:2310-2311); torch.round rounds half to even
            cnt = area.clamp(min=1).to(torch.float64)
            centroid = torch.stack(
                [sx.to(torch.float64) / cnt, sy.to(torch.float64) / cnt], dim=-1
            )
            ref, ok = _anchor_tensors(anchor_key(ref_centroids), u, str(dev))
            ok = ok & has_fg
            delta = torch.round(centroid - ref).to(torch.int32)
            dx = torch.where(ok, delta[:, 0], 0).to(torch.int32)
            dy = torch.where(ok, delta[:, 1], 0).to(torch.int32)

        if rects.shape[0] or circles.shape[0]:
            # on the reference image every shift is 0, so the zone is
            # unit-invariant: rasterize it once at [1, H, W] and broadcast
            zone = (
                exclusion_zone((h, w), rects, circles, dx[:1], dy[:1])
                if is_reference
                else exclusion_zone((h, w), rects, circles, dx, dy)
            )
            mask = torch.where(zone, torch.zeros_like(mask), mask)
        sums = torch.stack([sx, sy, area], dim=-1).to(torch.int64)
        return mask, sums, has_fg, torch.stack([dx, dy], dim=-1)


def _defect_roi(seg_masks, erode_px: int, err=None):
    """ROI: binarize, (2n+1)^2 erode (n = ``erode_px``), largest 8-CC (holes
    kept) -> (roi u8, stats [U, 8], int32 from kernel A, int64 on the
    whole-image route) (indexing_ui.py:1480-1516)."""
    with span("defect.roi"):
        tail = _whole_tail if _whole_route(*seg_masks.shape[1:]) else seg_tail
        return tail(
            seg_masks, stages=rect_erode_stages(erode_px), fill=False, out_largest=True, err=err,
        )


def _candidates(crops, params: DefectParams, roi_stats=None, err=None):
    """Pre-ROI candidate plane: the median residual over the ROI rows (the
    row bounds of ``roi_stats``; every row without it), or Canny edges
    (indexing_ui.py:1519-1539). A median window of k*k >= 2048 takes the
    full median blur (kernel H) over every row, and THRESH_BINARY of
    |x - bg| (``engine.py:461-465`` of the JAX package). ``err``: the bound
    flag of Canny's kernel D."""
    with span("defect.cand"):
        thr = int(params.threshold)
        if params.method == "canny":
            return canny_u8(crops, max(1, thr // 2), max(2, thr), err=err)
        k = _median_k(params)
        if k * k >= 2048:
            bg = median_blur_u8(crops, k)
            return threshold_binary((crops.to(torch.int16) - bg.to(torch.int16)).abs(), thr)
        if roi_stats is None:
            return median_residual_mask(crops, k, thr)
        return median_residual_mask(
            crops, k, thr,
            row_lo=roi_stats[:, 4].to(torch.int32).contiguous(),
            row_hi=roi_stats[:, 5].to(torch.int32).contiguous(),
        )


def _defect_tail(cand, roi, roi_stats, params: DefectParams, whole: bool, err=None):
    """Defect pass given the pre-ROI candidates, the ROI and its stats row
    ([U, 8]: area, ..., row bounds) -> (masks u8, found bool, area, verdict
    bool): kernel C, or with ``whole`` the whole-image route's
    :func:`_whole_blobs` (indexing_ui.py:1519-1572, :1669-1700)."""
    with span("defect.filter"):
        roi_area = roi_stats[:, 0]
        # max_area = max(min_area, int(roi_area * 0.98)): truncation of the
        # double product; the filter compares exact 2x contour areas
        min_area = int(params.min_area)
        max_area = torch.clamp(
            torch.floor(roi_area.to(torch.float64) * float(params.max_area_frac)),
            min=min_area,
        ).to(torch.int32)
        filt = _whole_blobs if whole else blob_filter
        out, area = filt(
            cand, (2 * max_area).contiguous(), min_x2=2 * min_area, roi=roi,
            pre_open=params.method == "threshold", err=err,
        )
        found = area > 0
        verdict = found & (area >= min_area)
        return out, found, area, verdict


def _defect_from_roi(crops, roi, roi_stats, params: DefectParams, err=None):
    """Defect pass given the ROI and its stats row, from :func:`_defect_roi`
    or kernel K -> (masks u8, found bool, area int32, verdict bool)."""
    return _defect_tail(_candidates(crops, params, roi_stats, err), roi, roi_stats, params,
                        _whole_route(*crops.shape[1:]), err)


def _defect(crops, seg_masks, params: DefectParams, err=None):
    """Defect pass -> (masks u8, found bool, area int32, verdict bool)
    (indexing_ui.py:1471-1572, :1669-1700)."""
    return _defect_from_roi(crops, *_defect_roi(seg_masks, params.erode_px, err), params, err)


# Read ONCE at import, as the JAX package reads it: set the variable before
# importing, or set this attribute. Off by default, so the split path stays
# the default.
_ENABLE_CHAIN = bool(os.environ.get("TPU_INSPECT_ENABLE_CHAIN"))


def _seg_roi_chain_fits(crops_shape, seg: SegmentationParams) -> bool:
    """Whether the reference capture's seg and ROI tails may run chained in
    kernel K: the chain flag is set, the method is otsu (K fuses the Otsu
    threshold's compare) and the unit is not on the whole-image route. K
    runs any stage program on one unit's own plane, so the TPU kernel's
    reach limits (its two-unit lane pairing) do not gate it."""
    return _ENABLE_CHAIN and seg.method == "otsu" and not _whole_route(*crops_shape[1:])


def _segment_roi(crops, seg: SegmentationParams, exclusions, erode_px: int, err=None):
    """Reference-capture segmentation and the defect ROI chained in kernel K
    (the port of the JAX package's ``_segment_roi_device``): Gaussian, Otsu,
    then K with the exclusion zone rasterized once at zero shift. Returns
    the :func:`_segment` tuple and (ROI u8, ROI stats [U, 8] int32)."""
    u, h, w = crops.shape
    with span("seg.head"):
        x = crops
        if seg.gaussian_blur and seg.gaussian_blur > 0:
            x = gaussian_blur_u8(x, as_odd(seg.gaussian_blur))
        thr = otsu_threshold(x)
    with span("seg.align"):
        rects, circles = pack_exclusions(exclusions)
        zone = None
        if rects.shape[0] or circles.shape[0]:
            z = torch.zeros((1,), dtype=torch.int32, device=crops.device)
            zone = exclusion_zone((h, w), rects, circles, z, z)[0]
        shifts = torch.zeros((u, 2), dtype=torch.int32, device=crops.device)
    with span("seg.tail"):
        k = _morph_k(seg)
        stages = close_open_stages(k) if k > 1 else ()
        mask, st, roi, roi_st = seg_roi_tail(
            x, stages, rect_erode_stages(erode_px), thr, zone, err=err
        )
        sums = torch.stack([st[:, 1], st[:, 2], st[:, 0]], dim=-1).to(torch.int64)
        return (mask, sums, st[:, 3] > 0, shifts), (roi, roi_st)


def _frame_key(image, origins, unit_hw, seg: SegmentationParams, defect: DefectParams,
               exclusions, ref_centroids, is_reference: bool, with_defects: bool,
               route: str):
    """Everything one capture's program bakes in, as a hashable key: the
    image's shape, dtype and device, the current stream, ``origins`` (by
    identity and its count of in-place writes), ``unit_hw``, the validated
    parameters, the packed exclusions, the anchors' values (off the
    reference), ``is_reference``, ``with_defects``, the route and the chain
    flag. None where the program cannot be keyed: ``origins`` not on the
    image's device, or a tensor that counts no writes (an inference
    tensor)."""
    dev = image.device
    if origins.device != dev:
        return None
    try:
        version = origins._version
    except RuntimeError:
        return None
    rects, circles = pack_exclusions(exclusions)
    return (
        tuple(image.shape), image.dtype, dev,
        torch.cuda.current_stream(dev.index).cuda_stream if dev.type == "cuda" else None,
        id(origins), version, tuple(unit_hw), seg, defect,
        rects.tobytes(), circles.tobytes(),
        None if is_reference else anchor_key(ref_centroids),
        bool(is_reference), bool(with_defects), route, _ENABLE_CHAIN,
    )


def _program(image, origins, unit_hw, seg, defect, exclusions, ref_centroids,
             is_reference, with_defects, chained, err):
    """The body of :func:`_inspect_image_device`, on one route."""
    with span("gather"):
        crops = gather_crops(image, origins, unit_hw)
    if chained:
        seg_out, (roi, roi_st) = _segment_roi(
            crops, seg, exclusions, int(defect.erode_px), err
        )
        return seg_out + (_defect_from_roi(crops, roi, roi_st, defect, err),)
    seg_out = _segment(crops, seg, exclusions, ref_centroids, is_reference, err)
    if not with_defects:
        return seg_out + (None,)
    return seg_out + (_defect(crops, seg_out[0], defect, err),)


def _inspect_image_device(image, origins, unit_hw, seg: SegmentationParams,
                          defect: DefectParams, exclusions=(), ref_centroids=None,
                          is_reference: bool = True, with_defects: bool = True,
                          err=None):
    """One capture's program, tensors in and device tensors out (no host
    copy of any result): image [H, W] uint8 and origins [U, 2] on the
    device -> (masks u8, sums [U, 3] int64, has_fg, shifts [U, 2] int32,
    (defect masks, found, area, verdict) or None without defects). The
    port of the JAX package's ``_inspect_image_device``; ``seg`` and
    ``defect`` are validated by the caller. With ``err`` (a
    :func:`tpu_inspect_torch.kernels.error_flag`) every kernel with a bound
    (A, C, K; D, E, F, G on the whole-image route; Canny's D) sets it
    instead of being read one by one, and the caller reads it where it
    copies the results out: the program then waits for the card nowhere.

    On the card, a call with ``err`` (on any route) is a frame of
    :data:`tpu_inspect_torch.graphs.FRAMES` under
    :func:`_frame_key`: the first two calls of a key run eagerly, the third
    captures the program into a CUDA graph, and every later one replays it
    (one copy of the image in, one launch, the flag merged into ``err``).
    The outputs are the same bits either way, and fresh tensors: the
    caller's own, which a later call never writes. CPU tensors and calls
    without ``err`` run eagerly.

    Each call is the root span of one frame
    (:mod:`tpu_inspect_torch.utils.trace`), named by its route:
    ``frame.chained``, ``frame.whole`` or ``frame.split``; a replay opens
    ``graph.replay`` inside it, a capture ``graph.capture``."""
    shape = (len(origins), *unit_hw)
    chained = with_defects and is_reference and _seg_roi_chain_fits(shape, seg)
    route = "frame.chained" if chained else "frame.whole" if _whole_route(*unit_hw) else (
        "frame.split")

    def program(img, flag):
        return _program(img, origins, unit_hw, seg, defect, exclusions, ref_centroids,
                        is_reference, with_defects, chained, flag)

    with span(route):
        if image.device.type != "cuda":
            return program(image, err)
        key = None if err is None else _frame_key(
            image, origins, unit_hw, seg, defect, exclusions, ref_centroids, is_reference,
            with_defects, route)
        return FRAMES.run(key, image, err, program, keep=(origins,))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _seg_result(mask, sums, has_fg, shifts) -> SegmentationResult:
    return SegmentationResult(
        masks=_to_numpy(mask),
        centroids=centroids_from_sums(_to_numpy(sums)),
        centroid_valid=_to_numpy(has_fg),
        shifts=_to_numpy(shifts),
    )


def _insp_result(masks, found, area, verdict, areas_dtype=np.int32) -> InspectionResult:
    return InspectionResult(
        defect_masks=_to_numpy(masks),
        valid=_to_numpy(found),
        areas=_to_numpy(area).astype(areas_dtype),
        verdicts=_to_numpy(verdict),
    )


def _as_u8(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise ValueError(f"expected a uint8 tensor, got {x.dtype}")
        return x.to(dev).contiguous()
    a = np.ascontiguousarray(x, dtype=np.uint8)
    if not a.flags.writeable:  # torch wraps only writeable arrays
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def defect_intermediates(crop, seg_mask, params: DefectParams,
                         device: str | torch.device = "cuda") -> dict:
    """Per-stage diagnostic scalars for ONE unit, the reference's verbose
    debug channel (indexing_ui.py:1494, :1535, :1549-1557); the port of
    :func:`tpu_inspect.engine.defect_intermediates`.

    ``crop`` and ``seg_mask`` are [H, W] uint8. Returns {'seg_area0',
    'erode_px', 'roi_empty', 'roi_area', 'resid_area' (threshold method
    only), 'min_area', 'max_area', 'skipped_large' (sorted int contour
    areas a with a >= min_area and a > max_area)}; 'resid_area' and
    'skipped_large' only when the ROI is not empty.
    """
    dev = resolve_device(device)
    params = params.validated()
    crops = _as_u8(crop, dev)[None]
    masks = _as_u8(seg_mask, dev)[None]
    out = {
        "seg_area0": int((masks > 0).sum()),
        "erode_px": int(params.erode_px),
        "min_area": int(params.min_area),
    }
    # one bound flag for every kernel of the pass, read before it returns
    err = error_flag(dev)
    roi, st = _defect_roi(masks, params.erode_px, err)
    roi_area, _, _, has_fg = st[0, :4].tolist()
    out["roi_empty"] = has_fg == 0
    out["roi_area"] = int(roi_area)
    # max_area = max(min_area, int(roi_area * 0.98)) with Python-int
    # truncation of the double product (indexing_ui.py:1548-1549)
    out["max_area"] = max(
        out["min_area"], int(out["roi_area"] * float(params.max_area_frac))
    )
    if out["roi_empty"]:
        build.check_bounded("defect_intermediates", err)
        return out
    # the ROI AND, and the threshold method's 3x3 open: kernel I on the card
    pre_open = params.method == "threshold"
    cand = candidate_mask(_candidates(crops, params, st, err), roi, pre_open, chain=morph_chain)
    if pre_open:
        out["resid_area"] = int(cand.sum())
    analysis = analyze_blobs(cand, err=err)
    build.check_bounded("defect_intermediates", err)
    a2 = _to_numpy(analysis.contour_area_x2[0])
    roots = _to_numpy(analysis.is_root[0])
    areas = (a2[roots] // 2).astype(int)  # int(contourArea): a2 is exact 2x
    out["skipped_large"] = sorted(
        int(a) for a in areas if a >= out["min_area"] and a > out["max_area"]
    )
    return out


def _crops_tensor(crops, name: str) -> torch.Tensor:
    """Raise unless ``crops`` is a [U, H, W] uint8 tensor; its contiguous
    form."""
    if not isinstance(crops, torch.Tensor) or crops.dtype != torch.uint8 or crops.ndim != 3:
        raise ValueError(f"{name}: expected a [U, H, W] uint8 tensor, got {crops!r:.80}")
    return crops.contiguous()


def raw_segment(crops: torch.Tensor, seg: SegmentationParams) -> torch.Tensor:
    """Pre-exclusion segmentation chain (segment_cell parity,
    segmentation.py:75-100; the port of
    :func:`tpu_inspect.engine.raw_segment`): [U, H, W] uint8 crops ->
    [U, H, W] uint8 0/255 masks on the crops' device (Gaussian, Otsu or the
    adaptive threshold, close+open, hole fill: kernel A, or the whole-image
    route's kernels D, E and F). The bound flag is read once, at the end."""
    crops = _crops_tensor(crops, "raw_segment")
    err = error_flag(crops.device)
    mask, _ = _seg_mask(crops, seg.validated(), err)
    build.check_bounded("raw_segment", err)
    return mask


def defect_roi(seg_masks: torch.Tensor, erode_px: int):
    """ROI prep (indexing_ui.py:1480-1516; the port of
    :func:`tpu_inspect.engine.defect_roi`): binarize the [U, H, W] uint8 seg
    masks, erode ``erode_px`` iterations of a 3x3 rect, keep the largest
    8-connected component (holes kept). Returns (roi [U, H, W] bool,
    roi_empty [U] bool) on the masks' device. The bound flag is read once,
    at the end."""
    seg_masks = _crops_tensor(seg_masks, "defect_roi")
    err = error_flag(seg_masks.device)
    roi, st = _defect_roi(seg_masks, int(erode_px), err)
    build.check_bounded("defect_roi", err)
    return roi > 0, st[:, 3] == 0


def segment_units(crops, seg: SegmentationParams, exclusions=(),
                  ref_centroids=None, is_reference: bool = True,
                  device: str | torch.device = "cuda") -> SegmentationResult:
    """Batched segmentation pass (run_segmentation_all parity) on [U, H, W]
    uint8 crops. On the reference image the returned centroids become the
    alignment anchors; on other captures pass them back via
    ``ref_centroids`` (array [U, 2] or {idx: (cx, cy)} dict)."""
    dev = resolve_device(device)
    seg = seg.validated()
    err = error_flag(dev)
    out = _segment(_as_u8(crops, dev), seg, exclusions, ref_centroids, bool(is_reference), err)
    build.check_bounded("segment_units", err)
    return _seg_result(*out)


def detect_defects_batch(crops, seg_masks, params: DefectParams,
                         device: str | torch.device = "cuda") -> InspectionResult:
    """Batched _detect_defects_on_pix + verdicts (indexing_ui.py:1471-1572,
    :1669-1700)."""
    dev = resolve_device(device)
    params = params.validated()
    err = error_flag(dev)
    out = _defect(_as_u8(crops, dev), _as_u8(seg_masks, dev), params, err)
    build.check_bounded("detect_defects_batch", err)
    return _insp_result(*out)


def inspect_units(crops, seg: SegmentationParams, defect: DefectParams,
                  exclusions=(), ref_centroids=None, is_reference: bool = True,
                  device: str | torch.device = "cuda"):
    """Segmentation pass + defect pass + X/O verdicts on [U, H, W] crops
    (run_inspection parity, indexing_ui.py:1634-1709)."""
    dev = resolve_device(device)
    seg, defect = seg.validated(), defect.validated()
    crops_t = _as_u8(crops, dev)
    err = error_flag(dev)
    seg_out = _segment(crops_t, seg, exclusions, ref_centroids, bool(is_reference), err)
    insp_out = _defect(crops_t, seg_out[0], defect, err)
    build.check_bounded("inspect_units", err)
    return _seg_result(*seg_out), _insp_result(*insp_out)


def inspect_image(image, grid: GridParams, seg: SegmentationParams,
                  defect: DefectParams | None = None, exclusions=(),
                  ref_centroids=None, is_reference: bool = True,
                  device: str | torch.device = "cuda"):
    """Full-image inspection: the raw [H, W] uint8 image to per-unit masks,
    defect blobs and X/O verdicts in one pass on ``device`` (the port of
    :func:`tpu_inspect.engine.inspect_image`; run_segmentation_all +
    run_inspection parity, indexing_ui.py:2203-2368, :1634-1709).

    Returns (SegmentationResult, InspectionResult or None when ``defect``
    is None)."""
    dev = resolve_device(device)
    origins = origins_on(grid, str(dev))
    _, _, w, h = grid.base_unit
    err = error_flag(dev)
    out = _inspect_image_device(
        _as_u8(image, dev), origins, (int(h), int(w)), seg.validated(),
        (defect or DefectParams()).validated(), exclusions, ref_centroids,
        bool(is_reference), defect is not None, err,
    )
    build.check_bounded("inspect_image", err)
    if out[4] is None:
        return _seg_result(*out[:4]), None
    return _seg_result(*out[:4]), _insp_result(*out[4], areas_dtype=np.int64)
