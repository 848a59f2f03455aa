"""Headless overlay rendering (reference UI visual semantics, no Qt).

Reproduces what the reference paints, as numpy RGB(A) arrays:

- mask tinting: seg green / defect red with the reference's alpha values
  (_tint_mask_pixmap, indexing_ui.py:2468-2492; canvas overlays use
  seg alpha 140 / defect alpha 180, :2397-2399; selected-cell overlays use
  200/220, :2533-2535; combined view 160/200, :2504-2506),
- canvas composition at 0.55 opacity for all-cell overlays and 0.6 for the
  selected cell (paintEvent, :292, :335),
- X/O inspection markers: red X / green O centered per cell, sized
  0.45*min(cell w, h) (:255-287) — glyphs are drawn vectorially here
  rather than with Qt's font engine,
- erosion outline: boundary of the largest component of the eroded seg
  mask, cyan (update_erosion_outline, :2544-2618).

These are display artifacts (the reference never exports them), so the
goal is semantic fidelity (same colors, alphas, geometry), not bit-equal
pixels with Qt's painter.

A copy of :mod:`tpu_inspect.render`: the overlays, markers and thumbnails
are the same numpy code; the erosion outline runs on ``device`` through
kernel I (the erodes, ``ops.morphology.morph_chain``) and kernel J (the
largest component, ``ops.cc.largest_component_sums``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_inspect_torch.config import GridParams
from tpu_inspect_torch.device import resolve_device
from tpu_inspect_torch.geometry import grid_boxes
from tpu_inspect_torch.kernels import build, error_flag
from tpu_inspect_torch.ops.cc import largest_component_sums
from tpu_inspect_torch.ops.morphology import morph_chain, rect_erode_stages

SEG_COLOR = (0, 255, 0)
DEFECT_COLOR = (255, 0, 0)
CANVAS_SEG_ALPHA = 140
CANVAS_DEFECT_ALPHA = 180
SELECTED_SEG_ALPHA = 200
SELECTED_DEFECT_ALPHA = 220
COMBINED_SEG_ALPHA = 160
COMBINED_DEFECT_ALPHA = 200
CANVAS_OPACITY = 0.55
SELECTED_OPACITY = 0.6
GRID_COLOR = (255, 255, 0)
OUTLINE_COLOR = (0, 255, 255)


def tint_mask(mask: np.ndarray, color=DEFECT_COLOR, alpha: int = 200) -> np.ndarray:
    """uint8 mask -> RGBA [H, W, 4]: color where mask > 0, transparent else."""
    h, w = mask.shape
    out = np.zeros((h, w, 4), dtype=np.uint8)
    out[..., 0] = color[0]
    out[..., 1] = color[1]
    out[..., 2] = color[2]
    out[..., 3] = np.where(mask > 0, np.uint8(alpha), np.uint8(0))
    return out


def combine_masks(
    seg_mask: np.ndarray | None, defect_mask: np.ndarray | None
) -> np.ndarray | None:
    """Combined seg(green a160) + defect(red a200) RGBA overlay
    (_combine_mask_pixmaps)."""
    if seg_mask is None and defect_mask is None:
        return None
    ref = seg_mask if seg_mask is not None else defect_mask
    out = np.zeros(ref.shape + (4,), dtype=np.uint8)
    if seg_mask is not None:
        out = _source_over(out, tint_mask(seg_mask, SEG_COLOR, COMBINED_SEG_ALPHA))
    if defect_mask is not None:
        out = _source_over(
            out, tint_mask(defect_mask, DEFECT_COLOR, COMBINED_DEFECT_ALPHA)
        )
    return out


def _source_over(dst_rgba: np.ndarray, src_rgba: np.ndarray, opacity=1.0) -> np.ndarray:
    """Porter-Duff source-over with an extra painter opacity."""
    sa = src_rgba[..., 3:4].astype(np.float32) / 255.0 * float(opacity)
    da = dst_rgba[..., 3:4].astype(np.float32) / 255.0
    oa = sa + da * (1 - sa)
    safe = np.maximum(oa, 1e-6)
    rgb = (
        src_rgba[..., :3].astype(np.float32) * sa
        + dst_rgba[..., :3].astype(np.float32) * da * (1 - sa)
    ) / safe
    out = np.zeros_like(dst_rgba)
    out[..., :3] = np.clip(np.rint(rgb), 0, 255).astype(np.uint8)
    out[..., 3] = np.clip(np.rint(oa[..., 0] * 255.0), 0, 255).astype(np.uint8)
    return out


def _blend_onto_rgb(base_rgb: np.ndarray, src_rgba: np.ndarray, opacity=1.0) -> np.ndarray:
    sa = src_rgba[..., 3:4].astype(np.float32) / 255.0 * float(opacity)
    out = base_rgb.astype(np.float32) * (1 - sa) + src_rgba[..., :3].astype(np.float32) * sa
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _to_rgb(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2:
        return np.repeat(image[..., None], 3, axis=2).copy()
    return image.copy()


def _draw_rect_border(rgb: np.ndarray, x, y, w, h, color, thickness=1):
    H, W = rgb.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    t = thickness
    if x1 <= x0 or y1 <= y0:
        return
    rgb[y0 : min(y0 + t, y1), x0:x1] = color
    rgb[max(y1 - t, y0) : y1, x0:x1] = color
    rgb[y0:y1, x0 : min(x0 + t, x1)] = color
    rgb[y0:y1, max(x1 - t, x0) : x1] = color


def render_canvas(
    image: np.ndarray,
    grid: GridParams,
    seg_masks=None,
    defect_masks=None,
    mode: str = "Defect",
    selected: int | None = None,
    draw_grid: bool = True,
) -> np.ndarray:
    """Full-canvas rendering: grid rects + per-cell overlays (paintEvent
    semantics). ``seg_masks``/``defect_masks`` are [U, h, w] arrays or
    per-unit lists with None entries. Returns RGB uint8."""
    rgb = _to_rgb(image)
    boxes = grid_boxes(grid)

    def mask_at(masks, i):
        if masks is None:
            return None
        m = masks[i]
        return None if m is None else np.asarray(m)

    H, W = rgb.shape[:2]
    if mode != "None":
        for i, (x, y, w, h) in enumerate(boxes):
            opacity = SELECTED_OPACITY if i == selected else CANVAS_OPACITY
            seg_a = SELECTED_SEG_ALPHA if i == selected else CANVAS_SEG_ALPHA
            def_a = SELECTED_DEFECT_ALPHA if i == selected else CANVAS_DEFECT_ALPHA
            # clip to image bounds (the reference's QImage.copy pads
            # out-of-bounds crops; here the overlay is simply clipped)
            x0, y0 = max(0, x), max(0, y)
            x1, y1 = min(W, x + w), min(H, y + h)
            if x1 <= x0 or y1 <= y0:
                continue
            sub = rgb[y0:y1, x0:x1]
            my0, mx0 = y0 - y, x0 - x
            my1, mx1 = my0 + (y1 - y0), mx0 + (x1 - x0)
            if mode in ("Segmentation", "Both"):
                m = mask_at(seg_masks, i)
                if m is not None:
                    tint = tint_mask(m, SEG_COLOR, seg_a)[my0:my1, mx0:mx1]
                    sub[:] = _blend_onto_rgb(sub, tint, opacity)
            if mode in ("Defect", "Both"):
                m = mask_at(defect_masks, i)
                if m is not None:
                    tint = tint_mask(m, DEFECT_COLOR, def_a)[my0:my1, mx0:mx1]
                    sub[:] = _blend_onto_rgb(sub, tint, opacity)
    if draw_grid:
        for x, y, w, h in boxes:
            _draw_rect_border(rgb, x, y, w, h, GRID_COLOR, 1)
    return rgb


def _draw_line(rgb, x0, y0, x1, y1, color, thickness=3):
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    H, W = rgb.shape[:2]
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xx = np.clip(xs + dx, 0, W - 1)
            yy = np.clip(ys + dy, 0, H - 1)
            rgb[yy, xx] = color


def render_inspection(
    image: np.ndarray, grid: GridParams, verdicts: dict[int, bool] | np.ndarray
) -> np.ndarray:
    """Inspection view: red X (NG) / green O (OK) centered per cell, sized
    0.45*min(w, h); units without a verdict get no marker (:262-285)."""
    rgb = _to_rgb(image)
    boxes = grid_boxes(grid)
    for x, y, w, h in boxes:
        _draw_rect_border(rgb, x, y, w, h, GRID_COLOR, 1)
    vd = (
        verdicts
        if isinstance(verdicts, dict)
        else {i: bool(v) for i, v in enumerate(verdicts)}
    )
    for i, (x, y, w, h) in enumerate(boxes):
        if i not in vd or vd[i] is None:
            continue
        s = max(10.0, min(w, h) * 0.45)
        cx, cy = x + w / 2, y + h / 2
        half = s / 2
        if vd[i]:  # NG -> red X
            _draw_line(rgb, cx - half, cy - half, cx + half, cy + half, DEFECT_COLOR)
            _draw_line(rgb, cx - half, cy + half, cx + half, cy - half, DEFECT_COLOR)
        else:  # OK -> green O
            ang = np.linspace(0, 2 * np.pi, max(16, int(2 * np.pi * half)))
            xs = cx + half * np.cos(ang)
            ys = cy + half * np.sin(ang)
            for j in range(len(ang) - 1):
                _draw_line(rgb, xs[j], ys[j], xs[j + 1], ys[j + 1], SEG_COLOR)
    return rgb


def erosion_outline_mask(
    seg_mask: np.ndarray, erode_px: int, device: str | torch.device = "cuda"
) -> np.ndarray | None:
    """Boundary pixels of the largest component of the eroded seg mask
    (update_erosion_outline, indexing_ui.py:2544-2618). Returns a host bool
    [h, w] outline mask, or None when the eroded mask is empty.

    On ``device``: the (2n+1)^2 erode (kernel I), the largest component
    (kernel J), the 1-px inner erode (kernel I again). J's bound flag is
    read with its has_fg in one copy."""
    dev = resolve_device(device)
    m = torch.from_numpy(np.asarray(seg_mask) > 0)[None].to(dev)
    m = morph_chain(m, rect_erode_stages(int(erode_px)))
    flag = error_flag(dev)
    largest, stats = largest_component_sums(m, err=flag)
    has, code = torch.stack((stats[0, 3], flag[0].to(torch.int64))).tolist()
    build.check_flag("erosion_outline_mask", code)
    if not has:
        return None
    inner = morph_chain(largest, rect_erode_stages(1))
    return (largest[0] & ~inner[0]).cpu().numpy()


def erosion_inset_rect(
    box: tuple[int, int, int, int], erode_px: int
) -> tuple[int, int, int, int] | None:
    """No-mask fallback for the erosion outline (indexing_ui.py:2555-2567):
    the unit rect inset by erode_px on all sides, in image coordinates;
    None when the inset collapses."""
    ux, uy, uw, uh = (int(v) for v in box)
    e = int(erode_px)
    inw, inh = max(0, uw - 2 * e), max(0, uh - 2 * e)
    if inw <= 0 or inh <= 0:
        return None
    return (ux + e, uy + e, inw, inh)


def erosion_outline(
    seg_mask: np.ndarray | None,
    box: tuple[int, int, int, int],
    erode_px: int,
    device: str | torch.device = "cuda",
):
    """Selected-unit erosion preview (update_erosion_outline,
    indexing_ui.py:2544-2618): with a seg mask, the largest-component
    boundary as ('mask', bool [h, w] in unit-local coords), computed on
    ``device``; without one, the inset-rectangle fallback as ('rect', (x, y,
    w, h) image coords); None when neither produces anything."""
    if seg_mask is None:
        rect = erosion_inset_rect(box, erode_px)
        return None if rect is None else ("rect", rect)
    outline = erosion_outline_mask(seg_mask, erode_px, device)
    return None if outline is None else ("mask", outline)


# ---------------------------------------------------------------------------
# Thumbnail icons (refresh_thumbnail_icons, indexing_ui.py:2408-2445)
# ---------------------------------------------------------------------------


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Separable bilinear resize (Qt SmoothTransformation analogue)."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (oh, ow):
        return img.astype(np.float32)
    ys = (np.arange(oh) + 0.5) * ih / oh - 0.5
    xs = (np.arange(ow) + 0.5) * iw / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    im = img.astype(np.float32)
    if im.ndim == 2:
        fy2, fx2 = fy, fx
        top = im[y0][:, x0] * (1 - fx2) + im[y0][:, x1] * fx2
        bot = im[y1][:, x0] * (1 - fx2) + im[y1][:, x1] * fx2
        return top * (1 - fy2) + bot * fy2
    fy3, fx3 = fy[..., None], fx[..., None]
    top = im[y0][:, x0] * (1 - fx3) + im[y0][:, x1] * fx3
    bot = im[y1][:, x0] * (1 - fx3) + im[y1][:, x1] * fx3
    return top * (1 - fy3) + bot * fy3


def thumbnail_icon(
    crop: np.ndarray,
    seg_mask: np.ndarray | None = None,
    defect_mask: np.ndarray | None = None,
    mode: str = "Defect",
    size: int = 128,
) -> np.ndarray:
    """Per-unit 128-px overlay icon (refresh_thumbnail_icons,
    indexing_ui.py:2408-2445): crop scaled keep-aspect to ``size``, then the
    seg (green) / defect (red) masks scaled to the icon, binarized > 0 after
    the smooth scale, tinted at alpha 200 and painted at 0.5 opacity
    (_make_overlay_pixmap :2447-2466). Returns RGB uint8."""
    ih, iw = crop.shape[:2]
    scale = min(size / iw, size / ih)
    ow, oh = max(1, int(iw * scale)), max(1, int(ih * scale))
    base = np.clip(np.rint(_resize_bilinear(crop, oh, ow)), 0, 255).astype(
        np.uint8
    )
    rgb = _to_rgb(base)
    if mode == "None":
        return rgb

    def paint(mask, color):
        scaled = _resize_bilinear(np.asarray(mask), oh, ow)
        binary = (scaled > 0).astype(np.uint8) * 255
        return _blend_onto_rgb(rgb, tint_mask(binary, color, 200), 0.5)

    if mode in ("Segmentation", "Both") and seg_mask is not None:
        rgb = paint(seg_mask, SEG_COLOR)
    if mode in ("Defect", "Both") and defect_mask is not None:
        rgb = paint(defect_mask, DEFECT_COLOR)
    return rgb
