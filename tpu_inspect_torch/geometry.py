"""Grid-indexing and exclusion geometry (pure host-side integer math).

Copy of :mod:`tpu_inspect.geometry`'s ``BoxGrid``, ``grid_boxes``,
``grid_origins``, ``infer_grid_params``, ``exclusion_from_drawn_rect``,
``clamp_exclusion_to_base_unit`` and ``exclusion_mask`` (indexing_ui.py:
2171-2201, :1796-1816, :1887-1946, :2316-2338);
the engine consumes the origins as a small int tensor, the oracle copy
(:mod:`tpu_inspect_torch.oracle`) the exclusion mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_inspect_torch.config import GridParams


@dataclass(frozen=True)
class BoxGrid:
    """A grid given by explicit unit boxes instead of indexing parameters.

    Legacy grid JSONs (bare box lists, or metadata that no longer
    regenerates the stored boxes — accepted by the reference importer,
    indexing_ui.py:2874-2889) carry no reconstructible GridParams; driving
    the engine from the boxes directly preserves every unit instead of
    collapsing to unit 0. Boxes must share one (w, h) — the reference
    generates uniform grids, and the batched engine requires one unit shape.
    """

    boxes: tuple[tuple[int, int, int, int], ...]

    def __post_init__(self):
        if not self.boxes:
            raise ValueError("BoxGrid needs at least one box")
        w, h = self.boxes[0][2], self.boxes[0][3]
        if w <= 0 or h <= 0:
            raise ValueError(f"non-positive unit size: {(w, h)}")
        for b in self.boxes:
            if (b[2], b[3]) != (w, h):
                raise ValueError(
                    f"non-uniform unit sizes: {(b[2], b[3])} != {(w, h)}"
                )

    @property
    def base_unit(self) -> tuple[int, int, int, int]:
        return self.boxes[0]

    @property
    def num_units(self) -> int:
        return len(self.boxes)


def grid_boxes(p: GridParams | BoxGrid) -> list[tuple[int, int, int, int]]:
    """Generate unit rects (x, y, w, h) in reference index order.

    Index order is ``for by: for uy: for bx: for ux`` — a row of units spans
    all X-blocks before moving down (indexing_ui.py:2184-2191). The position
    formula is
    ``x = base.x + bx*(units_x*w + (units_x-1)*sux + sbx) + ux*(w + sux)``
    (indexing_ui.py:2188-2189). A :class:`BoxGrid` returns its explicit
    boxes unchanged.
    """
    if isinstance(p, BoxGrid):
        return list(p.boxes)
    bx0, by0, w, h = (int(v) for v in p.base_unit)
    sux, suy = int(p.unit_space_x), int(p.unit_space_y)
    sbx, sby = int(p.block_space_x), int(p.block_space_y)
    ux_n, uy_n = int(p.units_x), int(p.units_y)

    block_pitch_x = ux_n * w + (ux_n - 1) * sux + sbx
    block_pitch_y = uy_n * h + (uy_n - 1) * suy + sby

    boxes: list[tuple[int, int, int, int]] = []
    for byi in range(int(p.blocks_y)):
        for uyi in range(uy_n):
            for bxi in range(int(p.blocks_x)):
                for uxi in range(ux_n):
                    x = bx0 + bxi * block_pitch_x + uxi * (w + sux)
                    y = by0 + byi * block_pitch_y + uyi * (h + suy)
                    boxes.append((x, y, w, h))
    return boxes


def grid_origins(p: GridParams | BoxGrid) -> np.ndarray:
    """Unit top-left corners as an ``[units, 2]`` int32 array of (x, y)."""
    boxes = grid_boxes(p)
    return np.array([[b[0], b[1]] for b in boxes], dtype=np.int32).reshape(-1, 2)


def infer_grid_params(
    boxes: list[tuple[int, int, int, int]], meta: dict
) -> GridParams | BoxGrid | None:
    """Reconstruct a grid from a grid-JSON (persistence helper).

    Returns GridParams only when the metadata regenerates the stored boxes
    exactly; otherwise (bare-list legacy imports, stale/absent metadata) a
    :class:`BoxGrid` over the explicit boxes, so no unit is silently
    dropped. None when there are no boxes at all.
    """
    if not boxes:
        return None
    bu = meta.get("base_unit")
    if bu is not None:
        params = GridParams(
            base_unit=(int(bu["x"]), int(bu["y"]), int(bu["w"]), int(bu["h"])),
            units_x=int(meta.get("units_x", 1) or 1),
            units_y=int(meta.get("units_y", 1) or 1),
            blocks_x=max(1, int(meta.get("blocks_x", 1) or 1)),
            blocks_y=max(1, int(meta.get("blocks_y", 1) or 1)),
            unit_space_x=int(meta.get("unit_space_x", 0) or 0),
            unit_space_y=int(meta.get("unit_space_y", 0) or 0),
            block_space_x=int(meta.get("block_space_x", 0) or 0),
            block_space_y=int(meta.get("block_space_y", 0) or 0),
        )
        if grid_boxes(params) == [tuple(int(v) for v in b) for b in boxes]:
            return params
    return BoxGrid(tuple(tuple(int(v) for v in b) for b in boxes))


def exclusion_from_drawn_rect(
    drawn: tuple[int, int, int, int],
    base_unit: tuple[int, int, int, int],
    shape: str = "rect",
) -> dict | None:
    """Convert an image-space drawn rect into a unit-local exclusion.

    Mirrors on_exclusion_drawn (indexing_ui.py:1796-1816): intersect with the
    base unit; rect exclusions keep the intersection; circles take the
    bounding-rect center and ``r = min(w, h) // 2``. Returns None when the
    drawn rect lies outside the unit.
    """
    dx, dy, dw, dh = drawn
    bx, by, bw, bh = base_unit
    x = max(bx, dx)
    y = max(by, dy)
    x2 = min(bx + bw, dx + dw)
    y2 = min(by + bh, dy + dh)
    if x2 <= x or y2 <= y:
        return None
    rel_x, rel_y, rel_w, rel_h = x - bx, y - by, x2 - x, y2 - y
    if shape == "rect" or shape == "rectangle":
        return {"shape": "rect", "x": rel_x, "y": rel_y, "w": rel_w, "h": rel_h}
    cx = rel_x + rel_w / 2.0
    cy = rel_y + rel_h / 2.0
    r = int(min(rel_w, rel_h) / 2.0)
    return {"shape": "circle", "cx": int(cx), "cy": int(cy), "r": r}


def clamp_exclusion_to_base_unit(excl: dict, bw: int, bh: int) -> dict:
    """Clamp an exclusion to the base-unit bounds (indexing_ui.py:1922-1946).

    Rects: x,y clamped into [0, dim-1], then w,h clamped to stay inside.
    Circles: center clamped into the unit, then
    ``r = min(r, max(1,cx), max(1,cy), max(1, bw-cx-1), max(1, bh-cy-1))``.
    Returns a new dict (the reference mutates in place).
    """
    out = dict(excl)
    shape = out.get("shape")
    if shape == "rect":
        x = int(out.get("x", 0))
        y = int(out.get("y", 0))
        w = int(out.get("w", 1))
        h = int(out.get("h", 1))
        x = max(0, min(x, max(0, bw - 1)))
        y = max(0, min(y, max(0, bh - 1)))
        w = max(1, min(w, max(1, bw - x)))
        h = max(1, min(h, max(1, bh - y)))
        out.update(x=x, y=y, w=w, h=h)
    elif shape == "circle":
        cx = int(out.get("cx", 0))
        cy = int(out.get("cy", 0))
        r = int(out.get("r", 1))
        cx = max(0, min(cx, max(0, bw - 1)))
        cy = max(0, min(cy, max(0, bh - 1)))
        r = max(1, r)
        r = min(r, max(1, cx), max(1, cy), max(1, bw - cx - 1), max(1, bh - cy - 1))
        out.update(cx=cx, cy=cy, r=r)
    return out


def exclusion_mask(
    exclusions, h: int, w: int, dx: int = 0, dy: int = 0
) -> np.ndarray:
    """Rasterize exclusions into a boolean keep-out mask of shape [h, w].

    True where the segmentation mask must be zeroed. Semantics match the
    apply loop in run_segmentation_all (indexing_ui.py:2316-2338): rect
    bounds are shifted by (dx, dy) then clamped to the unit; circles use the
    integer-center disc test ``(xx-cx)^2 + (yy-cy)^2 <= r^2`` with no clamp.
    Malformed entries are skipped (the reference swallows their exceptions).
    """
    out = np.zeros((h, w), dtype=bool)
    yy, xx = np.ogrid[:h, :w]
    for excl in exclusions or ():
        try:
            if excl.get("shape") == "rect":
                ex = int(excl.get("x", 0)) + dx
                ey = int(excl.get("y", 0)) + dy
                ew = int(excl.get("w", 0))
                eh = int(excl.get("h", 0))
                x0, y0 = max(0, ex), max(0, ey)
                x1, y1 = min(w, ex + ew), min(h, ey + eh)
                if x1 > x0 and y1 > y0:
                    out[y0:y1, x0:x1] = True
            else:
                cx = int(excl.get("cx", 0)) + dx
                cy = int(excl.get("cy", 0)) + dy
                r = int(excl.get("r", 0))
                if r > 0:
                    out |= (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        except (AttributeError, TypeError, ValueError, OverflowError):
            continue
    return out
