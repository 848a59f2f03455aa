"""Viewport math for interactive clients (ImageWidget parity, no Qt).

A copy of :mod:`tpu_inspect.viewport`.

Pure-arithmetic reimplementation of the reference canvas's coordinate and
zoom model so any UI (web, notebook, native) reproduces its behavior:

- scale = fit-to-viewport base scale * manual zoom (ImageWidget.updateScale
  semantics: base = min(vw/iw, vh/ih)),
- image<->display transforms with the reference's int truncation and
  clamping (indexing_ui.py:546-562),
- center_on_cell zoom/scroll math: zoom so the cell fills 80% of the
  viewport, then scroll its center to the viewport center, clamped to
  scroll range (indexing_ui.py:1711-1742).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Viewport:
    image_w: int
    image_h: int
    view_w: int
    view_h: int
    manual_zoom: float = 1.0
    scroll_x: int = 0
    scroll_y: int = 0
    min_zoom: float = 0.1

    @property
    def base_scale(self) -> float:
        if not self.image_w or not self.image_h:
            return 1.0
        return min(self.view_w / self.image_w, self.view_h / self.image_h)

    @property
    def scale(self) -> float:
        return self.base_scale * self.manual_zoom

    @property
    def display_size(self) -> tuple[int, int]:
        return (int(self.image_w * self.scale), int(self.image_h * self.scale))

    # -- transforms (reference int semantics) --------------------------------

    def imgrect_to_display(self, rect) -> tuple[int, int, int, int]:
        x, y, w, h = rect
        s = self.scale
        return (int(x * s), int(y * s), int(w * s), int(h * s))

    def display_to_img(self, px: float, py: float) -> tuple[int, int]:
        s = self.scale
        ix = int(px / s) if s else 0
        iy = int(py / s) if s else 0
        ix = max(0, min(self.image_w - 1, ix))
        iy = max(0, min(self.image_h - 1, iy))
        return (ix, iy)

    # -- zoom / scroll --------------------------------------------------------

    def _scroll_max(self) -> tuple[int, int]:
        dw, dh = self.display_size
        return (max(0, dw - self.view_w), max(0, dh - self.view_h))

    def set_zoom(self, zoom: float) -> None:
        self.manual_zoom = max(self.min_zoom, float(zoom))
        mx, my = self._scroll_max()
        self.scroll_x = min(self.scroll_x, mx)
        self.scroll_y = min(self.scroll_y, my)

    def zoom_in(self, factor: float = 1.25) -> None:
        self.set_zoom(self.manual_zoom * factor)

    def zoom_out(self, factor: float = 1.25) -> None:
        self.set_zoom(self.manual_zoom / factor)

    def center_on_cell(
        self, cell_rect: tuple[int, int, int, int], frac: float = 0.8
    ) -> None:
        """Zoom so the cell fills ``frac`` of the viewport and center it."""
        x, y, w, h = cell_rect
        base = self.base_scale
        desired = min(
            (self.view_w * frac) / max(1, w), (self.view_h * frac) / max(1, h)
        )
        if base > 0:
            self.manual_zoom = max(self.min_zoom, desired / base)
        dx, dy, dw, dh = self.imgrect_to_display((x, y, w, h))
        cx = dx + dw // 2
        cy = dy + dh // 2
        mx, my = self._scroll_max()
        self.scroll_x = min(mx, max(0, cx - self.view_w // 2))
        self.scroll_y = min(my, max(0, cy - self.view_h // 2))

    def visible_image_rect(self) -> tuple[int, int, int, int]:
        """The image-space rect currently visible (for partial redraws)."""
        x0, y0 = self.display_to_img(self.scroll_x, self.scroll_y)
        x1, y1 = self.display_to_img(
            self.scroll_x + self.view_w - 1, self.scroll_y + self.view_h - 1
        )
        return (x0, y0, x1 - x0 + 1, y1 - y0 + 1)
