"""Synthetic mold-image fixtures (numpy), copied from
:mod:`tpu_inspect.synthetic` so both packages render the same pixels from
the same seed.

A bright background with a regular grid of darker rounded mold surfaces,
optional bright foreign-material specks, and sensor noise; the 4096x3000,
48-unit sample grid is :func:`sample_grid_params`.
"""

from __future__ import annotations

import numpy as np

from tpu_inspect_torch.config import GridParams
from tpu_inspect_torch.geometry import grid_boxes


def sample_grid_params() -> GridParams:
    """The sample workload's grid (48 units of 316x315 on 4096x3000)."""
    return GridParams(
        base_unit=(251, 232, 316, 315),
        units_x=4,
        units_y=6,
        blocks_x=2,
        blocks_y=1,
        unit_space_x=133,
        unit_space_y=136,
        block_space_x=252,
        block_space_y=0,
    )


def make_mold_image(
    grid: GridParams,
    image_hw: tuple[int, int] = (3000, 4096),
    *,
    seed: int = 0,
    defect_rate: float = 0.3,
    noise: int = 6,
    shift: tuple[int, int] = (0, 0),
) -> np.ndarray:
    """Render a grayscale mold image [H, W] uint8 for the given grid.

    Each unit gets a dark rounded-rectangle "mold surface" (the segmentation
    foreground — Otsu INV picks dark pixels, segmentation.py:82) with a small
    internal texture; a ``defect_rate`` fraction of units gets a bright
    foreign-material speck inside the surface. ``shift`` translates every
    surface, emulating mold movement between captures (exercises the
    centroid alignment path, indexing_ui.py:2291-2314).
    """
    rng = np.random.RandomState(seed)
    H, W = image_hw
    img = np.full((H, W), 200, dtype=np.float32)
    img += rng.uniform(-8, 8, size=(H, W)).astype(np.float32)

    sx, sy = shift
    for u, (x, y, w, h) in enumerate(grid_boxes(grid)):
        # rounded rect occupying ~70% of the unit
        mx, my = int(w * 0.15) + sx, int(h * 0.15) + sy
        sw, sh = int(w * 0.7), int(h * 0.7)
        yy, xx = np.mgrid[0:h, 0:w]
        rad = min(sw, sh) // 6
        cx0, cx1 = mx + rad, mx + sw - rad
        cy0, cy1 = my + rad, my + sh - rad
        qx = np.clip(xx, cx0, cx1)
        qy = np.clip(yy, cy0, cy1)
        inside = (np.hypot(xx - qx, yy - qy) <= rad) | (
            (xx >= mx) & (xx < mx + sw) & (yy >= cy0) & (yy < cy1)
        ) | ((yy >= my) & (yy < my + sh) & (xx >= cx0) & (xx < cx1))
        y0, y1 = max(0, y), min(H, y + h)
        x0, x1 = max(0, x), min(W, x + w)
        if y1 <= y0 or x1 <= x0:
            continue
        sub = img[y0:y1, x0:x1]
        ins = inside[y0 - y : y1 - y, x0 - x : x1 - x]
        sub[ins] = 80 + rng.uniform(-10, 10)
        # faint texture inside the surface
        sub[ins] += rng.uniform(-5, 5, size=int(ins.sum())).astype(np.float32)
        if rng.rand() < defect_rate:
            # a bright speck (foreign material) inside the surface
            dy_, dx_ = my + rng.randint(rad, sh - rad), mx + rng.randint(rad, sw - rad)
            r = rng.randint(3, 8)
            blob = (xx - dx_) ** 2 + (yy - dy_) ** 2 <= r * r
            blob_clip = blob[y0 - y : y1 - y, x0 - x : x1 - x] & ins
            sub[blob_clip] = 235 + rng.uniform(-5, 5)
        img[y0:y1, x0:x1] = sub

    img += rng.normal(0, noise, size=(H, W)).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def crop_units(image: np.ndarray, grid: GridParams) -> np.ndarray:
    """Gather unit crops into a [units, h, w] array (host-side reference)."""
    crops = [image[y : y + h, x : x + w] for x, y, w, h in grid_boxes(grid)]
    return np.stack(crops)


def random_blob_mask(
    h: int, w: int, *, seed: int = 0, n_blobs: int = 4, scale: float = 0.2
) -> np.ndarray:
    """Random smooth binary mask (for per-op parity tests)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((h, w), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_blobs):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry = max(2, int(rng.uniform(0.3, 1.0) * h * scale))
        rx = max(2, int(rng.uniform(0.3, 1.0) * w * scale))
        ang = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        out[(u / rx) ** 2 + (v / ry) ** 2 <= 1.0] = 255
    return out


def serpentine_plane(h: int, w: int) -> np.ndarray:
    """A [H, W] uint8 0/1 plane holding one long 1-px path (port-only
    fixture for the flood and labeling kernels).

    Bands of rows (r, r+1), every 4 rows, zig-zag between their two rows so
    that consecutive pixels touch only diagonally; a vertical segment at
    alternating ends joins each band to the next. The path is one
    8-connected component, and a flood that advances one pixel per round
    needs about its whole length in rounds.
    """
    dom = np.zeros((h, w), np.uint8)
    starts = list(range(0, h - 1, 4))
    for band, r in enumerate(starts):
        for x in range(w):
            dom[r + (x % 2), x] = 1
        if band + 1 < len(starts):
            end = w - 1 if band % 2 == 0 else 0
            dom[r : r + 6, end] = 1
    return dom


def canny_edge_planes(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A [12, H, W] uint8 batch that puts Canny's sector test and its
    neighbour comparisons on their edges (port-only fixture for kernel O):
    a 0/255 checkerboard (the largest magnitudes), a constant plane,
    equal-magnitude ridges and steps across each sector (vertical,
    horizontal and both diagonals: ties between equal neighbours, ``gx`` or
    ``gy`` zero), seeded noise and a noisy diagonal step."""
    yy, xx = np.mgrid[0:h, 0:w]
    masks = [
        (xx + yy) % 2 == 0,
        np.zeros((h, w), bool),
        xx % 4 == 0, yy % 4 == 0, (xx + yy) % 5 == 0, (xx - yy) % 5 == 0,
        xx < w // 2, yy < h // 2, xx + yy < (h + w) // 2, xx - yy < (w - h) // 2,
    ]
    planes = [np.where(m, 200, 20) for m in masks]
    planes[0], planes[1] = np.where(masks[0], 255, 0), np.full((h, w), 77)
    rng = np.random.RandomState(seed)
    noisy_step = np.clip(planes[8] + rng.randint(-3, 4, (h, w)), 0, 255)
    planes += [rng.randint(0, 256, (h, w)), noisy_step]
    return np.stack(planes).astype(np.uint8)


def standard_workload() -> dict:
    """The standard workload: the sample grid (48 units of 316x315 on a
    4096x3000 image, seed 0, defect rate 0.3) with one circle exclusion —
    the same program ``bench.py`` times on the JAX package.

    Returns a dict with the raw image, grid, unit origins, the exclusion
    list and the unit shape.
    """
    from tpu_inspect_torch.geometry import grid_origins

    grid = sample_grid_params()
    image = make_mold_image(grid, (3000, 4096), seed=0, defect_rate=0.3)
    return {
        "grid": grid,
        "image": image,
        "origins": grid_origins(grid),
        "exclusions": [{"shape": "circle", "cx": 160, "cy": 160, "r": 30}],
        "unit_hw": (315, 316),
    }
