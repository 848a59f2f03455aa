"""cv2.Canny parity (L1 gradient, aperture 3), batched over [U, H, W].

Port of :mod:`tpu_inspect.ops.canny`. Reference call:
``cv2.Canny(gray, max(1, thr//2), max(2, thr))`` (indexing_ui.py:1537).
OpenCV's scalar pipeline, exactly:

- Sobel 3x3 dx/dy with BORDER_REPLICATE, in int32;
- L1 magnitude |dx| + |dy|; out-of-image magnitude is 0 (OpenCV's zero
  border rows/cols in the NMS buffer);
- non-maximum suppression with OpenCV's fixed-point sector test
  (TG22 = 13573 = tan(22.5deg) * 2^15) and its strict/non-strict neighbour
  comparisons per sector;
- hysteresis: candidates (NMS pass, m > low) 8-connected to a strong
  candidate (m > high) become edges — kernel D (``ops.flood.propagate``)
  on CUDA tensors.

Sobel and NMS are torch int32 ops (XLA in the reference).
"""

from __future__ import annotations

import torch

from tpu_inspect_torch.ops.flood import propagate

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's CANNY_SHIFT fixed point


def _pad1(x: torch.Tensor, replicate: bool) -> torch.Tensor:
    """[U, H, W] -> [U, H+2, W+2]: replicate border, or zeros."""
    u, h, w = x.shape
    if replicate:
        rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
        cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
        return x[:, rows[:, None], cols[None, :]]
    p = torch.zeros((u, h + 2, w + 2), dtype=x.dtype, device=x.device)
    p[:, 1:-1, 1:-1] = x
    return p


def _sobel3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel dx, dy (int32), BORDER_REPLICATE."""
    p = _pad1(x.to(torch.int32), replicate=True)
    h, w = x.shape[-2], x.shape[-1]

    def sl(dy, dx):
        return p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (sl(-1, 1) - sl(-1, -1)) + 2 * (sl(0, 1) - sl(0, -1)) + (sl(1, 1) - sl(1, -1))
    gy = (sl(1, -1) - sl(-1, -1)) + 2 * (sl(1, 0) - sl(-1, 0)) + (sl(1, 1) - sl(-1, 1))
    return gx, gy


def canny_planes(x: torch.Tensor, low: int, high: int):
    """The hysteresis inputs of :func:`canny_u8`: (strong, cand), [U, H, W]
    bool each — NMS survivors above ``high`` and above ``low``."""
    low, high = int(min(low, high)), int(max(low, high))
    gx, gy = _sobel3(x)
    mag = gx.abs() + gy.abs()
    mp = _pad1(mag, replicate=False)
    h, w = x.shape[-2], x.shape[-1]

    def nb(dy, dx):
        return mp[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ax = gx.abs()
    ay = gy.abs() << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    pos = (gx ^ gy) >= 0  # s == 1 in OpenCV's sector test

    horiz = ay < tg22x
    vert = (~horiz) & (ay > tg67x)
    diag = (~horiz) & (~vert)

    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    # diagonal: m > mag[y-1, x-s] and m > mag[y+1, x+s]
    keep_d = (mag > torch.where(pos, nb(-1, -1), nb(-1, 1))) & (
        mag > torch.where(pos, nb(1, 1), nb(1, -1))
    )
    nms = (horiz & keep_h) | (vert & keep_v) | (diag & keep_d)
    cand = nms & (mag > low)
    strong = cand & (mag > high)
    return strong, cand


def canny_u8(x: torch.Tensor, low: int, high: int, *, err=None) -> torch.Tensor:
    """x [U, H, W] uint8 -> edges uint8 0/255; low/high as cv2.Canny (their
    order does not matter). On CUDA tensors it launches kernel D once
    (``err`` as for :func:`tpu_inspect_torch.ops.flood.propagate`)."""
    strong, cand = canny_planes(x, low, high)
    edges = propagate(strong, cand, conn8=True, err=err)
    return torch.where(edges, 255, 0).to(torch.uint8)
