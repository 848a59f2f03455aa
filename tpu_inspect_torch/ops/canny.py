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

Sobel, the magnitude, NMS and the two thresholds (XLA ops in the
reference) are kernel O (``csrc/canny_head.cu``) for a CUDA tensor, one
launch a call (:func:`canny_planes`), and their plain version,
:func:`canny_planes_plain`, int32 torch ops, for a CPU one.
"""

from __future__ import annotations

import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes
from tpu_inspect_torch.ops.flood import propagate

_CANNY_HEAD = Kernel("canny_head")

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


def canny_planes_plain(x: torch.Tensor, low: int, high: int):
    """The plain PyTorch version of :func:`canny_planes` (on any device; it
    launches no kernel), and kernel O's contract."""
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


# every magnitude lies in [0, 4 * 255 * 2]: a threshold outside [-1, 2040]
# compares as its clamp does, which int32 holds
_MAG_MAX = 2040


@_CANNY_HEAD
def canny_planes(x: torch.Tensor, low: int, high: int):
    """The hysteresis inputs of :func:`canny_u8`: (strong, cand), [U, H, W]
    bool each — NMS survivors above ``high`` and above ``low`` (their order
    does not matter). ``x`` is a contiguous [U, H, W] uint8 tensor: kernel
    O runs for a CUDA one (one launch), :func:`canny_planes_plain` for a
    CPU one."""
    check_planes(x, "canny_planes")
    if x.device.type == "cpu":
        return canny_planes_plain(x, low, high)
    low, high = (max(-1, min(int(v), _MAG_MAX)) for v in sorted((int(low), int(high))))
    strong = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    cand = torch.empty_like(strong)
    if x.numel() == 0:
        return strong, cand
    u, h, w = x.shape
    code = build.lib().tik_canny_head(
        x.data_ptr(), strong.data_ptr(), cand.data_ptr(), u, h, w, low, high,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("canny_planes", code)
    _CANNY_HEAD.launched()
    return strong, cand


def canny_u8(x: torch.Tensor, low: int, high: int, *, err=None) -> torch.Tensor:
    """x [U, H, W] uint8 -> edges uint8 0/255; low/high as cv2.Canny (their
    order does not matter). On CUDA tensors it launches kernel O, then
    kernel D (``err`` as for :func:`tpu_inspect_torch.ops.flood.propagate`),
    once each."""
    strong, cand = canny_planes(x, low, high)
    edges = propagate(strong, cand, conn8=True, err=err)
    return torch.where(edges, 255, 0).to(torch.uint8)
