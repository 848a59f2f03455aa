"""Color conversion (bit-exact vs OpenCV); the port of
:mod:`tpu_inspect.ops.color`.

OpenCV (>= 4.4) converts BGR to gray with 15-bit fixed-point BT.601
weights: ``gray = (R*9798 + G*19235 + B*3735 + 2^14) >> 15``.
"""

from __future__ import annotations

import torch

_R, _G, _B = 9798, 19235, 3735  # BT.601 coefficients scaled by 2^15
_SHIFT = 15
_HALF = 1 << (_SHIFT - 1)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 BGR -> [..., H, W] uint8 gray (OpenCV fixed point)."""
    b = bgr[..., 0].to(torch.int32)
    g = bgr[..., 1].to(torch.int32)
    r = bgr[..., 2].to(torch.int32)
    return ((r * _R + g * _G + b * _B + _HALF) >> _SHIFT).to(torch.uint8)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 RGB -> [..., H, W] uint8 gray (OpenCV fixed point)."""
    return bgr_to_gray(rgb.flip(-1))
