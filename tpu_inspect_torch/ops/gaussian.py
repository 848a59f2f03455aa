"""Bit-exact u8 Gaussian blur (OpenCV's fixed-point path), batched [U, H, W].

Port of :func:`tpu_inspect.ops.gaussian.gaussian_blur_u8`: the kernel is
quantized to 8 fractional bits by cumulative rounding (taps sum to 256),
both separable passes accumulate exactly in int32 shifted-slice sums, and
the final >>16 rounds half-up. Border: BORDER_REFLECT_101, gathered through
numpy-built reflect indices (``F.pad`` does not take integer tensors, and a
float conv would run in TF32 on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_SMALL_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel_f64(k: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics (float64, normalized)."""
    if sigma <= 0 and k in _SMALL_TAB:
        return np.array(_SMALL_TAB[k], dtype=np.float64)
    sig = sigma if sigma > 0 else 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    xs = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    vals = np.exp(-(xs * xs) / (2.0 * sig * sig))
    return vals / vals.sum()


def fixed_gaussian_kernel(k: int, sigma: float = 0.0) -> np.ndarray:
    """The 8-fractional-bit quantized kernel of OpenCV's bit-exact u8 path:
    ``m[i] = round(256*cum[i]) - round(256*cum[i-1])``, so ``sum(m) == 256``."""
    ker = gaussian_kernel_f64(k, sigma)
    cum = np.cumsum(ker) * 256.0
    return np.diff(np.concatenate([[0.0], np.rint(cum)])).astype(np.int64)


@functools.lru_cache(maxsize=32)
def _reflect101_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Indices of a BORDER_REFLECT_101 padded axis (numpy's 'reflect'),
    kept per device, so a call on the card uploads them once and does not
    wait for the copy again."""
    idx = np.pad(np.arange(n), pad, mode="reflect")
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _sep_int_conv(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """Exact separable integer conv; int32 with 16 fractional bits."""
    k = len(m)
    pad = k // 2
    h, w = x.shape[-2], x.shape[-1]
    xi = x.to(torch.int32)
    p = xi.index_select(-1, _reflect101_index(w, pad, x.device))
    tmp = torch.zeros_like(xi)
    for t in range(k):
        if m[t]:
            tmp += int(m[t]) * p[..., t : t + w]
    p = tmp.index_select(-2, _reflect101_index(h, pad, x.device))
    out = torch.zeros_like(xi)
    for t in range(k):
        if m[t]:
            out += int(m[t]) * p[..., t : t + h, :]
    return out


def gaussian_blur_u8(x: torch.Tensor, k: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur(CV_8U, (k, k), sigma) bit-exact. x: [..., H, W] uint8."""
    if k <= 1:
        return x
    acc = _sep_int_conv(x, fixed_gaussian_kernel(k, sigma))
    return ((acc + 32768) >> 16).clamp(0, 255).to(torch.uint8)


def _replicate_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a BORDER_REPLICATE padded axis (any pad, even pad > n)."""
    return torch.arange(-pad, n + pad, device=device).clamp(0, n - 1)


def adaptive_gaussian_mean(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """The uint8 Gaussian local mean of cv2.adaptiveThreshold (GAUSSIAN_C).

    Port of :func:`tpu_inspect.ops.gaussian.adaptive_gaussian_mean`: float32
    taps, rows then columns in sequential tap order, BORDER_REPLICATE, then
    cvRound (half to even) and saturation to uint8. Every tap is a product
    and a sum as two separate torch ops, so each rounds on its own as in
    OpenCV; a fused multiply-add (``addcmul``, ``add(alpha=)``, a fused
    kernel) would round once and break bit-exactness.
    """
    k = int(block_size)
    if k <= 1:
        return x
    ker = gaussian_kernel_f64(k).astype(np.float32)
    pad = k // 2
    h, w = x.shape[-2], x.shape[-1]
    xf = x.to(torch.float32)
    p = xf.index_select(-1, _replicate_index(w, pad, x.device))
    tmp = torch.zeros_like(xf)
    for t in range(k):
        prod = p[..., t : t + w] * float(ker[t])
        tmp = tmp + prod
    p = tmp.index_select(-2, _replicate_index(h, pad, x.device))
    out = torch.zeros_like(xf)
    for t in range(k):
        prod = p[..., t : t + h, :] * float(ker[t])
        out = out + prod
    return torch.round(out).clamp(0, 255).to(torch.uint8)
