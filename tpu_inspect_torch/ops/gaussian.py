"""Bit-exact u8 Gaussian blur (OpenCV's fixed-point path) and the adaptive
threshold's Gaussian local mean, batched [U, H, W].

Port of :func:`tpu_inspect.ops.gaussian.gaussian_blur_u8`: the kernel is
quantized to 8 fractional bits by cumulative rounding (taps sum to 256),
both separable passes accumulate exactly in int32, and the final >>16
rounds half-up. Border: BORDER_REFLECT_101, through numpy-built reflect
indices (``F.pad`` does not take integer tensors, and a float conv would
run in TF32 on the card).

:func:`gaussian_blur_u8` launches kernel M (``csrc/gauss_blur.cu``) and
:func:`adaptive_gaussian_mean` kernel N (``csrc/adaptive_mean.cu``) for
CUDA tensors, one launch a call, and run their plain versions,
:func:`gaussian_blur_u8_plain` and :func:`adaptive_gaussian_mean_plain`,
for CPU tensors. The taps and index tables go to the card once per
(k, sigma, device) and (n, pad, device), so a call waits for no copy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes, device_constant

_GAUSS_BLUR = Kernel("gauss_blur")
ADAPTIVE = Kernel("adaptive")

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


@device_constant(maxsize=32)
def _reflect101_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """int32 indices of a BORDER_REFLECT_101 padded axis (numpy's 'reflect',
    which reflects again where ``pad > n - 1``), kept per device, so a call
    on the card uploads them once and does not wait for the copy again.
    Kernel M reads the same tables the plain version gathers with."""
    idx = np.pad(np.arange(n), pad, mode="reflect")
    return torch.as_tensor(idx, dtype=torch.int32, device=device)


@device_constant(maxsize=32)
def _blur_taps(k: int, sigma: float, device: torch.device) -> torch.Tensor:
    """Kernel M's int32 taps, :func:`fixed_gaussian_kernel` ``(k, sigma)``,
    uploaded once per device."""
    return torch.as_tensor(fixed_gaussian_kernel(k, sigma).astype(np.int32), device=device)


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


def gaussian_blur_u8_plain(x: torch.Tensor, k: int, sigma: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of :func:`gaussian_blur_u8` (on any device;
    it launches no kernel). x: [..., H, W] uint8."""
    if k <= 1:
        return x
    acc = _sep_int_conv(x, fixed_gaussian_kernel(k, sigma))
    return ((acc + 32768) >> 16).clamp(0, 255).to(torch.uint8)


@_GAUSS_BLUR
def gaussian_blur_u8(x: torch.Tensor, k: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur(CV_8U, (k, k), sigma) bit-exact: kernel M for a
    contiguous [U, H, W] uint8 CUDA tensor (one launch; k odd, 3-31, the
    range ``SegmentationParams.gaussian_blur`` gives after ``as_odd``),
    :func:`gaussian_blur_u8_plain` for a CPU one ([..., H, W]). ``k <= 1``
    returns ``x``."""
    k = int(k)
    if k <= 1:
        return x
    if x.device.type == "cpu":
        return gaussian_blur_u8_plain(x, k, sigma)
    check_planes(x, "gaussian_blur_u8")
    if k % 2 == 0 or k > 31:
        raise ValueError(f"gaussian_blur_u8: kernel M takes an odd k of 3-31, got {k}")
    u, h, w = x.shape
    out = torch.empty_like(x)
    code = build.lib().tik_gauss_blur(
        x.data_ptr(), _blur_taps(k, float(sigma), x.device).data_ptr(),
        _reflect101_index(h, k // 2, x.device).data_ptr(),
        _reflect101_index(w, k // 2, x.device).data_ptr(), out.data_ptr(), u, h, w, k,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("gaussian_blur_u8", code)
    _GAUSS_BLUR.launched()
    return out


def _replicate_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a BORDER_REPLICATE padded axis (any pad, even pad > n)."""
    return torch.arange(-pad, n + pad, device=device).clamp(0, n - 1)


# OpenCV's getGaussianKernel takes this table for a 9-tap kernel of
# sigma <= 0 (the JAX package's copy of the kernel computes it, which its
# uint8 path quantizes to the same taps, and its float path does not)
_TAB_9 = np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], np.float32) / np.float32(256)


def _mean_kernel(k: int) -> np.ndarray:
    """The adaptive mean's float32 taps: OpenCV's ``getGaussianKernel(k, 0,
    CV_32F)``, its table at k = 9, else the computed kernel rounded once."""
    return _TAB_9 if k == 9 else gaussian_kernel_f64(k).astype(np.float32)


@device_constant(maxsize=32)
def _mean_taps(k: int, device: torch.device) -> torch.Tensor:
    """Kernel N's float32 taps, :func:`_mean_kernel` ``(k)``, uploaded once per
    device."""
    return torch.as_tensor(_mean_kernel(k), device=device)


def _fma32(a64: torch.Tensor, f: float, c: torch.Tensor) -> torch.Tensor:
    """``a * f + c`` rounded once to float32, as an FMA instruction does:
    ``a64`` a float32 plane held in float64, ``f`` a float32 tap, ``c`` a
    float32 plane. The product is exact in float64; the sum's float64
    rounding is turned into rounding to odd (its exact error, by TwoSum,
    says which way an inexact sum lies), so the one rounding to float32
    that follows is correct."""
    p = a64 * f
    c64 = c.double()
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def adaptive_gaussian_mean_plain(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`adaptive_gaussian_mean` (on any
    device; it launches no kernel), and kernel N's contract.

    The uint8 Gaussian local mean of cv2.adaptiveThreshold (GAUSSIAN_C):
    OpenCV's float32 ``GaussianBlur`` with BORDER_REPLICATE, then cvRound
    (half to even) and saturation to uint8.

    Its float32 taps are OpenCV's ``getGaussianKernel(k, 0, CV_32F)``: the
    computed kernel, or for k = 9 OpenCV's table. OpenCV's separable float
    filters (its code dispatched for an x86-64 host with AVX2 and FMA3)
    round as follows, and so do this function and kernel N: the row
    pass runs the taps in order as fused multiply-adds from 0; the column
    pass (a symmetric kernel) starts from the centre tap's product and adds
    each pair of taps, the two rows summed in float32 first, as a fused
    multiply-add. In the row pass every
    product and partial sum is a multiple of 2^-38 below 2^9 (an integer
    pixel times a float32 tap of at least 2^-15, the smallest at block
    201), so its float64 sum is exact and one rounding to float32 makes the
    FMA; the column pass's products are not, so it takes :func:`_fma32`.
    The JAX package's mean (``tpu_inspect/ops/gaussian.py``) rounds each
    product and sum on their own, in tap order down the columns too, and
    computes the 9-tap kernel: it differs from OpenCV where a sum lies
    within a rounding of a half, and at block 9.
    """
    k = int(block_size)
    if k <= 1:
        return x
    ker = _mean_kernel(k)
    pad = k // 2
    h, w = x.shape[-2], x.shape[-1]
    p = x.to(torch.float64).index_select(-1, _replicate_index(w, pad, x.device))
    row = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(k):
        row = (p[..., t : t + w] * float(ker[t]) + row.double()).float()
    q = row.index_select(-2, _replicate_index(h, pad, x.device))
    out = (q[..., pad : pad + h, :].double() * float(ker[pad])).float()
    for t in range(1, pad + 1):
        pair = q[..., pad + t : pad + t + h, :] + q[..., pad - t : pad - t + h, :]
        out = _fma32(pair.double(), float(ker[pad + t]), out)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _adaptive_launch(x: torch.Tensor, block_size: int, C: int, compare: bool,
                     name: str) -> torch.Tensor:
    """One launch of kernel N on a contiguous [U, H, W] uint8 CUDA tensor:
    the mean (``compare`` False) or the BINARY_INV compare against ``C``
    fused behind it. ``block_size`` odd, 1-215."""
    check_planes(x, name)
    k = int(block_size)
    if k < 1 or k % 2 == 0 or k > 215:
        raise ValueError(f"{name}: block_size must be odd, 1-215, got {k}")
    u, h, w = x.shape
    out = torch.empty_like(x)
    code = build.lib().tik_adaptive_mean(
        x.data_ptr(), _mean_taps(k, x.device).data_ptr(), out.data_ptr(), u, h, w, k, int(C),
        int(compare), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(name, code)
    ADAPTIVE.launched()
    return out


@ADAPTIVE
def adaptive_gaussian_mean(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """The uint8 Gaussian local mean of cv2.adaptiveThreshold (GAUSSIAN_C):
    kernel N for a contiguous [U, H, W] uint8 CUDA tensor (one launch),
    :func:`adaptive_gaussian_mean_plain` for a CPU one. ``block_size <= 1``
    returns ``x``."""
    k = int(block_size)
    if k <= 1:
        return x
    if x.device.type == "cpu":
        return adaptive_gaussian_mean_plain(x, k)
    return _adaptive_launch(x, k, 0, False, "adaptive_gaussian_mean")
