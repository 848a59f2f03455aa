"""OpenCV's pixel operations as the inspection tool calls them, restated on
[U, H, W] tensors in plain PyTorch (any device) and NumPy.

Each function names the OpenCV call it restates. Integer steps are exact.
The floating steps follow OpenCV's own order of operations, so the results
are bit-exact: the Otsu scan of ``getThreshVal_Otsu_8u`` in float64, and
the float32 Gaussian mean of ``adaptiveThreshold`` as OpenCV's AVX2/FMA3
separable filter rounds it.

``low=True`` computes every floating or fixed-point step one rung lower
(the blur and the adaptive mean in bfloat16, the Otsu scan in float32):
the benchmark's control, which has to fail the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_EPSILON = 1.1920928955078125e-07

# getGaussianKernel's table for sigma <= 0 and k <= 7
_SMALL_GAUSS = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}
# its CV_32F table at k = 9 (the adaptive mean's float taps)
_GAUSS9_F32 = np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], np.float32) / np.float32(256)


def gauss_kernel_f64(k: int) -> np.ndarray:
    """``cv2.getGaussianKernel(k, 0)`` (float64, sums to 1)."""
    if k in _SMALL_GAUSS:
        return np.array(_SMALL_GAUSS[k], np.float64)
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    xs = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    v = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return v / v.sum()


def gauss_taps_u8(k: int) -> np.ndarray:
    """The 8-bit fixed-point taps of OpenCV's bit-exact CV_8U Gaussian:
    the kernel's running sum times 256, rounded, differenced (sum 256)."""
    cum = np.rint(np.cumsum(gauss_kernel_f64(k)) * 256.0)
    return np.diff(np.concatenate([[0.0], cum])).astype(np.int64)


def _pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    """Indices of an axis of ``n`` padded by ``pad`` on both sides:
    BORDER_REFLECT_101 ('reflect') or BORDER_REPLICATE ('edge')."""
    return torch.as_tensor(np.pad(np.arange(n), pad, mode=mode), device=device)


def _padded(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    h, w = x.shape[-2:]
    x = x.index_select(-1, _pad_index(w, pad, mode, x.device))
    return x.index_select(-2, _pad_index(h, pad, mode, x.device))


def gaussian_blur_u8(x: torch.Tensor, k: int, low: bool = False) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (k, k), 0)`` on uint8 planes: BORDER_REFLECT_101,
    the row and column passes in integers, ``(acc + 2**15) >> 16``."""
    if k <= 1:
        return x
    taps = gauss_taps_u8(k)
    r = k // 2
    h, w = x.shape[-2:]
    if low:
        p = _padded(x.to(torch.bfloat16), r, "reflect")
        row = sum(p[..., :, t:t + w] * float(taps[t] / 256.0) for t in range(k))
        out = sum(row[..., t:t + h, :] * float(taps[t] / 256.0) for t in range(k))
        return out.float().round().clamp(0, 255).to(torch.uint8)
    p = _padded(x.to(torch.int32), r, "reflect")
    row = sum(int(taps[t]) * p[..., :, t:t + w] for t in range(k))
    acc = sum(int(taps[t]) * row[..., t:t + h, :] for t in range(k))
    return ((acc + 32768) >> 16).clamp(0, 255).to(torch.uint8)


def histograms(x: torch.Tensor) -> np.ndarray:
    """[U, 256] int64 histograms of uint8 planes, on the host."""
    u = x.shape[0]
    flat = x.reshape(u, -1).to(torch.int64) + 256 * torch.arange(u, device=x.device)[:, None]
    return torch.bincount(flat.reshape(-1), minlength=256 * u).reshape(u, 256).cpu().numpy()


def otsu_thresholds(hist: np.ndarray, n: int, low: bool = False) -> np.ndarray:
    """``getThreshVal_Otsu_8u`` for each row of ``hist`` ([U, 256] counts of
    ``n`` pixels): OpenCV's 256-step recurrence in float64 (float32 with
    ``low``), the epsilon guard skipping a step (and leaving ``mu1``
    un-normalised), the strict ``>`` keeping the first maximum."""
    f = np.float32 if low else np.float64
    h = hist.astype(f)
    u = h.shape[0]
    scale = f(1.0) / f(n)
    if low:
        mu = np.zeros(u, f)
        for i in range(256):
            mu = mu + f(i) * h[:, i]
    else:  # integer terms: the running double sum is exact
        mu = (hist.astype(np.int64) * np.arange(256)).sum(axis=1).astype(f)
    mu = mu * scale
    eps, one = f(FLT_EPSILON), f(1.0)
    mu1 = np.zeros(u, f)
    q1 = np.zeros(u, f)
    best = np.zeros(u, f)
    thr = np.zeros(u, np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(256):
            p_i = h[:, i] * scale
            mu1 = mu1 * q1
            q1 = q1 + p_i
            q2 = one - q1
            skip = (np.minimum(q1, q2) < eps) | (np.maximum(q1, q2) > one - eps)
            m1 = (mu1 + f(i) * p_i) / q1
            mu2 = (mu - q1 * m1) / q2
            d = m1 - mu2
            sigma = q1 * q2 * d * d
            mu1 = np.where(skip, mu1, m1)
            better = ~skip & (sigma > best)
            best = np.where(better, sigma, best)
            thr = np.where(better, i, thr)
    return thr.astype(np.int32)


def _fma32(a: torch.Tensor, f: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, f, c)``: ``a`` a float32 value held in float64, ``f``
    a float32 tap, ``c`` float32. The product is exact in float64; the
    float64 sum's error (TwoSum) turns its rounding into rounding to odd,
    so the one rounding to float32 that follows is correct."""
    p = a * f
    c64 = c.double()
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def adaptive_mean_u8(x: torch.Tensor, block: int, low: bool = False) -> torch.Tensor:
    """The uint8 local mean of ``cv2.adaptiveThreshold(GAUSSIAN_C)``:
    ``GaussianBlur`` of the float32 image with BORDER_REPLICATE, then
    ``cvRound`` (half to even) and saturation.

    OpenCV's x86-64 build (AVX2, FMA3) rounds its separable float filter
    so: the row pass runs the taps in order as fused multiply-adds from 0
    (each product and partial sum there is a multiple of 2^-38 below 2^9,
    so a float64 sum is exact and one rounding to float32 is the FMA); the
    column pass of a symmetric kernel starts from the centre tap's product
    and adds each pair of rows, summed in float32 first, as a fused
    multiply-add."""
    k = int(block)
    taps = _GAUSS9_F32 if k == 9 else gauss_kernel_f64(k).astype(np.float32)
    r = k // 2
    h, w = x.shape[-2:]
    if low:
        p = _padded(x.to(torch.bfloat16), r, "edge")
        row = torch.zeros(x.shape, dtype=torch.bfloat16, device=x.device)
        for t in range(k):
            row = row + p[..., r:r + h, t:t + w] * float(taps[t])
        q = _padded(row, r, "edge")[..., :, r:r + w]
        out = q[..., r:r + h, :] * float(taps[r])
        for t in range(1, r + 1):
            out = out + (q[..., r + t:r + t + h, :] + q[..., r - t:r - t + h, :]) * float(taps[r + t])
        return out.float().round().clamp(0, 255).to(torch.uint8)
    p = x.to(torch.float64).index_select(-1, _pad_index(w, r, "edge", x.device))
    row = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(k):
        row = (p[..., t:t + w] * float(taps[t]) + row.double()).float()
    q = row.index_select(-2, _pad_index(h, r, "edge", x.device))
    out = (q[..., r:r + h, :].double() * float(taps[r])).float()
    for t in range(1, r + 1):
        pair = q[..., r + t:r + t + h, :] + q[..., r - t:r - t + h, :]
        out = _fma32(pair.double(), float(taps[r + t]), out)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def adaptive_threshold_inv(x: torch.Tensor, block: int, c: int, low: bool = False) -> torch.Tensor:
    """``cv2.adaptiveThreshold(x, 255, GAUSSIAN_C, THRESH_BINARY_INV, block,
    c)`` as a bool plane: ``x - mean <= -c`` in integers."""
    mean = adaptive_mean_u8(x, block, low).to(torch.int32)
    return x.to(torch.int32) - mean <= -int(c)


def ellipse_se(k: int) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))``."""
    se = np.zeros((k, k), np.uint8)
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))))
            se[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return se


def _morph(m: torch.Tensor, se: np.ndarray, erode: bool) -> torch.Tensor:
    """Erode or dilate bool planes with ``se`` (anchor at its centre) and
    OpenCV's default border for morphology, which never changes a result
    (+inf for an erosion, -inf for a dilation)."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    h, w = m.shape[-2:]
    p = torch.full(m.shape[:-2] + (h + kh - 1, w + kw - 1), erode, dtype=torch.bool,
                   device=m.device)
    p[..., ay:ay + h, ax:ax + w] = m
    out = None
    for dy, dx in zip(*np.nonzero(se)):
        s = p[..., dy:dy + h, dx:dx + w]
        out = s.clone() if out is None else (out & s if erode else out | s)
    return out


def erode(m, se):
    return _morph(m, se, True)


def dilate(m, se):
    return _morph(m, se, False)


def morph_close(m, se):
    return erode(dilate(m, se), se)


def morph_open(m, se):
    return dilate(erode(m, se), se)


def median_blur_u8(x: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur(x, k)`` on uint8 planes (BORDER_REPLICATE): the
    median of a window is the least level ``v`` that at least
    ``k*k // 2 + 1`` of its pixels do not exceed, so it is the lowest level
    plus the number of levels whose window count, a box sum of ``x <= v``,
    falls short of that."""
    r = k // 2
    h, w = x.shape[-2:]
    p = _padded(x, r, "edge")
    need = k * k // 2 + 1
    lo, hi = int(x.min()), int(x.max())
    out = torch.full(x.shape, lo, dtype=torch.int32, device=x.device)
    z = torch.zeros(p.shape[:-2] + (p.shape[-2] + 1, p.shape[-1] + 1), dtype=torch.int32,
                    device=x.device)
    for v in range(lo, hi):
        z[..., 1:, 1:] = (p <= v).to(torch.int32).cumsum(-1, dtype=torch.int32).cumsum(
            -2, dtype=torch.int32)
        cnt = (z[..., k:k + h, k:k + w] - z[..., :h, k:k + w]
               - z[..., k:k + h, :w] + z[..., :h, :w])
        out += (cnt < need).to(torch.int32)
    return out.to(torch.uint8)


_TG22 = 13573  # round(tan(22.5 deg) * 2**15), Canny's CANNY_SHIFT fixed point


def canny_planes(x: torch.Tensor, low: int, high: int):
    """The planes of ``cv2.Canny(x, low, high)`` (aperture 3, L1 gradient)
    before hysteresis: (strong, candidate) bool planes. Sobel with
    BORDER_REPLICATE; the magnitude ``|dx| + |dy|``, 0 outside the plane;
    non-maximum suppression by OpenCV's fixed-point sector test and its
    strict and non-strict comparisons; candidate = kept and ``m > low``,
    strong = candidate and ``m > high``."""
    low, high = min(low, high), max(low, high)
    h, w = x.shape[-2:]
    p = _padded(x.to(torch.int32), 1, "edge")

    def px(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (px(-1, 1) - px(-1, -1)) + 2 * (px(0, 1) - px(0, -1)) + (px(1, 1) - px(1, -1))
    gy = (px(1, -1) - px(-1, -1)) + 2 * (px(1, 0) - px(-1, 0)) + (px(1, 1) - px(-1, 1))
    mag = gx.abs() + gy.abs()
    mp = torch.zeros(mag.shape[:-2] + (h + 2, w + 2), dtype=torch.int32, device=x.device)
    mp[..., 1:-1, 1:-1] = mag

    def nb(dy, dx):
        return mp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    ax, ay = gx.abs(), gy.abs() << 15
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << 16)
    same_sign = (gx ^ gy) >= 0
    horiz = ay < tg22
    vert = ~horiz & (ay > tg67)
    diag = ~horiz & ~vert
    keep = (horiz & (mag > nb(0, -1)) & (mag >= nb(0, 1))) \
        | (vert & (mag > nb(-1, 0)) & (mag >= nb(1, 0))) \
        | (diag & (mag > torch.where(same_sign, nb(-1, -1), nb(-1, 1)))
           & (mag > torch.where(same_sign, nb(1, 1), nb(1, -1))))
    cand = keep & (mag > low)
    return cand & (mag > high), cand
