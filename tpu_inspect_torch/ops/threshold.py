"""Thresholding ops: histogram, Otsu, plain binary, adaptive (OpenCV parity).

Port of :mod:`tpu_inspect.ops.threshold`. The Otsu
scan replicates OpenCV's getThreshVal_Otsu_8u recurrence exactly in
``torch.float64`` (epsilon guards that *skip* the normalisation, strict
``>`` keeping the first maximum); it is sequential over the 256 bins and
vectorised over units only — a cumsum would round differently.

:func:`histogram_u8`, :func:`otsu_threshold_from_hist` and
:func:`otsu_threshold` launch ``csrc/otsu.cu`` for CUDA tensors (the
histogram kernel, the scan kernel, both; the threshold stays on the
device, no host copy) and run their plain versions,
:func:`histogram_u8_plain`, :func:`otsu_threshold_from_hist_plain` and
:func:`otsu_threshold_plain`, for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes
from tpu_inspect_torch.ops.gaussian import (
    ADAPTIVE,
    _adaptive_launch,
    adaptive_gaussian_mean_plain,
)

_OTSU = Kernel("otsu")

_FLT_EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, as used by OpenCV


def histogram_u8_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`histogram_u8`: one integer
    bincount over ``unit*256 + value`` (exact on any device; on a CUDA
    tensor bincount reads the input's maximum back to size its output)."""
    u = x.shape[0]
    flat = x.reshape(u, -1).to(torch.int64)
    flat = flat + 256 * torch.arange(u, device=x.device, dtype=torch.int64)[:, None]
    return torch.bincount(flat.reshape(-1), minlength=256 * u).reshape(u, 256)


def otsu_sigmas_plain(hist: torch.Tensor, n: int) -> torch.Tensor:
    """The between-class variance of every threshold of the Otsu scan, as
    :func:`otsu_threshold_from_hist_plain` computes it: [U, 256] float64 on
    the CPU, ``-inf`` where OpenCV's epsilon guard skips the threshold.
    The 256-step recurrence as float64 torch ops on a host copy of the
    histogram (each step a dozen element-wise ops on [U] values)."""
    h = hist.to(device="cpu", dtype=torch.float64)
    f64 = dict(dtype=torch.float64)
    u = h.shape[0]
    scale = 1.0 / float(n)
    bins = torch.arange(256, **f64)
    # mu accumulated as an exact integer, then scaled once (mu *= scale)
    mu = (hist.to("cpu", torch.int64) * torch.arange(256)).sum(dim=1).to(
        torch.float64
    ) * scale
    p = h.T * scale  # [256, U] == fl(h_i * scale)
    ip = bins[:, None] * p  # fl(i * p_i)
    q1 = torch.zeros(u, **f64)
    mu1 = torch.zeros(u, **f64)
    out = torch.full((u, 256), float("-inf"), **f64)
    for i in range(256):
        mu1 = mu1 * q1  # old q1 (un-normalize)
        q1 = q1 + p[i]
        q2 = 1.0 - q1
        guard = (torch.minimum(q1, q2) < _FLT_EPSILON) | (
            torch.maximum(q1, q2) > 1.0 - _FLT_EPSILON
        )
        mu1_new = (mu1 + ip[i]) / q1
        mu2 = (mu - q1 * mu1_new) / q2
        d = mu1_new - mu2
        out[:, i] = torch.where(guard, float("-inf"), q1 * q2 * d * d)
        mu1 = torch.where(guard, mu1, mu1_new)
    return out


def otsu_threshold_from_hist_plain(hist: torch.Tensor, n: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`otsu_threshold_from_hist`: the
    first threshold of the largest variance of :func:`otsu_sigmas_plain`
    (OpenCV's strict ``>`` from 0), 0 where none is above 0; the result
    goes back to the histogram's device."""
    sigma = otsu_sigmas_plain(hist, n)
    best = sigma.max(dim=1, keepdim=True).values
    first = torch.where(sigma == best, torch.arange(256), 256).min(dim=1).values
    return torch.where(best[:, 0] > 0, first, 0).to(torch.int32).to(hist.device)


# a histogram CTA's least chunk: one 16-byte load for each of its 256 threads
_HIST_MIN_CHUNK = 4096


def hist_plan(u: int, hw: int, sms: int) -> tuple[int, int]:
    """The histogram kernel's grid: (chunk, per_unit), ``per_unit`` CTAs of
    ``chunk`` pixels each over every one of ``u`` units of ``hw`` pixels.

    CTA ``p`` of a unit counts its pixels ``[p * chunk, min(hw, (p + 1) *
    chunk))``: the ranges are disjoint, none is empty, and they cover the
    unit. ``chunk`` is a multiple of 16, so every chunk of a unit shares
    the unit's alignment. The grid takes at least two CTAs for each of the
    card's ``sms`` SMs wherever the units hold that many chunks of
    ``_HIST_MIN_CHUNK`` pixels (48 units of 315x316: 7 chunks of at most
    16384 px a unit, 336 CTAs; a 3000x4096 capture: 273 of 45056 px, on
    132 SMs); four a SM took longer on the card (PERF.md §6)."""
    if hw <= 0:
        return 16, 1
    per = max(1, min(-(-2 * sms // max(u, 1)), -(-hw // _HIST_MIN_CHUNK)))
    if per == 1:
        return -(-hw // 16) * 16, 1
    # rounded down, so at least per CTAs; to whole 4096-px steps (one
    # 16-byte load a thread) where that leaves a chunk
    chunk = hw // per // 16 * 16
    if chunk >= _HIST_MIN_CHUNK:
        chunk = chunk // _HIST_MIN_CHUNK * _HIST_MIN_CHUNK
    return chunk, -(-hw // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _hist_launch(x: torch.Tensor, hist=None):
    """One launch of the histogram kernel on [U, H, W] uint8 ``x``: its
    counts added into ``hist`` ([U, 256] int64, zeroed), or, with ``hist``
    None, written as [U * per_unit, 256] int32 partial rows (returned with
    ``per_unit``)."""
    u, h, w = x.shape
    chunk, per = hist_plan(u, h * w, _sm_count(x.device.index))
    partials = None
    if hist is None:
        partials = torch.empty((u * per, 256), dtype=torch.int32, device=x.device)
    code = build.lib().tik_histogram(
        x.data_ptr(), None if hist is None else hist.data_ptr(),
        None if partials is None else partials.data_ptr(), u, h * w, chunk, per,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("histogram_u8", code)
    _OTSU.launched()
    return partials, per


def _scan_launch(u: int, n: int, device, hist=None, partials=None, parts: int = 0):
    """One launch of the scan kernel: [U] int32 thresholds from ``hist``
    ([U, 256] int64) or from ``parts`` int32 partial rows a unit."""
    thr = torch.empty((u,), dtype=torch.int32, device=device)
    code = build.lib().tik_otsu_scan(
        None if hist is None else hist.data_ptr(),
        None if partials is None else partials.data_ptr(), parts, thr.data_ptr(), u,
        1.0 / float(n), torch.cuda.current_stream(device).cuda_stream,
    )
    build.check("otsu_threshold_from_hist", code)
    _OTSU.launched()
    return thr


@_OTSU
def histogram_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-unit 256-bin histogram. x: [U, H, W] uint8 -> [U, 256] int64
    (one launch of the histogram kernel for a CUDA tensor)."""
    if x.device.type == "cpu":
        return histogram_u8_plain(x)
    check_planes(x, "histogram_u8")
    hist = torch.zeros((x.shape[0], 256), dtype=torch.int64, device=x.device)
    _hist_launch(x, hist)
    return hist


@_OTSU
def otsu_threshold_from_hist(hist: torch.Tensor, n: int) -> torch.Tensor:
    """getThreshVal_Otsu_8u from [U, 256] int64 counts summing to ``n``.

    Returns [U] int32 thresholds on the histogram's device: the scan kernel
    for a CUDA histogram (one CTA a unit: one thread runs the carried
    chains, then every thread one step's variance, with the same double
    operations in the same order), :func:`otsu_threshold_from_hist_plain`
    for a CPU one."""
    if hist.device.type == "cpu":
        return otsu_threshold_from_hist_plain(hist, n)
    if hist.dtype != torch.int64 or hist.ndim != 2 or hist.shape[1] != 256 or not (
            hist.is_contiguous()):
        raise ValueError(
            f"otsu_threshold_from_hist: expected a contiguous [U, 256] int64 tensor, got "
            f"{hist.dtype} {tuple(hist.shape)}"
        )
    return _scan_launch(hist.shape[0], n, hist.device, hist=hist)


@_OTSU
def otsu_threshold(x: torch.Tensor) -> torch.Tensor:
    """Per-unit Otsu threshold. x: [U, H, W] uint8 -> [U] int32 on x's
    device: two launches of ``csrc/otsu.cu`` for a CUDA tensor (the
    histogram as int32 partial rows, which the scan sums: no zeroed
    buffer), :func:`otsu_threshold_plain` for a CPU one."""
    if x.device.type == "cpu":
        return otsu_threshold_plain(x)
    check_planes(x, "otsu_threshold")
    partials, per = _hist_launch(x)
    return _scan_launch(x.shape[0], x.shape[-2] * x.shape[-1], x.device, partials=partials,
                        parts=per)


def otsu_threshold_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`otsu_threshold` (on any device;
    it launches no kernel)."""
    return otsu_threshold_from_hist_plain(histogram_u8_plain(x), x.shape[-2] * x.shape[-1])


def threshold_binary_inv(x: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """THRESH_BINARY_INV: 255 where x <= thr (thr [U] broadcasts)."""
    t = thr.to(torch.int32).reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(x.to(torch.int32) <= t, 255, 0).to(torch.uint8)


def otsu_binary_inv(x: torch.Tensor) -> torch.Tensor:
    """cv2.threshold(x, 0, 255, THRESH_BINARY_INV + THRESH_OTSU) per unit of
    [U, H, W] uint8: the Otsu kernel's threshold, then the compare."""
    return threshold_binary_inv(x, otsu_threshold(x))


def threshold_binary(x: torch.Tensor, thr: int) -> torch.Tensor:
    """THRESH_BINARY: 255 where x > thr."""
    return torch.where(x.to(torch.int32) > int(thr), 255, 0).to(torch.uint8)


def adaptive_threshold_inv_plain(x: torch.Tensor, block_size: int, C: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`adaptive_threshold_inv` (on any
    device; it launches no kernel)."""
    mean = adaptive_gaussian_mean_plain(x, block_size).to(torch.int32)
    diff = x.to(torch.int32) - mean
    return torch.where(diff <= -int(C), 255, 0).to(torch.uint8)


@ADAPTIVE
def adaptive_threshold_inv(x: torch.Tensor, block_size: int, C: int) -> torch.Tensor:
    """cv2.adaptiveThreshold(GAUSSIAN_C, BINARY_INV): 255 where
    ``x - mean <= -C`` in int32, with the uint8 Gaussian local mean
    (OpenCV's lookup-table form, ``threshold.py:148-160`` of the JAX
    package). Kernel N with the compare fused for a contiguous [U, H, W]
    uint8 CUDA tensor (one launch; ``block_size`` odd),
    :func:`adaptive_threshold_inv_plain` for a CPU one."""
    if x.device.type == "cpu":
        return adaptive_threshold_inv_plain(x, block_size, C)
    return _adaptive_launch(x, block_size, C, True, "adaptive_threshold_inv")
