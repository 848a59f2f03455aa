"""Kernel B — the median residual mask; kernel H — the full median blur.

Port of :func:`tpu_inspect.ops.median_pallas.median_residual_mask_pallas`:
255 where |x - medianBlur_k(x)| > thr (BORDER_REPLICATE), else 0, bit-exact
vs cv2.medianBlur + absdiff + THRESH_BINARY (indexing_ui.py:1519-1535).
Only two rank queries per pixel are needed (rank = (k*k+1)//2)::

    median < g-thr  <=>  #{window <= g-thr-1} >= rank
    median > g+thr  <=>  #{window <= g+thr}   <  rank

Rows outside [row_lo, row_hi) of a unit are 0 (the TPU kernel left them
unwritten; the defect path ANDs the result with the ROI either way).

:func:`median_residual_mask` launches ``csrc/median_residual.cu`` for CUDA
tensors and runs :func:`median_residual_mask_plain` for CPU tensors.

:func:`median_blur_u8` is the full median value for any odd k (the port of
:func:`tpu_inspect.ops.median.median_blur_u8`, whose TPU kernel is
``median_pallas.py: median_blur_u8_pallas``): the defect pass's
background for windows with k*k >= 2048. It launches
``csrc/median_blur.cu`` for CUDA tensors and runs
:func:`median_blur_u8_plain` for CPU tensors.

Both kernels run the sliding-histogram walk of ``csrc/median_hist.cuh``:
a thread per column walks a strip of :func:`strip_rows` rows, keeping its
window's histogram and reading the median from it (kernel B then compares
|g - median| with thr, which equals the two rank tests above).
"""

from __future__ import annotations

import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes, check_vector

_MEDIAN_RESIDUAL = Kernel("median_residual")
_MEDIAN_BLUR = Kernel("median_blur")

# elements of the [U, rows, W, k, k] comparison block per chunk (~64 MB)
_CHUNK_ELEMS = 1 << 26


# rows S one thread of kernels B and H walks down a column, the rig's
# choice on the H100 (tools/kernel_bench.py --strips, PERF.md §6): each
# strip warms its window up with k*k samples against 2k a step, so longer
# strips do less work, but a launch's strips (one warp each) must also keep
# the card's 132 SMs busy. S starts at B's 32 (16 on planes above 2^20 px,
# whose ROI is a few hundred of their 3000 rows: B's ROI rows stay on the
# card, unknown to the host) or H's 128, and halves, down to 8, while the
# launch would have fewer than 1024 strips (one unit: the interactive
# calls).
BLUR_STRIP_ROWS = 128
RESIDUAL_STRIP_ROWS = 32
RESIDUAL_STRIP_ROWS_LARGE = 16
MIN_STRIP_ROWS = 8
MIN_STRIPS = 1024
_LARGE_PX = 1 << 20


def strip_rows(kernel: str, u: int, h: int, w: int) -> int:
    """The default strip rows S of ``kernel`` ("median_residual" or
    "median_blur") on [u, h, w] planes."""
    if kernel == "median_blur":
        strip = BLUR_STRIP_ROWS
    else:
        strip = RESIDUAL_STRIP_ROWS_LARGE if h * w > _LARGE_PX else RESIDUAL_STRIP_ROWS
    warps = u * -(-w // 32)
    while strip > MIN_STRIP_ROWS and warps * -(-h // strip) < MIN_STRIPS:
        strip //= 2
    return strip


def _strip(strip, kernel: str, u: int, h: int, w: int) -> int:
    strip = strip_rows(kernel, u, h, w) if strip is None else int(strip)
    if strip < 1 or -(-h // strip) >= 65536:
        raise ValueError(f"{kernel}: strip of {strip} rows for {h} rows beyond the kernel's grid")
    return strip


def _check_k(k: int) -> None:
    if k % 2 != 1 or k < 1 or k * k >= 2048:
        raise ValueError(f"median_residual: k must be odd with k*k < 2048, got {k}")


def _row_bounds(row_lo, row_hi, u, h, device):
    if row_lo is None:
        row_lo = torch.zeros((u,), dtype=torch.int32, device=device)
    if row_hi is None:
        row_hi = torch.full((u,), h, dtype=torch.int32, device=device)
    return row_lo, row_hi


def median_residual_mask_plain(x, k: int, thr: int, row_lo=None, row_hi=None):
    """The plain PyTorch version (same contract): the k x k windows come
    from ``unfold`` of a replicate-padded plane, compared row chunk by row
    chunk so memory stays bounded."""
    _check_k(k)
    u, h, w = x.shape
    row_lo, row_hi = _row_bounds(row_lo, row_hi, u, h, x.device)
    r = k // 2
    rows = torch.arange(-r, h + r, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=x.device).clamp(0, w - 1)
    xp = x[:, rows[:, None], cols[None, :]].to(torch.int16)  # [U, H+2r, W+2r]
    win = xp.unfold(1, k, 1).unfold(2, k, 1)  # view [U, H, W, k, k]
    g = x.to(torch.int16)
    rank = (k * k + 1) // 2
    out = torch.zeros_like(x)
    step = max(1, _CHUNK_ELEMS // max(1, u * w * k * k))
    # only the union of the units' row ranges can be non-zero
    y_lo = max(0, int(row_lo.min())) if u else 0
    y_hi = min(h, int(row_hi.max())) if u else 0
    for y0 in range(y_lo, y_hi, step):
        y1 = min(y_hi, y0 + step)
        wv = win[:, y0:y1]
        gv = g[:, y0:y1, :, None, None]
        c_lo = (wv <= gv - (thr + 1)).sum(dim=(-1, -2))
        c_hi = (wv <= gv + thr).sum(dim=(-1, -2))
        out[:, y0:y1] = torch.where((c_lo >= rank) | (c_hi < rank), 255, 0).to(
            torch.uint8
        )
    y = torch.arange(h, device=x.device)[None, :, None]
    in_rows = (y >= row_lo[:, None, None]) & (y < row_hi[:, None, None])
    return torch.where(in_rows, out, torch.zeros_like(out))


def median_residual_mask(x, k: int, thr: int, row_lo=None, row_hi=None):
    """x [U, H, W] uint8 -> [U, H, W] uint8 0/255 residual mask; optional
    ``row_lo``/``row_hi`` [U] int32 bound the processed rows per unit."""
    return _median_residual(x, k, thr, row_lo, row_hi)


@_MEDIAN_RESIDUAL
def _median_residual(x, k: int, thr: int, row_lo=None, row_hi=None, strip=None):
    """:func:`median_residual_mask` with the kernel's strip rows given
    (None: :func:`strip_rows`); the result does not depend on them. The
    tests and the rig's ``--strips`` sweep call it."""
    check_planes(x, "median_residual")
    _check_k(k)
    u, h, w = x.shape
    row_lo, row_hi = _row_bounds(row_lo, row_hi, u, h, x.device)
    check_vector(row_lo, "median_residual row_lo", u, x.device)
    check_vector(row_hi, "median_residual row_hi", u, x.device)
    strip = _strip(strip, "median_residual", u, h, w)
    if x.device.type == "cpu":
        return median_residual_mask_plain(x, k, thr, row_lo, row_hi)
    if u >= 65536:
        raise ValueError(f"median_residual: {u} units beyond the kernel's grid")
    out = torch.empty_like(x)
    err = build.lib().tik_median_residual(
        x.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(), out.data_ptr(),
        u, h, w, int(k), int(thr), strip,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("median_residual", err)
    _MEDIAN_RESIDUAL.launched()
    return out


def _check_blur_k(k: int) -> None:
    if k % 2 != 1 or k < 1:
        raise ValueError(f"median_blur_u8: k must be odd and >= 1, got {k}")


def median_blur_u8_plain(x, k: int, rows_per_step: int = 8):
    """The plain PyTorch version of :func:`median_blur_u8` (same contract):
    the histogram scan of :func:`tpu_inspect.ops.median._median_blur_u8_scan`.

    A per-column histogram ``[U, W, 256]`` of the vertical window is carried
    down the rows (the entering row added, the leaving row subtracted, both
    clamped: BORDER_REPLICATE); per block of ``rows_per_step`` output rows,
    a cumsum along W (edge columns replicated) turns the snapshots into every
    pixel's window histogram, and the median is the count of bins whose cdf
    is below the rank. Memory is bounded by the block, whatever H or k."""
    _check_blur_k(k)
    if k == 1:
        return x
    u, h, w = x.shape
    r = k // 2
    rank = (k * k + 1) // 2  # 1-based order statistic of the median
    count = torch.int32 if k * k < 2**31 else torch.int64
    bins = torch.arange(256, device=x.device, dtype=torch.int16)
    xi = x.to(torch.int16)

    def onehot_row(y: int) -> torch.Tensor:
        # [U, W, 256] counts of row y, clamped
        row = xi[:, min(max(y, 0), h - 1), :]
        return (row[:, :, None] == bins).to(count)

    colhist = onehot_row(0) * (r + 1)
    for dy in range(1, r + 1):
        colhist += onehot_row(dy)
    out = torch.empty_like(x)
    step = max(1, int(rows_per_step))
    for y0 in range(0, h, step):
        snaps = []
        for y in range(y0, min(h, y0 + step)):
            snaps.append(colhist)
            colhist = colhist + onehot_row(y + r + 1) - onehot_row(y - r)
        ch = torch.stack(snaps, dim=1)  # [U, R, W, 256]
        p = torch.cat([ch[:, :, :1].expand(-1, -1, r, -1), ch,
                       ch[:, :, -1:].expand(-1, -1, r, -1)], dim=2)
        cum = torch.cumsum(p, dim=2, dtype=count)
        cum = torch.cat([torch.zeros_like(cum[:, :, :1]), cum], dim=2)
        # the window at column j covers padded columns j .. j + k - 1
        cdf = torch.cumsum(cum[:, :, k:] - cum[:, :, :-k], dim=3, dtype=count)
        out[:, y0 : y0 + len(snaps)] = (cdf < rank).sum(dim=3).to(torch.uint8)
    return out


def median_blur_u8(x, k: int, rows_per_step: int = 5):
    """x [U, H, W] uint8 -> the exact k x k median [U, H, W] uint8
    (cv2.medianBlur parity, BORDER_REPLICATE: every window holds k*k
    clamped-coordinate samples, even when k exceeds H or W; the median is
    the sample of 1-based rank (k*k+1)//2). Any odd k >= 1; k = 1 returns
    ``x``. ``rows_per_step`` is the output rows of one step of the plain
    version's scan (the JAX package's keyword); the result does not depend
    on it, and the kernel picks its own strip rows."""
    return _median_blur(x, k, rows_per_step=rows_per_step)


@_MEDIAN_BLUR
def _median_blur(x, k: int, strip=None, rows_per_step: int = 5):
    """:func:`median_blur_u8` with the kernel's strip rows given (None:
    :func:`strip_rows`); the result does not depend on them. The tests and
    the rig's ``--strips`` sweep call it."""
    check_planes(x, "median_blur_u8")
    _check_blur_k(k)
    if k == 1:
        return x
    u, h, w = x.shape
    strip = _strip(strip, "median_blur", u, h, w)
    if x.device.type == "cpu":
        return median_blur_u8_plain(x, k, rows_per_step)
    if u >= 65536 or k >= 2**31:
        raise ValueError(f"median_blur_u8: {u} units or k={k} beyond the kernel's grid")
    out = torch.empty_like(x)
    err = build.lib().tik_median_blur(
        x.data_ptr(), out.data_ptr(), u, h, w, int(k), strip,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("median_blur_u8", err)
    _MEDIAN_BLUR.launched()
    return out
