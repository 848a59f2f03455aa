"""Kernel G — the per-blob Green's-theorem filter and filled paint, given
the fill regions.

Port of :func:`tpu_inspect.ops.blob_pallas.blob_select_pallas` and of the
whole-image Green's filter it shares its function with
(:func:`tpu_inspect.ops.contour._green_filter_tiled` on
``tile_sum_tables_pallas`` + ``tile_paint_pallas``, then the seed flood of
``contour.filter_and_select``): per unit, twice each top-level blob's
contourArea (``ops.contour.contour_sums_x2``), the keep test
``min_x2 <= |2*area| <= max_x2``, the kept fill regions painted 255 (blob
plus everything its external contour encloses) and their pixels counted.

:func:`blob_select` launches ``csrc/blob_select.cu`` for CUDA tensors and
runs :func:`blob_select_plain` for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_inspect_torch.kernels import (
    Kernel,
    as_planes,
    build,
    check_labels,
    check_vector,
    device_constant,
    error_flag,
)
from tpu_inspect_torch.ops._contour_table import CONTOUR_TABLE_X2
from tpu_inspect_torch.ops.contour import contour_sums_x2

_BLOB_SELECT = Kernel("blob_select")


@device_constant(maxsize=8)
def contour_table(device: str) -> torch.Tensor:
    """``CONTOUR_TABLE_X2`` as a contiguous [81, 3] int32 tensor on
    ``device`` (kept per device: kernel C reads it on every call)."""
    return torch.as_tensor(CONTOUR_TABLE_X2, dtype=torch.int32).to(device).contiguous()


@functools.lru_cache(maxsize=None)
def _setup(index: int) -> None:
    """``CONTOUR_TABLE_X2`` into kernel G's constant memory on device
    ``index``, once."""
    table = np.ascontiguousarray(CONTOUR_TABLE_X2, dtype=np.int32)
    with torch.cuda.device(index):
        build.check("blob_select", build.lib().tik_blob_select_setup(table.ctypes.data))


def blob_select_plain(fill_labels, top, ext, max_x2, *, min_x2: int):
    """The plain PyTorch version of :func:`blob_select` (same contract; bool
    ``top`` and ``ext``); it launches no kernel."""
    u, h, w = top.shape
    fill = ~ext
    a2 = contour_sums_x2(top, ext, fill_labels).abs()
    keep = (a2 >= int(min_x2)) & (a2 <= max_x2.to(torch.int64)[:, None])
    lab_flat = torch.where(fill, fill_labels.to(torch.int64), 0).reshape(u, h * w)
    out = keep.gather(1, lab_flat).reshape(u, h, w) & fill  # off-fill masked here
    area = out.sum(dim=(1, 2)).to(torch.int32)
    return out.to(torch.uint8) * 255, area


@_BLOB_SELECT
def blob_select(fill_labels, top, ext, max_x2, *, min_x2: int, err=None):
    """Keep the fill regions whose top-level blob has
    ``min_x2 <= 2*contourArea <= max_x2[u]`` and paint them.

    ``fill_labels`` [U, H, W] int32 are the labels of ``~ext`` (each fill
    region's raster-first pixel index, BIG on the exterior); ``top`` and
    ``ext`` are [U, H, W] bool (or uint8, nonzero = set) planes: the
    top-level blob pixels and the exterior (background 4-connected to the
    border); ``max_x2`` is [U] int32. Returns (painted mask [U, H, W] uint8
    0/255, pixel area [U] int32). ``err`` as for
    :func:`tpu_inspect_torch.ops.flood.propagate`."""
    top = as_planes(top, "blob_select top")
    ext = as_planes(ext, "blob_select ext")
    if ext.shape != top.shape or ext.device != top.device:
        raise ValueError("blob_select: ext must match top in shape and device")
    check_labels(fill_labels, top, "blob_select fill_labels")
    u, h, w = top.shape
    check_vector(max_x2, "blob_select max_x2", u, top.device)
    if top.device.type == "cpu":
        return blob_select_plain(fill_labels, top != 0, ext != 0, max_x2, min_x2=min_x2)
    if u * (h + 1) * (w + 1) >= 2**31:
        raise ValueError(f"blob_select: {u}x{h}x{w} too large for int32 indices")
    dev = top.device
    _setup(dev.index)
    out = torch.empty((u, h, w), dtype=torch.uint8, device=dev)
    area = torch.empty((u,), dtype=torch.int32, device=dev)
    # one region-sum slot per 2x2 block (the block of the region's label
    # pixel: no block holds two regions' first pixels), zeroed by the launcher
    sums = torch.empty((u * ((h + 1) // 2) * ((w + 1) // 2),), dtype=torch.int64, device=dev)
    flag = error_flag(dev) if err is None else err
    code = build.lib().tik_blob_select(
        fill_labels.data_ptr(), top.data_ptr(), ext.data_ptr(), max_x2.data_ptr(),
        out.data_ptr(), area.data_ptr(), sums.data_ptr(), flag.data_ptr(), u, h, w,
        int(min_x2), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("blob_select", code)
    _BLOB_SELECT.launched()
    if err is None:
        build.check_bounded("blob_select", flag)
    return out, area
