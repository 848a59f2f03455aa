"""Kernel C — the defect blob filter.

Port of :func:`tpu_inspect.ops.blob_pallas.blob_filter_pallas` with
:func:`tpu_inspect.ops.contour.filter_and_select` semantics
(findContours(RETR_EXTERNAL) + contourArea filter + filled drawContours,
indexing_ui.py:1528-1558), per unit:

1. optional ROI AND and 3x3-ellipse open of the candidate plane;
2. exterior = background 4-connected to the border; fill regions = the
   8-connected components of ~exterior (a top-level blob plus everything
   its external contour encloses);
3. a region's top-level blob is the fg component of its raster-first pixel;
4. twice the blob's contourArea is a sum of crack-vertex contributions from
   ``CONTOUR_TABLE_X2`` (Green's theorem, exact integers);
5. regions with min_x2 <= |2*area| <= max_x2 are painted 255, and the
   painted pixels are counted (the verdict uses pixel area).

:func:`blob_filter` launches ``csrc/blob_filter.cu`` for CUDA tensors and
runs :func:`blob_filter_plain` for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from tpu_inspect_torch.kernels import LAUNCHES, build, check_planes, check_vector
from tpu_inspect_torch.ops._contour_table import CONTOUR_TABLE_X2
from tpu_inspect_torch.ops.cc import label_components_plain
from tpu_inspect_torch.ops.contour import contour_sums_x2
from tpu_inspect_torch.ops.hole_fill import exterior_background_plain
from tpu_inspect_torch.ops.morphology import (
    apply_stages,
    open_stages,
    stage_program_tensor,
)


@functools.lru_cache(maxsize=8)
def _table_tensor(device: str) -> torch.Tensor:
    return torch.as_tensor(CONTOUR_TABLE_X2, dtype=torch.int32).to(device).contiguous()


def _head(fg, roi, pre_open):
    v = fg if roi is None else torch.where(roi > 0, fg, torch.zeros_like(fg))
    if pre_open:
        v = apply_stages(v, open_stages(3))
    return v > 0


def blob_filter_plain(fg, max_x2, *, min_x2: int, roi=None, pre_open=False):
    """The plain PyTorch version of :func:`blob_filter` (same contract); it
    launches no kernel."""
    m = _head(fg, roi, pre_open)
    u, h, w = m.shape
    hw = h * w
    ext = exterior_background_plain(m)
    fill = ~ext
    fill_lab = label_components_plain(fill).to(torch.int64)
    fg_lab = label_components_plain(m).to(torch.int64)
    # the raster-first pixel of a fill region is fg and is also the
    # raster-first pixel of the region's top-level blob
    top = m & (fg_lab == fill_lab)
    a2 = contour_sums_x2(top, ext, fill_lab).abs()
    keep = (a2 >= int(min_x2)) & (a2 <= max_x2.to(torch.int64)[:, None])
    lab_flat = torch.where(fill, fill_lab, 0).reshape(u, hw)  # off-fill: masked below
    out = keep.gather(1, lab_flat).reshape(u, h, w) & fill
    area = out.sum(dim=(1, 2)).to(torch.int32)
    return out.to(torch.uint8) * 255, area


def blob_filter(fg, max_x2, *, min_x2: int, roi=None, pre_open=False):
    """fg [U, H, W] uint8 candidate plane, max_x2 [U] int32 ->
    (kept filled mask [U, H, W] uint8 0/255, pixel area [U] int32).

    ``roi`` ([U, H, W] uint8, any >0 inside) ANDs the candidate with the
    ROI and ``pre_open`` applies the 3x3-ellipse open first (the defect
    path's form)."""
    check_planes(fg, "blob_filter")
    u, h, w = fg.shape
    if roi is not None:
        check_planes(roi, "blob_filter roi")
        if roi.shape != fg.shape or roi.device != fg.device:
            raise ValueError("blob_filter: roi must match fg in shape and device")
    check_vector(max_x2, "blob_filter max_x2", u, fg.device)
    if fg.device.type == "cpu":
        return blob_filter_plain(fg, max_x2, min_x2=min_x2, roi=roi, pre_open=pre_open)
    if (h + 1) * (w + 1) * (h + w + 2) >= 2**31:
        raise ValueError(f"blob_filter: unit {h}x{w} too large for int32 sums")
    nb = ((h + 1) // 2) * ((w + 1) // 2)
    out = torch.empty_like(fg)
    area = torch.empty((u,), dtype=torch.int32, device=fg.device)
    planes = torch.empty(u * (3 * h * w + nb), dtype=torch.uint8, device=fg.device)
    blocks = torch.empty(u * 5 * nb, dtype=torch.int32, device=fg.device)
    stages = open_stages(3) if pre_open else ()
    prog = stage_program_tensor(stages, str(fg.device))
    err = build.lib().tik_blob_filter(
        fg.data_ptr(), None if roi is None else roi.data_ptr(), max_x2.data_ptr(),
        _table_tensor(str(fg.device)).data_ptr(), prog.data_ptr(), out.data_ptr(),
        area.data_ptr(), planes.data_ptr(), blocks.data_ptr(), u, h, w,
        int(min_x2), int(roi is not None),
        torch.cuda.current_stream(fg.device).cuda_stream,
    )
    build.check("blob_filter", err)
    LAUNCHES["blob_filter"] += 1
    return out, area
