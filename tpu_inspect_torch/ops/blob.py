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

import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes, check_vector, error_flag
from tpu_inspect_torch.ops.blob_select import blob_select_plain, contour_table
from tpu_inspect_torch.ops.cc import label_components_plain
from tpu_inspect_torch.ops.hole_fill import exterior_background_plain
from tpu_inspect_torch.ops.morphology import (
    morph_chain_plain,
    open_stages,
    stage_program_tensor,
)

_BLOB_FILTER = Kernel("blob_filter")


def candidate_mask(fg, roi=None, pre_open=False, chain=morph_chain_plain) -> torch.Tensor:
    """The filter's input: ``fg != 0`` ANDed with ``roi != 0`` (when given),
    then the 3x3-ellipse open (with ``pre_open``), by ``chain`` (the plain
    version keeps :func:`tpu_inspect_torch.ops.morphology.morph_chain_plain`;
    the whole-image route and the diagnostic pass on the card pass kernel
    I's ``morph_chain``, which fuses the ROI AND); [U, H, W] bool."""
    return chain(fg, open_stages(3) if pre_open else (), roi=roi)


def blob_filter_plain(fg, max_x2, *, min_x2: int, roi=None, pre_open=False):
    """The plain PyTorch version of :func:`blob_filter` (same contract); it
    launches no kernel."""
    m = candidate_mask(fg, roi, pre_open)
    ext = exterior_background_plain(m)
    fill_lab = label_components_plain(~ext)
    # the raster-first pixel of a fill region is fg and is also the
    # raster-first pixel of the region's top-level blob
    top = m & (label_components_plain(m) == fill_lab)
    return blob_select_plain(fill_lab, top, ext, max_x2, min_x2=min_x2)


def blob_filter_fits(h: int, w: int) -> bool:
    """Whether an h x w unit fits the kernel's int32 Green's sums (a sum is
    at most (h+1)*(w+1) contributions of at most h+w+1 each)."""
    return (h + 1) * (w + 1) * (h + w + 2) < 2**31


def blob_unit_words(h: int, w: int) -> int:
    """32-bit words of one unit's planes in kernel C
    (``csrc/blob_filter.cu: blob_unit_words``): two bit planes and a region
    holding five scratch planes, later the two labelings' parents. The
    launcher keeps them in shared memory where they fit and in the global
    scratch the wrapper allocates otherwise."""
    n = h * ((w + 31) // 32)
    return 2 * n + max(2 * ((h + 1) // 2) * ((w + 1) // 2), 5 * n)


@_BLOB_FILTER
def blob_filter(fg, max_x2, *, min_x2: int, roi=None, pre_open=False, err=None):
    """fg [U, H, W] uint8 candidate plane, max_x2 [U] int32 ->
    (kept filled mask [U, H, W] uint8 0/255, pixel area [U] int32).

    ``roi`` ([U, H, W] uint8, any >0 inside) ANDs the candidate with the
    ROI and ``pre_open`` applies the 3x3-ellipse open first (the defect
    path's form). ``err`` as for :func:`tpu_inspect_torch.ops.fused.seg_tail`."""
    check_planes(fg, "blob_filter")
    u, h, w = fg.shape
    if roi is not None:
        check_planes(roi, "blob_filter roi")
        if roi.shape != fg.shape or roi.device != fg.device:
            raise ValueError("blob_filter: roi must match fg in shape and device")
    check_vector(max_x2, "blob_filter max_x2", u, fg.device)
    if fg.device.type == "cpu":
        return blob_filter_plain(fg, max_x2, min_x2=min_x2, roi=roi, pre_open=pre_open)
    if not blob_filter_fits(h, w):
        raise ValueError(f"blob_filter: unit {h}x{w} too large for int32 sums")
    out = torch.empty_like(fg)
    area = torch.empty((u,), dtype=torch.int32, device=fg.device)
    words = u * blob_unit_words(h, w)
    scratch = torch.empty((words,), dtype=torch.int32, device=fg.device)
    flag = error_flag(fg.device) if err is None else err
    stages = open_stages(3) if pre_open else ()
    prog = stage_program_tensor(stages, str(fg.device))
    code = build.lib().tik_blob_filter(
        fg.data_ptr(), None if roi is None else roi.data_ptr(), max_x2.data_ptr(),
        contour_table(str(fg.device)).data_ptr(), prog.data_ptr(), out.data_ptr(),
        area.data_ptr(), scratch.data_ptr(), words, flag.data_ptr(), u, h, w,
        int(min_x2), int(roi is not None),
        torch.cuda.current_stream(fg.device).cuda_stream,
    )
    build.check("blob_filter", code)
    _BLOB_FILTER.launched()
    if err is None:
        build.check_bounded("blob_filter", flag)
    return out, area
