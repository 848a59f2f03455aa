"""Kernel A — the per-unit segmentation / defect-ROI tail.

Port of :func:`tpu_inspect.ops.fused_pallas.seg_tail_pallas` (and of its
lane-paired twin, whose pairing exists only for TPU lanes). Per unit:

    x <= thr (or x > 0) -> erode/dilate stage chain -> optional hole fill
    -> largest 8-connected component

returning the processed mask (or, with ``out_largest``, the largest
component alone) and a stats row in the lane order of the TPU kernel
(``fused_pallas.py:104-113``): area, sx, sy, has_fg, row_lo, row_hi,
col_lo, col_hi (an empty unit gives (0, 0, 0, 0, H, 0, W, 0)).

:func:`seg_tail` launches the CUDA kernel (``csrc/seg_tail.cu``) for CUDA
tensors and runs :func:`seg_tail_plain` for CPU tensors.

Kernel K, :func:`seg_roi_tail`, is the port of
:func:`tpu_inspect.ops.fused_pallas.seg_roi_tail_paired_pallas`: the seg
tail, the shared exclusion zone and the ROI tail of the reference capture
chained in one launch (``csrc/seg_roi_tail.cu``), the seg mask never
written out and read back between the two tails. Its plain version is
:func:`seg_roi_tail_plain`.
"""

from __future__ import annotations

import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes, check_vector, error_flag
from tpu_inspect_torch.ops.cc import largest_component
from tpu_inspect_torch.ops.hole_fill import exterior_background_plain
from tpu_inspect_torch.ops.morphology import morph_chain_plain, stage_program_tensor

_SEG_TAIL = Kernel("seg_tail")
_SEG_ROI_TAIL = Kernel("seg_roi_tail")

STAT_FIELDS = ("area", "sx", "sy", "has_fg", "row_lo", "row_hi", "col_lo", "col_hi")


def tail_mask(x, stages=(), thr=None, chain=morph_chain_plain) -> torch.Tensor:
    """The tail's head and stage chain: ``x <= thr`` (or ``x != 0`` without
    ``thr``), then the erode/dilate stage chain, by ``chain`` (the plain
    version keeps :func:`tpu_inspect_torch.ops.morphology.morph_chain_plain`;
    the whole-image route passes kernel I's ``morph_chain``, which fuses the
    head); [U, H, W] bool."""
    return chain(x, stages, thr=thr)


def seg_tail_fits(h: int, w: int) -> bool:
    """Whether an h x w unit fits the kernel's int32 coordinate sums."""
    return max(h, w) * h * w < 2**31


def tail_unit_words(h: int, w: int) -> int:
    """32-bit words of one unit's planes in kernels A and K
    (``csrc/tail.cuh: tail_unit_words``): five bit planes and the 2x2 block
    grid's parents. The launcher keeps them in shared memory where they fit
    and in the global scratch the wrapper allocates otherwise."""
    return 5 * h * ((w + 31) // 32) + ((h + 1) // 2) * ((w + 1) // 2)


def seg_tail_plain(x, stages=(), fill=False, out_largest=False, thr=None):
    """The plain PyTorch version of :func:`seg_tail` (same contract); it
    launches no kernel."""
    m = tail_mask(x, stages, thr)
    if fill:
        m = m | ~exterior_background_plain(m)
    best, stats = largest_component(m)
    out = best if out_largest else m
    return out.to(torch.uint8) * 255, stats.to(torch.int32)


@_SEG_TAIL
def seg_tail(x, stages=(), fill=False, out_largest=False, thr=None, *, err=None):
    """x [U, H, W] uint8 (gray with ``thr`` [U] int32, else any >0 = fg) ->
    (mask [U, H, W] uint8 0/255, stats [U, 8] int32).

    ``err`` (CUDA only): a :func:`tpu_inspect_torch.kernels.error_flag` the
    kernel sets if a union-find walk passes its bound, read by the caller
    where it copies results out; without one the wrapper reads its own
    right after the launch."""
    check_planes(x, "seg_tail")
    u, h, w = x.shape
    if thr is not None:
        check_vector(thr, "seg_tail thr", u, x.device)
    if x.device.type == "cpu":
        return seg_tail_plain(x, stages, fill, out_largest, thr)
    if not seg_tail_fits(h, w):
        raise ValueError(f"seg_tail: unit {h}x{w} too large for int32 sums")
    out = torch.empty_like(x)
    stats = torch.empty((u, 8), dtype=torch.int32, device=x.device)
    words = u * tail_unit_words(h, w)
    scratch = torch.empty((words,), dtype=torch.int32, device=x.device)
    flag = error_flag(x.device) if err is None else err
    prog = stage_program_tensor(tuple(stages), str(x.device))
    code = build.lib().tik_seg_tail(
        x.data_ptr(), None if thr is None else thr.data_ptr(), prog.data_ptr(),
        out.data_ptr(), stats.data_ptr(), scratch.data_ptr(), words, flag.data_ptr(),
        u, h, w, int(thr is not None), int(bool(fill)), int(bool(out_largest)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("seg_tail", code)
    _SEG_TAIL.launched()
    if err is None:
        build.check_bounded("seg_tail", flag)
    return out, stats


def seg_roi_tail_plain(x, stages, roi_stages, thr, zone=None):
    """The plain PyTorch version of :func:`seg_roi_tail` (same contract):
    ``seg_tail_plain(fill=True)``, the zone, then ``seg_tail_plain`` of the
    ROI stages with ``out_largest``. It launches no kernel."""
    mask, stats = seg_tail_plain(x, stages, fill=True, thr=thr)
    if zone is not None:
        mask = torch.where(zone > 0, torch.zeros_like(mask), mask)
    roi, roi_stats = seg_tail_plain(mask, roi_stages, out_largest=True)
    return mask, stats, roi, roi_stats


@_SEG_ROI_TAIL
def seg_roi_tail(x, stages, roi_stages, thr, zone=None, *, err=None):
    """The chained seg tail + shared exclusion zone + ROI tail of the
    reference capture.

    x [U, H, W] uint8 blurred gray, ``thr`` [U] int32 (THRESH_BINARY_INV,
    x <= thr), ``stages`` the seg stage chain (filled after it), ``roi_stages``
    the ROI's erode chain, ``zone`` an optional [H, W] uint8 or bool plane
    shared by every unit (> 0 excluded). Returns (seg mask [U, H, W] uint8
    0/255 after the zone, seg stats [U, 8] int32 taken BEFORE the zone, ROI
    mask [U, H, W] uint8 0/255 (the largest 8-CC of the eroded post-zone
    mask), ROI stats [U, 8] int32), the rows in :data:`STAT_FIELDS` order.
    The JAX function's 12 outputs are seg mask, seg stats[:, :4] (has_fg as
    bool), ROI mask, ROI stats[:, 0], [:, 3] (bool) and [:, 4:8]. ``err``
    as for :func:`seg_tail`."""
    check_planes(x, "seg_roi_tail")
    u, h, w = x.shape
    check_vector(thr, "seg_roi_tail thr", u, x.device)
    if zone is not None:
        if zone.dtype == torch.bool:
            zone = zone.view(torch.uint8)
        if (zone.dtype != torch.uint8 or tuple(zone.shape) != (h, w)
                or not zone.is_contiguous() or zone.device != x.device):
            raise ValueError(
                f"seg_roi_tail: expected a contiguous [{h}, {w}] uint8 zone on "
                f"{x.device}, got {zone.dtype} {tuple(zone.shape)} on {zone.device}"
            )
    if x.device.type == "cpu":
        return seg_roi_tail_plain(x, stages, roi_stages, thr, zone)
    if not seg_tail_fits(h, w):
        raise ValueError(f"seg_roi_tail: unit {h}x{w} too large for int32 sums")
    mask, roi = torch.empty_like(x), torch.empty_like(x)
    stats = torch.empty((u, 8), dtype=torch.int32, device=x.device)
    roi_stats = torch.empty((u, 8), dtype=torch.int32, device=x.device)
    words = u * tail_unit_words(h, w)
    scratch = torch.empty((words,), dtype=torch.int32, device=x.device)
    flag = error_flag(x.device) if err is None else err
    prog = stage_program_tensor(tuple(stages), str(x.device))
    roi_prog = stage_program_tensor(tuple(roi_stages), str(x.device))
    code = build.lib().tik_seg_roi_tail(
        x.data_ptr(), thr.data_ptr(), prog.data_ptr(), roi_prog.data_ptr(),
        None if zone is None else zone.data_ptr(), mask.data_ptr(), stats.data_ptr(),
        roi.data_ptr(), roi_stats.data_ptr(), scratch.data_ptr(), words, flag.data_ptr(),
        u, h, w, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("seg_roi_tail", code)
    _SEG_ROI_TAIL.launched()
    if err is None:
        build.check_bounded("seg_roi_tail", flag)
    return mask, stats, roi, roi_stats
