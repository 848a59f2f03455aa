"""Batched external-contour analysis (findContours(RETR_EXTERNAL) +
contourArea without border tracing), [U, H, W].

Port of :func:`tpu_inspect.ops.contour.analyze_blobs` (``contour.py:46-141``):

1. exterior = background 4-connected to the border (kernel D, border form);
   fill regions = the 8-connected components of ~exterior (kernel E), each
   one top-level blob plus everything its external contour encloses;
2. a fg pixel is top-level iff its fg-component label (kernel E) equals its
   fill-region label (both are raster-first pixel indices);
3. twice each blob's contourArea is an exact integer sum of crack-vertex
   contributions from ``CONTOUR_TABLE_X2`` (Green's theorem).

:func:`contour_sums_x2` is that last step in plain torch ops; it launches
nothing, so kernel G's plain version (``ops.blob_select.blob_select_plain``,
which kernel C's plain version calls) shares it.

:func:`select_blobs` paints kept blobs' fill regions (kernel D seeded by
their roots), and :func:`filter_and_select` is the whole filter: kernel C
on a unit whose sums fit it, else :func:`fill_regions` (kernels D, E, D)
and kernel G, the engine's whole-image composition.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_inspect_torch.kernels import as_planes
from tpu_inspect_torch.ops._contour_table import CONTOUR_TABLE_X2
from tpu_inspect_torch.ops.cc import label_components
from tpu_inspect_torch.ops.flood import propagate
from tpu_inspect_torch.ops.hole_fill import exterior_background


@dataclass
class BlobAnalysis:
    """Per-unit top-level blob decomposition (tensors on the input's device)."""

    fill_labels: torch.Tensor  # [U, H, W] int32 root per fill region (BIG on ext)
    fill_mask: torch.Tensor  # [U, H, W] bool (~exterior)
    contour_area_x2: torch.Tensor  # [U, H*W] int32: 2*contourArea per root
    is_root: torch.Tensor  # [U, H*W] bool marks valid top-level blob roots

    @property
    def contour_area(self) -> torch.Tensor:
        """cv2.contourArea per root as float64 (areas are half-integers)."""
        return self.contour_area_x2.to(torch.float64) * 0.5


def contour_sums_x2(top, ext, fill_labels) -> torch.Tensor:
    """Signed twice-contourArea of each top-level blob, summed into its fill
    region's root slot: [U, H*W] int64 (0 where no root).

    Each crack vertex (vy, vx) sees pixels (vy-1..vy, vx-1..vx) in three
    states (2 top-level blob, 1 exterior, 0 other; out of plane is
    exterior) and adds its table contribution to the top-level blob in its
    window (a window never holds two regions' top-level pixels).
    """
    u, h, w = top.shape
    hw = h * w
    dev = top.device
    state = torch.where(top, 2, torch.where(ext, 1, 0)).to(torch.int64)
    sp = torch.ones((u, h + 2, w + 2), dtype=torch.int64, device=dev)
    sp[:, 1:-1, 1:-1] = state
    cfg = sp[:, :-1, :-1] + 3 * sp[:, :-1, 1:] + 9 * sp[:, 1:, :-1] + 27 * sp[:, 1:, 1:]
    tbl = torch.as_tensor(CONTOUR_TABLE_X2, dtype=torch.int64).to(dev)
    vy = torch.arange(h + 1, device=dev, dtype=torch.int64)[None, :, None]
    vx = torch.arange(w + 1, device=dev, dtype=torch.int64)[None, None, :]
    contrib = tbl[cfg, 0] + tbl[cfg, 1] * vx + tbl[cfg, 2] * vy

    lab_top = torch.where(top, fill_labels.to(torch.int64), -1)
    lp = torch.full((u, h + 2, w + 2), -1, dtype=torch.int64, device=dev)
    lp[:, 1:-1, 1:-1] = lab_top
    attr = torch.maximum(
        torch.maximum(lp[:, :-1, :-1], lp[:, :-1, 1:]),
        torch.maximum(lp[:, 1:, :-1], lp[:, 1:, 1:]),
    )
    idx = torch.where(attr >= 0, attr, hw).reshape(u, -1)  # spill bucket hw
    sums = torch.zeros((u, hw + 1), dtype=torch.int64, device=dev)
    sums.scatter_add_(1, idx, contrib.reshape(u, -1))
    return sums[:, :hw]


def analyze_blobs(fg: torch.Tensor, *, err=None) -> BlobAnalysis:
    """fg [U, H, W] bool candidate mask -> per-blob contour areas. On CUDA
    tensors it launches kernel D once and kernel E twice (``err`` as for
    :func:`tpu_inspect_torch.ops.flood.propagate`)."""
    u, h, w = fg.shape
    hw = h * w
    ext = exterior_background(fg, err=err)
    fill = ~ext
    fill_labels = label_components(fill, err=err)
    fg_labels = label_components(fg, err=err)
    top = fg & (fg_labels == fill_labels)
    areas_x2 = contour_sums_x2(top, ext, fill_labels).abs().to(torch.int32)
    lin = torch.arange(hw, device=fg.device, dtype=torch.int32)[None, :]
    is_root = top.reshape(u, hw) & (fill_labels.reshape(u, hw) == lin)
    return BlobAnalysis(
        fill_labels=fill_labels,
        fill_mask=fill,
        contour_area_x2=areas_x2,
        is_root=is_root,
    )


def select_blobs(analysis: BlobAnalysis, keep: torch.Tensor) -> torch.Tensor:
    """keep: [U, H*W] bool per root -> the kept blobs' fill regions (blob
    plus enclosed holes and nested content, filled drawContours of the
    external polygon), [U, H, W] bool: kernel D, 8-connected through the
    fill mask, seeded by the kept roots."""
    u, h, w = analysis.fill_mask.shape
    seeds = (keep & analysis.is_root).reshape(u, h, w)
    return propagate(seeds, analysis.fill_mask, conn8=True)


def fill_regions(m: torch.Tensor, err=None):
    """(fill labels int32, top-level blob pixels bool, exterior bool) of a
    [U, H, W] bool candidate plane: kernel D for the exterior; kernel E for
    the fill labels; kernel D again, seeded with each fill region's
    raster-first pixel (always a pixel of its top-level blob), for the
    top-level blobs through the candidates, 8-connected (the JAX package's
    ``contour.py:596-602``). ``err`` as for
    :func:`tpu_inspect_torch.ops.flood.propagate`."""
    u, h, w = m.shape
    ext = exterior_background(m, err=err)
    fill_labels = label_components(~ext, err=err)
    lin = torch.arange(h * w, dtype=torch.int32, device=m.device).reshape(1, h, w)
    top = propagate(m & (fill_labels == lin), m, conn8=True, err=err)
    return fill_labels, top, ext


def filter_and_select(fg: torch.Tensor, min_area_x2, max_area_x2):
    """The blob filter on a [U, H, W] bool (or uint8, nonzero = set)
    candidate plane: keep the top-level blobs with ``min_area_x2 <=
    2*contourArea <= max_area_x2[u]`` and paint their fill regions.
    ``min_area_x2`` is an int, ``max_area_x2`` a [U] vector. Returns
    (out_mask [U, H, W] bool, found [U] bool). Kernel C where its int32
    sums fit the unit, else :func:`fill_regions` then kernel G."""
    # imported here: ops.blob_select imports this module
    from tpu_inspect_torch.ops.blob import blob_filter, blob_filter_fits
    from tpu_inspect_torch.ops.blob_select import blob_select

    fg = as_planes(fg, "filter_and_select")
    _, h, w = fg.shape
    max_x2 = torch.as_tensor(max_area_x2, dtype=torch.int32, device=fg.device).contiguous()
    if blob_filter_fits(h, w):
        out, area = blob_filter(fg, max_x2, min_x2=int(min_area_x2))
    else:
        out, area = blob_select(*fill_regions(fg != 0), max_x2, min_x2=int(min_area_x2))
    return out > 0, area > 0
