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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_inspect_torch.ops._contour_table import CONTOUR_TABLE_X2
from tpu_inspect_torch.ops.cc import label_components
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
