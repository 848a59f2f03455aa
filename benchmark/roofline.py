"""The least bytes a function of the frame's program must move, from the
configuration's shapes, and the card's peak rate: a kernel's share of its
roofline is the time those bytes take at the peak over the time its
kernels took. Each input byte is counted as read once and each output
byte as written once, whatever the kernels that implement the function
read again; so a share cannot pass 100% unless the time leaves out work.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet
_STATS = 8 * 4  # a unit's int32 stats row of the seg and ROI tails


def _units(cfg: dict) -> tuple[int, int]:
    g = cfg["grid"]
    u = g["units_x"] * g["units_y"] * g["blocks_x"] * g["blocks_y"]
    _, _, w, h = g["base_unit"]
    return u, h * w


def seg_tail_bytes(cfg: dict) -> int:
    """The seg tail and the ROI tail of one frame: the thresholded planes
    in (the blurred crops and an int32 threshold a unit for Otsu, the
    adaptive plane otherwise) with the exclusion zone, the seg masks and
    the ROI out with a stats row each."""
    u, px = _units(cfg)
    thr = 4 * u if cfg["segmentation"]["method"] == "otsu" else 0
    zone = px if cfg["exclusions"] else 0
    return u * px + thr + zone + 2 * (u * px + u * _STATS)


def blob_filter_bytes(cfg: dict) -> int:
    """The blob filter of one frame: the candidates, the ROI and an int32
    area cap a unit in; the kept blobs and an int32 area a unit out."""
    u, px = _units(cfg)
    return 2 * u * px + 4 * u + u * px + 4 * u


def share_pct(nbytes: int, frames: int, kernel_s: float) -> float | None:
    """The roofline share in percent, or None when no kernel ran."""
    if kernel_s <= 0 or frames <= 0:
        return None
    return 100.0 * nbytes * frames / HBM_BYTES_PER_S / kernel_s
