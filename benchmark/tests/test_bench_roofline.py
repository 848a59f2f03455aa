"""The byte counts of the roofline shares against shapes worked by hand."""

import pytest

from benchmark import roofline
from conftest import small
from benchmark.run import spec, cell_parts


def test_seg_tail_and_blob_filter_bytes_of_the_grid():
    _, cfg, _, _, _ = cell_parts(spec(), "grid48-otsu-threshold.ahead")
    px = 316 * 315
    # blurred crops and 48 int32 thresholds and the zone in; seg masks,
    # the ROI and two 32-byte stats rows a unit out
    assert roofline.seg_tail_bytes(cfg) == 48 * px + 48 * 4 + px + 2 * (48 * px + 48 * 32)
    assert roofline.blob_filter_bytes(cfg) == 3 * 48 * px + 2 * 48 * 4


def test_adaptive_seg_tail_reads_no_threshold():
    cfg = small("grid48-adaptive-canny")
    px = 64 * 60
    assert roofline.seg_tail_bytes(cfg) == 4 * px + px + 2 * (4 * px + 4 * 32)


def test_share_in_percent():
    assert roofline.share_pct(335, 10, 1e-9) == pytest.approx(100.0)
    assert roofline.share_pct(335, 0, 1e-9) is None
    assert roofline.share_pct(335, 10, 0.0) is None
