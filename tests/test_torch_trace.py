"""The port's spans (``tpu_inspect_torch.utils.trace``) on the CPU: off they
record nothing and cost one shared null context; on, a call of the
one-capture program is one root span named by its route, with its stages
under it and each hand kernel's wrapper inside a stage; glue plus kernel
time is the root span; the buffer drops its oldest record; the stream
spans its upload, slot wait and fetch a frame."""

import numpy as np
import pytest
import torch

from tpu_inspect_torch import engine as teng
from tpu_inspect_torch import streaming
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.synthetic import make_mold_image
from tpu_inspect_torch.utils import logging as tlog
from tpu_inspect_torch.utils import trace

GRID = GridParams(base_unit=(6, 8, 64, 60), units_x=2, units_y=2, unit_space_x=10,
                  unit_space_y=12)
EXCL = [{"shape": "circle", "cx": 30, "cy": 30, "r": 6}]
IMAGE = make_mold_image(GRID, (150, 160), seed=3, defect_rate=0.6)

SPLIT_STAGES = ["gather", "seg.head", "seg.tail", "seg.align", "defect.roi", "defect.cand",
                "defect.filter"]
# the route, what sets it, its stages in order, and the spans each stage
# opens directly: its wrappers' kernel spans (the plain versions on the CPU),
# on the whole-image route its ``whole.*`` spans
ROUTES = {
    "chained": ("frame.chained", dict(chain=True),
                ["gather", "seg.head", "seg.align", "seg.tail", "defect.cand", "defect.filter"],
                {"seg.head": ["kernel.gauss_blur", "kernel.otsu"],
                 "seg.tail": ["kernel.seg_roi_tail"],
                 "defect.cand": ["kernel.median_residual"],
                 "defect.filter": ["kernel.blob_filter"]}),
    "split": ("frame.split", dict(),
              SPLIT_STAGES,
              {"seg.head": ["kernel.gauss_blur", "kernel.otsu"], "seg.tail": ["kernel.seg_tail"],
               "defect.roi": ["kernel.seg_tail"], "defect.cand": ["kernel.median_residual"],
               "defect.filter": ["kernel.blob_filter"]}),
    "split adaptive canny": ("frame.split", dict(seg="adaptive", defect="canny"),
                             SPLIT_STAGES,
                             {"seg.head": ["kernel.gauss_blur", "kernel.adaptive"],
                              "seg.tail": ["kernel.seg_tail"], "defect.roi": ["kernel.seg_tail"],
                              "defect.cand": ["kernel.canny_head", "kernel.propagate"],
                              "defect.filter": ["kernel.blob_filter"]}),
    "whole": ("frame.whole", dict(whole=True),
              SPLIT_STAGES,
              {"seg.head": ["kernel.gauss_blur", "kernel.otsu"],
               "seg.tail": ["whole.mask", "whole.fill", "whole.label", "whole.stats"],
               "defect.roi": ["whole.mask", "whole.label", "whole.stats"],
               "defect.cand": ["kernel.median_residual"],
               "defect.filter": ["whole.mask", "whole.regions", "whole.select"]}),
}


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.reset()


def _program(chain=False, whole=False, seg="otsu", defect="threshold"):
    """One call of the one-capture program on the small image, the
    reference-aligned frame of the stream."""
    saved = teng._ENABLE_CHAIN, teng.WHOLE_MIN_PX
    teng._ENABLE_CHAIN = chain
    if whole:
        teng.WHOLE_MIN_PX = 1000
    try:
        return teng._inspect_image_device(
            torch.from_numpy(IMAGE), torch.from_numpy(grid_origins(GRID)), (60, 64),
            SegmentationParams(method=seg).validated(), DefectParams(method=defect).validated(),
            EXCL, None, True, True)
    finally:
        teng._ENABLE_CHAIN, teng.WHOLE_MIN_PX = saved


def _outermost_kernels(recs):
    return [r for r in recs if r[2].startswith("kernel.") and "kernel." not in r[1]]


def test_off_records_nothing_and_shares_one_null_context():
    trace.enable(False)
    trace.reset()
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as got:
        assert got is None
    _program(chain=True)
    assert trace.records() == [] and trace.dropped == 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_root_a_call_named_by_its_route(tracing, route):
    root_name, kw, stages, kernels = ROUTES[route]
    _program(**kw)
    recs = trace.records()
    roots = [r for r in recs if r[1] == ""]
    assert [r[2] for r in roots] == [root_name]
    fid = roots[0][0]
    assert all(r[0] == fid for r in recs)
    got = sorted((r for r in recs if r[1] == root_name), key=lambda r: r[3])
    assert [r[2] for r in got] == stages
    for stage, names in kernels.items():
        inside = [r[2] for r in sorted(recs, key=lambda r: r[3])
                  if r[1] == f"{root_name}/{stage}"]
        assert inside == names, stage


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_spans_nest_inside_stages(tracing, route):
    root_name, kw, stages, _ = ROUTES[route]
    _program(**kw)
    recs = trace.records()
    by_path = {(r[1] + "/" if r[1] else "") + r[2]: r for r in recs}
    kern = [r for r in recs if r[2].startswith("kernel.")]
    assert kern
    for r in kern:
        root, stage = r[1].split("/")[:2]
        assert root == root_name and stage in stages
        outer = by_path[r[1]]
        assert outer[3] <= r[3] <= r[4] <= outer[4]


@pytest.mark.parametrize("route", ["chained", "split"])
def test_glue_plus_kernel_is_the_root_span(tracing, route):
    _program(**ROUTES[route][1])
    recs = trace.records()
    (root,) = [r for r in recs if r[1] == ""]
    kernel = sum(r[4] - r[3] for r in _outermost_kernels(recs))
    glue = (root[4] - root[3]) - kernel
    assert 0 < kernel < root[4] - root[3] and glue > 0
    assert glue + kernel == root[4] - root[3]


def test_cpu_spans_count_no_launch(tracing):
    reset_launches()
    _program(chain=True)
    assert not any(LAUNCHES.values())
    assert any(r[2] == "kernel.seg_roi_tail" for r in trace.records())


def test_full_buffer_drops_the_oldest_and_counts(monkeypatch, tracing):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    trace.reset()
    for i in range(6):
        with trace.span(f"s{i}"):
            pass
    assert [r[2] for r in trace.records()] == ["s2", "s3", "s4", "s5"]
    assert trace.dropped == 2
    ids = [r[0] for r in trace.records()]
    assert ids == sorted(ids) and len(set(ids)) == 4  # each a root of its own
    trace.reset()
    assert trace.records() == [] and trace.dropped == 0


def test_stream_spans_upload_wait_and_fetch_a_frame(tracing):
    frames = [IMAGE, make_mold_image(GRID, (150, 160), seed=4), IMAGE, IMAGE]
    saved = teng._ENABLE_CHAIN
    teng._ENABLE_CHAIN = True
    try:
        out = list(streaming.stream_inspect(frames, GRID, exclusions=EXCL, prefetch=2,
                                            device="cpu"))
    finally:
        teng._ENABLE_CHAIN = saved
    assert [r.index for r in out] == [0, 1, 2, 3]
    recs = trace.records()
    roots = [r[2] for r in sorted((r for r in recs if r[1] == ""), key=lambda r: r[3])]
    # frames 0-2 go in before the oldest is fetched (prefetch 2), then one
    # frame in, one out; the rest fetched at the end
    up, fr, fe = "stream.upload", "frame.chained", "stream.fetch"
    assert roots == [up, fr, up, fr, up, fr, fe, up, fr, fe, fe, fe]
    waits = [r for r in recs if r[2] == "stream.slot_wait"]
    assert len(waits) == 4 and all(r[1] == up for r in waits)


def test_stage_timer_opens_a_span_and_logs_as_before(tracing):
    lines = []
    with tlog.stage_timer("stage", lines.append):
        with trace.span("inner"):
            pass
    assert len(lines) == 1 and lines[0].startswith("stage: ") and lines[0].endswith(" ms")
    recs = trace.records()
    assert [(r[1], r[2]) for r in recs] == [("stage", "inner"), ("", "stage")]
    assert np.isclose(float(lines[0].split()[1]), (recs[1][4] - recs[1][3]) / 1e6, atol=0.06)
