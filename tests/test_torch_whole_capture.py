"""The whole capture as one unit, on the CPU: the benchmark's configuration
``whole4096-otsu-threshold`` cut to one 150x170 unit, with the whole-image
gate (``engine.WHOLE_MIN_PX``) lowered so that the unit takes the
whole-image route, as a 4096x3000 capture does on the card.

- Frames through the one-capture program with a bound flag, and through
  the capture stream with 3 frames in flight, equal the benchmark's plain
  reference (``benchmark.reference.chain.inspect``): seg masks, defect
  masks, areas, found flags and verdicts, over several seeds.
- The route's ``whole.*`` spans open inside their stage spans, each around
  the kernels it names, and nothing is recorded with tracing off.
- The two readers of the route's device trace, ``whole_kernels_roofline``
  and ``glue_device_ms_per_frame``, on synthetic device slices.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import frames
from benchmark.reference import chain
from benchmark.roofline import HBM_BYTES_PER_S, blob_filter_bytes, seg_tail_bytes
from benchmark.run import Run, reader
from benchmark.trace import Slice
from tpu_inspect_torch import engine as teng
from tpu_inspect_torch import streaming
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.kernels import error_flag
from tpu_inspect_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [1, 2, 3, 4, 5, 2**31 + 5]


def _config() -> dict:
    """The whole-capture configuration with its capture cut to 150x170."""
    with open(ROOT / "benchmark" / "configs" / "whole4096-otsu-threshold.json") as fh:
        cfg = json.load(fh)
    cfg["image_hw"] = [150, 170]
    cfg["grid"]["base_unit"] = [0, 0, 170, 150]
    cfg["exclusions"] = [{"shape": "circle", "cx": 32, "cy": 30, "r": 6}]
    cfg["capture"]["speck_radius"] = [2, 4]
    return cfg


CFG = _config()


@pytest.fixture
def whole(monkeypatch):
    """The gate lowered so the one 150x170 unit takes the whole-image route."""
    monkeypatch.setattr(teng, "WHOLE_MIN_PX", 1000)
    assert teng._whole_route(150, 170)


def _params():
    g = CFG["grid"]
    grid = GridParams(base_unit=tuple(g["base_unit"]),
                      **{k: v for k, v in g.items() if k != "base_unit"})
    return (grid, SegmentationParams(**CFG["segmentation"]).validated(),
            DefectParams(**CFG["defect"]).validated())


def _origins(grid):
    return teng.origins_on(grid, "cpu")


def _assert_matches(ref, seg_mask, defect_mask, area, found, verdict, label):
    np.testing.assert_array_equal(np.asarray(seg_mask) > 0, ref["seg_mask"], err_msg=label)
    np.testing.assert_array_equal(np.asarray(defect_mask) > 0, ref["defect_mask"], err_msg=label)
    np.testing.assert_array_equal(np.asarray(area).astype(np.int64), ref["area"], err_msg=label)
    np.testing.assert_array_equal(np.asarray(found), ref["found"], err_msg=label)
    np.testing.assert_array_equal(np.asarray(verdict), ref["verdict"], err_msg=label)


@pytest.mark.parametrize("seed", SEEDS)
def test_program_matches_reference(whole, seed):
    grid, seg, defect = _params()
    pool, _ = frames.make_pool(CFG, 4, seed, "cpu")
    for k, image in enumerate(pool):
        err = error_flag(torch.device("cpu"))
        masks, _, _, shifts, (dm, found, area, verdict) = teng._inspect_image_device(
            image, _origins(grid), (150, 170), seg, defect, CFG["exclusions"], None, True, True,
            err)
        assert int(err.item()) == 0 and not shifts.any()
        _assert_matches(chain.inspect(image, CFG), masks, dm, area, found, verdict,
                        f"seed {seed} capture {k}")


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_anchored_program_matches_reference(whole, seed):
    """Captures shifted up to 8 px against the first's anchors: the
    exclusion moves with each capture's shift, as the reference's."""
    grid, seg, defect = _params()
    pool, _ = frames.make_pool(CFG, 4, seed, "cpu", shift_px=8)
    first, _ = teng.inspect_image(pool[0], grid, seg, None, CFG["exclusions"], is_reference=True,
                                  device="cpu")
    anchors = first.centroid_dict()
    ref0 = chain.inspect(pool[0], CFG)
    moved = 0
    for k, image in enumerate(pool):
        err = error_flag(torch.device("cpu"))
        masks, _, _, shifts, (dm, found, area, verdict) = teng._inspect_image_device(
            image, _origins(grid), (150, 170), seg, defect, CFG["exclusions"], anchors, False,
            True, err)
        ref = chain.inspect(image, CFG, (ref0["centroid"], ref0["has_fg"]))
        assert int(err.item()) == 0
        np.testing.assert_array_equal(shifts.numpy(), ref["shift"])
        moved += int(ref["shift"].any())
        _assert_matches(ref, masks, dm, area, found, verdict, f"seed {seed} capture {k}")
    assert moved  # the pool's shifts move the exclusion


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_stream_three_in_flight_matches_reference(whole, seed):
    grid, seg, defect = _params()
    pool, _ = frames.make_pool(CFG, 5, seed, "cpu")
    host = [t.numpy() for t in pool]
    out = list(streaming.stream_inspect(iter(host), grid, seg, defect, CFG["exclusions"], None,
                                        prefetch=2, fetch_masks=True, device="cpu"))
    assert [r.index for r in out] == list(range(len(host)))
    for r, image in zip(out, pool):
        _assert_matches(chain.inspect(image, CFG), r.seg_masks, r.defect_masks, r.areas, r.valid,
                        r.verdicts, f"seed {seed} frame {r.index}")


# the stage each whole.* span opens in, and the kernel spans directly inside it
WHOLE_SPANS = {
    ("seg.tail", "whole.mask"): ["kernel.morph"],
    ("seg.tail", "whole.fill"): ["kernel.propagate"],
    ("seg.tail", "whole.label"): ["kernel.label"],
    ("seg.tail", "whole.stats"): ["kernel.cc_stats"],
    ("defect.roi", "whole.mask"): ["kernel.morph"],
    ("defect.roi", "whole.label"): ["kernel.label"],
    ("defect.roi", "whole.stats"): ["kernel.cc_stats"],
    ("defect.filter", "whole.mask"): ["kernel.morph"],
    ("defect.filter", "whole.regions"): ["kernel.propagate", "kernel.label", "kernel.propagate"],
    ("defect.filter", "whole.select"): ["kernel.blob_select"],
}


def _frame(seed=7):
    grid, seg, defect = _params()
    image = frames.make_pool(CFG, 1, seed, "cpu")[0][0]
    return teng._inspect_image_device(image, _origins(grid), (150, 170), seg, defect,
                                      CFG["exclusions"], None, True, True,
                                      error_flag(torch.device("cpu")))


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.reset()


def test_whole_spans_open_inside_their_stages(whole, tracing):
    _frame()
    recs = trace.records()
    by_path = {(r[1] + "/" if r[1] else "") + r[2]: r for r in recs}
    got = {}
    for fid, parent, name, t0, t1 in sorted(recs, key=lambda r: r[3]):
        if name.startswith("whole."):
            root, stage = parent.split("/")
            assert root == "frame.whole"
            outer = by_path[parent]
            assert outer[3] <= t0 <= t1 <= outer[4]
            got[(stage, name)] = [r[2] for r in sorted(recs, key=lambda r: r[3])
                                  if r[1] == f"{parent}/{name}"]
    assert got == WHOLE_SPANS
    # every kernel span of the route's tails and filter lies in a whole.* span
    for r in recs:
        if r[2].startswith("kernel.") and r[1].split("/")[1] in ("seg.tail", "defect.roi",
                                                                  "defect.filter"):
            assert r[1].split("/")[-1].startswith("whole."), r


def test_whole_spans_off_record_nothing(whole):
    trace.enable(False)
    trace.reset()
    _frame()
    assert trace.records() == [] and trace.dropped == 0


# --- the readers of the whole cell's device trace ---


def _run(device, frames_in_slice=2, cfg=None):
    run = Run(cfg or CFG, {})
    if device is not None:
        run.slices["device"] = Slice(frames=frames_in_slice, wall_s=1.0, device=device)
    return run


HAND = [("void (anonymous namespace)::tile_kernel<true>(unsigned char const*, int*)", 0.0, 40.0),
        ("void (anonymous namespace)::compress_kernel(unsigned int const*, int*)", 50.0, 10.0),
        ("void morph_chain_kernel<3>(unsigned char const*, int const*)", 70.0, 20.0),
        ("void area_kernel(int const*, unsigned char const*)", 95.0, 5.0),
        ("void paint_kernel(int const*, unsigned char const*)", 101.0, 5.0)]
OTHER = [("void median_residual_kernel<21>(unsigned char const*)", 110.0, 30.0),
         ("void seg_tail_kernel(unsigned char const*)", 150.0, 7.0)]
GLUE = [("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<int>, "
         "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<int>, "
         "std::array<char*, 3ul>)", 160.0, 3.0),
        ("void at::native::(anonymous namespace)::scan_kernel<long>(long*)", 170.0, 2.0),
        ("Memcpy DtoH (Device -> Pinned)", 180.0, 1.5),
        ("Memset (Device)", 185.0, 0.5)]


def test_whole_kernels_roofline_reads_the_route_kernels():
    read = reader("whole_kernels_roofline")
    run = _run(HAND + OTHER + GLUE, frames_in_slice=2)
    kernel_s = (40.0 + 10.0 + 20.0 + 5.0 + 5.0) * 1e-6  # I, D/E, F, G only
    nbytes = seg_tail_bytes(CFG) + blob_filter_bytes(CFG)
    assert read(run) == pytest.approx(100.0 * nbytes * 2 / HBM_BYTES_PER_S / kernel_s)
    assert read(_run(None)) is None
    assert read(_run(OTHER + GLUE)) is None  # none of the route's kernels ran


def test_whole_kernels_roofline_names_kernels_of_the_sources():
    from benchmark.metrics import glue_device_ms_per_frame, whole_kernels_roofline

    names = glue_device_ms_per_frame.hand_kernels()
    assert whole_kernels_roofline.KERNELS <= names
    assert {"seg_tail_kernel", "blob_filter_kernel", "median_residual_kernel", "hist_kernel",
            "scan_kernel", "gauss_blur_kernel"} <= names


def test_glue_device_ms_per_frame_counts_what_no_hand_kernel_does():
    read = reader("glue_device_ms_per_frame")
    run = _run(HAND + OTHER + GLUE, frames_in_slice=2)
    # PyTorch's kernels (its scan_kernel too, though the Otsu scan shares
    # the name), the copy and the set: 7 us over 2 frames
    assert read(run) == pytest.approx(1e-3 * 7.0 / 2)
    assert read(_run(HAND + OTHER)) == 0.0
    assert read(_run(None)) is None
    assert read(_run(HAND + GLUE, frames_in_slice=0)) is None
