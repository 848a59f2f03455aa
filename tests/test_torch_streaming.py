"""The capture stream of tpu_inspect_torch vs the JAX package, on the CPU.

``stream_inspect`` and ``stream_inspect_paths`` (device="cpu": the plain
versions of the kernels) against :mod:`tpu_inspect.streaming` on three
small frames, frame by frame: verdicts, areas, found flags and masks,
exactly (dtypes included).

The copy of a capture into its pinned upload slot (``streaming._copy_rows``,
on the native pool of ``native.copy_bands``) on the CPU: byte for byte, its
row bands covering each row once, the counts of ``streaming.UPLOADS``, no
span opened off the calling thread, copies from several threads at once,
and the copy on the calling thread where the pool does not apply.

On the card (``cuda`` marker; skips without a GPU): the stream over three
4096x3000 captures of the 48-unit sample grid, every copy banded, against
``engine._inspect_image_device`` on the same captures already on the card.
Only the CPU tests that compare with the JAX package import it:

    python -m pytest tests/test_torch_streaming.py -q -m cuda --noconftest
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tpu_inspect_torch import engine as teng
from tpu_inspect_torch import graphs, native, streaming
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.kernels import build, error_flag
from tpu_inspect_torch.png import encode_png
from tpu_inspect_torch.streaming import stream_inspect, stream_inspect_paths
from tpu_inspect_torch.synthetic import crop_units, make_mold_image
from tpu_inspect_torch.utils import trace

GRID = GridParams(
    base_unit=(20, 24, 64, 60), units_x=3, units_y=2, unit_space_x=10, unit_space_y=12
)
HW = (220, 280)
EXCL = [{"shape": "rect", "x": 2, "y": 2, "w": 8, "h": 8}]
FIELDS = ("index", "verdicts", "areas", "valid", "ng_count", "seg_masks", "defect_masks")


def _jax():
    """The JAX package's stream, its parameter classes and GRID as its
    GridParams."""
    from tpu_inspect import config, streaming as jstreaming

    return (jstreaming, config.GridParams(**GRID.__dict__), config.SegmentationParams,
            config.DefectParams)


def _frames():
    return [
        make_mold_image(GRID, HW, seed=s, defect_rate=0.7, shift=(s % 3, -(s % 2)))
        for s in range(3)
    ]


def _assert_same(ours, theirs):
    assert [r.index for r in ours] == [r.index for r in theirs]
    for a, b in zip(ours, theirs):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f"frame {a.index} {f}")


@pytest.mark.parametrize("anchored", [True, False])
def test_stream_matches_jax(anchored, monkeypatch):
    """With anchors from frame 0 (every frame aligned to them), and without
    anchors (every frame a reference capture; the port's chained kernel K
    on, held against the JAX package's split path, which its own tests hold
    equal to its chained one)."""
    j_stream, jgrid, j_seg, j_defect = _jax()
    frames = _frames()
    anchors = None
    if anchored:
        anchors = teng.segment_units(
            crop_units(frames[0], GRID), SegmentationParams(), device="cpu"
        ).centroid_dict()
    else:
        monkeypatch.setattr(teng, "_ENABLE_CHAIN", True)
    kw = dict(exclusions=EXCL, ref_centroids=anchors, fetch_masks=True, prefetch=2)
    ours = list(stream_inspect(frames, GRID, SegmentationParams(), DefectParams(min_area=5),
                               device="cpu", **kw))
    theirs = list(j_stream.stream_inspect(frames, jgrid, j_seg(), j_defect(min_area=5), **kw))
    _assert_same(ours, theirs)
    assert sum(r.ng_count for r in ours) > 0


def test_stream_paths_matches_jax(tmp_path):
    """PNG frames from the port's encoder, decoded by each package's native
    loader, frame by frame equal to the in-memory stream and to the JAX
    package's file stream; masks stay on the device unless asked for."""
    j_stream, jgrid, j_seg, j_defect = _jax()
    frames = _frames()
    paths = []
    for i, f in enumerate(frames):
        p = tmp_path / f"frame_{i}.png"
        p.write_bytes(encode_png(f))
        paths.append(str(p))
    kw = dict(exclusions=[{"shape": "circle", "cx": 30, "cy": 30, "r": 9}])
    ours = list(stream_inspect_paths(paths, GRID, SegmentationParams(),
                                     DefectParams(min_area=5), decode_threads=2,
                                     prefetch=1, device="cpu", **kw))
    mem = list(stream_inspect(frames, GRID, SegmentationParams(), DefectParams(min_area=5),
                              prefetch=1, device="cpu", **kw))
    theirs = list(j_stream.stream_inspect_paths(paths, jgrid, j_seg(), j_defect(min_area=5),
                                                decode_threads=2, prefetch=1, **kw))
    _assert_same(ours, mem)
    _assert_same(ours, theirs)
    assert ours[0].seg_masks is None and ours[0].defect_masks is None


def test_stream_rejects_size_mismatch():
    """A capture of another size raises the JAX package's ValueError (the
    reference blocks it, indexing_ui.py:1212-1222) instead of inspecting
    clamped crops."""
    j_stream, jgrid, j_seg, j_defect = _jax()
    frames = [make_mold_image(GRID, HW, seed=0), make_mold_image(GRID, (HW[0] + 8, HW[1]), seed=1)]
    with pytest.raises(ValueError, match="does not match") as ours:
        list(stream_inspect(frames, GRID, device="cpu"))
    with pytest.raises(ValueError, match="does not match") as theirs:
        list(j_stream.stream_inspect(frames, jgrid, j_seg(), j_defect()))
    assert str(ours.value) == str(theirs.value)


# ---- the copy into the pinned upload slot ------------------------------------

_MIB = 1 << 20


@pytest.fixture()
def band_lib():
    if not native.copy_bands(np.zeros(2, np.uint8), np.ones(2, np.uint8), [0, 1, 2]):
        pytest.skip("native build unavailable (no g++)")


@pytest.mark.parametrize("shape, cores, bands", [
    ((1, 4096), 8, 1),  # 4 KiB: one band on the calling thread
    (HW, 8, 1),  # the stream tests' frames
    ((1024, 1024), 8, 1),  # exactly 1 MiB
    ((1025, 1024), 8, 2),  # a row past 1 MiB
    ((3, 4 * _MIB), 8, 3),  # 12 MiB in fewer rows than bands: a band a row
    ((5 * _MIB // 31 + 7, 31), 8, 6),  # widths around a 16-byte store
    ((5 * _MIB // 32 + 7, 32), 8, 6),
    ((5 * _MIB // 33 + 7, 33), 8, 6),
    ((3000, 4096), 8, 8),  # the capture: 11.7 MiB, held to the ceiling
    ((3000, 4096), 2, 2),  # a process given two cores
    ((3000, 4096), 1, 1),  # and one
])
def test_copy_rows_bands(shape, cores, bands, band_lib, monkeypatch):
    """Byte for byte, in bands whose edges cover each row once; ``single``
    counts a copy of 1 MiB or less (or on one core), ``banded`` one above;
    with spans on, only the caller's span is recorded: no worker opens
    one."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
    rng = np.random.default_rng(sum(shape) + cores)
    src = rng.integers(0, 256, size=shape, dtype=np.uint8)
    dst = np.zeros_like(src)
    edges = streaming._band_edges(shape[0], src.nbytes)
    assert len(edges) == bands + 1 and edges[0] == 0 and edges[-1] == shape[0]
    assert all(a < b for a, b in zip(edges, edges[1:]))
    streaming.reset_uploads()
    trace.reset()
    trace.enable(True)
    try:
        with trace.span("stream.copy"):
            assert streaming._copy_rows(dst, src) == bands
    finally:
        trace.enable(False)
    assert [r[1:3] for r in trace.records()] == [("", "stream.copy")]
    trace.reset()
    assert np.array_equal(dst, src)
    assert streaming.UPLOADS == {"banded": int(bands > 1), "single": int(bands == 1),
                                 "bands": bands}
    streaming.reset_uploads()
    assert streaming.UPLOADS == {"banded": 0, "single": 0, "bands": 0}


def test_copy_rows_from_many_threads(band_lib):
    """More threads than cores copying at once, many times over, with a
    short switch interval: the pool takes the copies in turn, every
    destination equals its source and ``UPLOADS`` loses no count."""
    workers, reps = len(os.sched_getaffinity(0)) + 2, 12
    rng = np.random.default_rng(3)
    srcs = [rng.integers(0, 256, size=(700 + 13 * i, 3001), dtype=np.uint8)
            for i in range(workers)]
    dsts = [np.zeros_like(x) for x in srcs]

    def copy(i):
        for k in range(reps):
            src = srcs[i] if k % 2 else srcs[i][::-1].copy()
            if streaming._copy_rows(dsts[i], src) != 3 or not np.array_equal(dsts[i], src):
                return False
        return True

    streaming.reset_uploads()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(workers) as ex:
            done = [ex.submit(copy, i) for i in range(workers)]
            assert all(f.result(timeout=120) for f in done)
    finally:
        sys.setswitchinterval(interval)
    assert streaming.UPLOADS == {"banded": workers * reps, "single": 0,
                                 "bands": 3 * workers * reps}
    streaming.reset_uploads()


def test_copy_rows_on_the_calling_thread(monkeypatch):
    """A destination whose rows lie apart in memory (a slice of a wider
    plane), or a host without the native library: one copy on the calling
    thread, nothing outside the destination written; arrays of another
    shape raise."""
    src = np.arange(3000 * 700, dtype=np.int64).reshape(3000, 700).astype(np.uint8)
    plane = np.full((3000, 900), 7, dtype=np.uint8)
    streaming.reset_uploads()
    assert streaming._copy_rows(plane[:, 100:800], src) == 1
    assert np.array_equal(plane[:, 100:800], src)
    assert (plane[:, :100] == 7).all() and (plane[:, 800:] == 7).all()
    monkeypatch.setattr(native, "copy_bands", lambda dst, src, offsets: False)
    dst = np.zeros_like(src)
    assert streaming._copy_rows(dst, src) == 1
    assert np.array_equal(dst, src)
    assert streaming.UPLOADS == {"banded": 0, "single": 2, "bands": 2}
    with pytest.raises(ValueError, match="copy of"):
        streaming._copy_rows(dst[1:], src)
    streaming.reset_uploads()


@pytest.mark.parametrize("case", ["strided", "read-only", "offsets past the end",
                                  "offsets not rising", "overlap"])
def test_copy_bands_rejects_bad_buffers(case):
    """``native.copy_bands`` checks its buffers and offsets before it hands a
    pointer to the library."""
    src = np.arange(4096, dtype=np.uint8)
    dst, offsets = np.zeros(4096, np.uint8), [0, 2048, 4096]
    if case == "strided":
        dst = np.zeros(8192, np.uint8)[::2]
    elif case == "read-only":
        dst.flags.writeable = False
    elif case == "offsets past the end":
        offsets = [0, 2048, 4097]
    elif case == "offsets not rising":
        offsets = [0, 2048, 2048, 4096]
    else:
        dst = src
    with pytest.raises(ValueError):
        native.copy_bands(dst, src, offsets)
    assert case == "overlap" or not dst.any()


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_stream_on_card_matches_resident_program(monkeypatch):
    """Three 4096x3000 captures of the 48-unit sample grid fed from host
    memory (the hostfeed cell's size and route, kernel K): every frame's
    copy banded, and the stream's verdicts, areas, found flags and masks
    equal to ``_inspect_image_device`` on the same captures uploaded
    first, each an eager frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the pinned upload slots exist only there")
    from tpu_inspect_torch.synthetic import sample_grid_params

    dev = torch.device("cuda")
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", True)
    grid = sample_grid_params()
    seg, dp = SegmentationParams().validated(), DefectParams().validated()
    excl = [{"shape": "circle", "cx": 160, "cy": 160, "r": 30}]
    frames = [make_mold_image(grid, (3000, 4096), seed=20 + i, defect_rate=0.3)
              for i in range(3)]
    cores = len(os.sched_getaffinity(0))
    graphs.FRAMES.clear()
    streaming.reset_uploads()
    ours = list(stream_inspect(frames, grid, seg, dp, excl, fetch_masks=True, device=dev))
    if cores > 1:
        assert streaming.UPLOADS == {"banded": 3, "single": 0, "bands": 3 * min(8, cores)}
    else:
        assert streaming.UPLOADS == {"banded": 0, "single": 3, "bands": 3}

    origins = teng.origins_on(grid, str(dev))
    _, _, w, h = grid.base_unit
    for f, res in zip(frames, ours):
        graphs.FRAMES.clear()
        err = error_flag(dev)
        masks, _, _, _, (dmasks, found, area, verdict) = teng._inspect_image_device(
            torch.from_numpy(f).to(dev), origins, (h, w), seg, dp, excl, None, True, True, err)
        build.check_bounded(f"frame {res.index}", err)
        want = {"verdicts": verdict, "areas": area.to(torch.int64), "valid": found,
                "seg_masks": masks, "defect_masks": dmasks}
        for name, t in want.items():
            got = getattr(res, name)
            assert got.dtype == t.cpu().numpy().dtype, name
            np.testing.assert_array_equal(got, t.cpu().numpy(), err_msg=f"frame {res.index} {name}")
    assert sum(r.ng_count for r in ours) > 0
