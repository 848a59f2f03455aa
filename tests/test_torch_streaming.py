"""The capture stream of tpu_inspect_torch vs the JAX package, on the CPU.

``stream_inspect`` and ``stream_inspect_paths`` (device="cpu": the plain
versions of the kernels) against :mod:`tpu_inspect.streaming` on three
small frames, frame by frame: verdicts, areas, found flags and masks,
exactly (dtypes included).
"""

import numpy as np
import pytest

from tpu_inspect.config import DefectParams as JDefect
from tpu_inspect.config import GridParams as JGrid
from tpu_inspect.config import SegmentationParams as JSeg
from tpu_inspect.streaming import stream_inspect as j_stream
from tpu_inspect.streaming import stream_inspect_paths as j_stream_paths

from tpu_inspect_torch import engine as teng
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.png import encode_png
from tpu_inspect_torch.streaming import stream_inspect, stream_inspect_paths
from tpu_inspect_torch.synthetic import crop_units, make_mold_image

GRID = GridParams(
    base_unit=(20, 24, 64, 60), units_x=3, units_y=2, unit_space_x=10, unit_space_y=12
)
JGRID = JGrid(**GRID.__dict__)
HW = (220, 280)
EXCL = [{"shape": "rect", "x": 2, "y": 2, "w": 8, "h": 8}]
FIELDS = ("index", "verdicts", "areas", "valid", "ng_count", "seg_masks", "defect_masks")


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
    theirs = list(j_stream(frames, JGRID, JSeg(), JDefect(min_area=5), **kw))
    _assert_same(ours, theirs)
    assert sum(r.ng_count for r in ours) > 0


def test_stream_paths_matches_jax(tmp_path):
    """PNG frames from the port's encoder, decoded by each package's native
    loader, frame by frame equal to the in-memory stream and to the JAX
    package's file stream; masks stay on the device unless asked for."""
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
    theirs = list(j_stream_paths(paths, JGRID, JSeg(), JDefect(min_area=5),
                                 decode_threads=2, prefetch=1, **kw))
    _assert_same(ours, mem)
    _assert_same(ours, theirs)
    assert ours[0].seg_masks is None and ours[0].defect_masks is None


def test_stream_rejects_size_mismatch():
    """A capture of another size raises the JAX package's ValueError (the
    reference blocks it, indexing_ui.py:1212-1222) instead of inspecting
    clamped crops."""
    frames = [make_mold_image(GRID, HW, seed=0), make_mold_image(GRID, (HW[0] + 8, HW[1]), seed=1)]
    with pytest.raises(ValueError, match="does not match") as ours:
        list(stream_inspect(frames, GRID, device="cpu"))
    with pytest.raises(ValueError, match="does not match") as theirs:
        list(j_stream(frames, JGRID, JSeg(), JDefect()))
    assert str(ours.value) == str(theirs.value)
