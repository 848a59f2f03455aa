"""The captured replay of the one-capture program
(``tpu_inspect_torch.graphs``).

On the CPU: the frame key (each part the program bakes in changes it, equal
inputs give equal keys), the policy (the third sighting of a key captures,
a refused key stays eager, the oldest key is dropped past the bound), the
bound flag's merge, the anchors uploaded once per anchor set, and that CPU
calls never reach the graphs.

On the card (``cuda`` marker; they skip without a GPU): a replay equals the
eager program bit for bit on the chained route, on the split route with
anchors and shifted captures, on the adaptive/Canny split route and on the
whole-image route (the capture as one unit);
outputs of successive replays are never aliased; a replayed frame counts
the launches of an eager one and opens only its root and ``graph.replay``
spans; a replay waits for the card nowhere; the graph holds the device
constants it reads after their caches are cleared; a bound flag raised
inside a replay reaches the caller's flag. The file imports neither jax
nor tpu_inspect:

    python -m pytest tests/test_torch_graph.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from tpu_inspect_torch import engine as teng
from tpu_inspect_torch import graphs
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.geometry import grid_origins
from tpu_inspect_torch.kernels import (
    GRAPHS,
    LAUNCHES,
    Kernel,
    device_constant,
    error_flag,
    recording,
    reset_graphs,
    reset_launches,
)
from tpu_inspect_torch.synthetic import make_mold_image
from tpu_inspect_torch.utils import trace

GRID = GridParams(base_unit=(6, 8, 64, 60), units_x=2, units_y=2, unit_space_x=10,
                  unit_space_y=12)
EXCL = [{"shape": "circle", "cx": 30, "cy": 30, "r": 6}]
SEG, DEF = SegmentationParams().validated(), DefectParams().validated()
ANCHORS = {0: (31.5, 29.25), 1: (30.0, 30.5), 3: (29.75, 31.0)}


def _key_args(**over):
    """The arguments of ``engine._frame_key`` on a small CPU frame, with
    ``over`` replacing some."""
    args = dict(image=torch.zeros((150, 160), dtype=torch.uint8), origins=_ORIGINS,
                unit_hw=(60, 64), seg=SEG, defect=DEF, exclusions=EXCL,
                ref_centroids=dict(ANCHORS), is_reference=False, with_defects=True,
                route="frame.split")
    args.update(over)
    return args


_ORIGINS = torch.from_numpy(grid_origins(GRID))


def _key(**over):
    return teng._frame_key(**_key_args(**over))


# ---- the frame key (CPU) --------------------------------------------------

_CHANGES = {
    "image shape": dict(image=torch.zeros((150, 161), dtype=torch.uint8)),
    "origins, another tensor of equal values": dict(origins=_ORIGINS.clone()),
    "unit_hw": dict(unit_hw=(60, 63)),
    "seg method": dict(seg=SegmentationParams(method="adaptive").validated()),
    "seg blur": dict(seg=SegmentationParams(gaussian_blur=5).validated()),
    "defect threshold": dict(defect=DefectParams(threshold=30).validated()),
    "defect method": dict(defect=DefectParams(method="canny").validated()),
    "exclusions moved": dict(exclusions=[{"shape": "circle", "cx": 31, "cy": 30, "r": 6}]),
    "exclusions none": dict(exclusions=()),
    "exclusion rect": dict(exclusions=EXCL + [{"shape": "rect", "x": 1, "y": 2, "w": 3, "h": 4}]),
    "anchor value": dict(ref_centroids={**ANCHORS, 1: (30.0, 30.25)}),
    "anchor dropped": dict(ref_centroids={k: v for k, v in ANCHORS.items() if k != 3}),
    "anchors none": dict(ref_centroids=None),
    "is_reference": dict(is_reference=True),
    "with_defects": dict(with_defects=False),
    "route": dict(route="frame.chained"),
}


@pytest.mark.parametrize("part", list(_CHANGES))
def test_each_part_changes_the_key(part):
    assert _key() is not None
    assert _key(**_CHANGES[part]) != _key()


def test_in_place_write_to_origins_changes_the_key():
    origins = _ORIGINS.clone()
    before = _key(origins=origins)
    origins[0, 0] = origins[0, 0]  # same values, one write
    assert _key(origins=origins) != before
    assert _key(origins=origins) == _key(origins=origins)


def test_chain_flag_changes_the_key(monkeypatch):
    before = _key()
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", not teng._ENABLE_CHAIN)
    assert _key() != before


_EQUAL = {
    "fresh equal objects": dict(
        seg=SegmentationParams().validated(), defect=DefectParams().validated(),
        exclusions=[dict(e) for e in EXCL], ref_centroids=dict(ANCHORS),
        image=torch.ones((150, 160), dtype=torch.uint8)),
    "anchors in another order": dict(ref_centroids=dict(reversed(list(ANCHORS.items())))),
    "anchors as lists": dict(ref_centroids={k: list(v) for k, v in ANCHORS.items()}),
    "anchors unused on the reference": dict(is_reference=True, ref_centroids=None),
}


@pytest.mark.parametrize("case", list(_EQUAL))
def test_equal_inputs_give_equal_keys(case):
    base = {"anchors unused on the reference": dict(is_reference=True)}.get(case, {})
    assert _key(**_EQUAL[case]) == _key(**base)
    assert hash(_key(**_EQUAL[case])) == hash(_key(**base))


def test_unkeyable_origins_give_no_key():
    with torch.inference_mode():
        frozen = torch.from_numpy(grid_origins(GRID)).clone()
    assert _key(origins=frozen) is None
    assert _key(origins=_ORIGINS.to("meta")) is None


@pytest.mark.parametrize("anchors", [
    dict(ANCHORS), {k: np.array(v) for k, v in ANCHORS.items()},
    np.array([(31.5, 29.25), (30.0, 30.5), (1.0, 2.0), (29.75, 31.0)]), None])
def test_anchor_tensors_are_the_anchor_arrays(anchors):
    ref, ok = teng._anchor_tensors(teng.anchor_key(anchors), 4, "cpu")
    want_ref, want_ok = teng.ref_centroid_arrays(anchors, 4)
    assert ref.dtype == torch.float64 and ok.dtype == torch.bool
    assert np.array_equal(ref.numpy(), want_ref) and np.array_equal(ok.numpy(), want_ok)
    again = teng._anchor_tensors(teng.anchor_key(anchors), 4, "cpu")
    assert again[0] is ref and again[1] is ok  # uploaded once per anchor set


# ---- the policy (CPU) -----------------------------------------------------


def test_third_sighting_captures():
    fg = graphs.FrameGraphs()
    assert [fg.sight("k")[1] for _ in range(3)] == ["eager", "eager", "capture"]
    assert graphs.CAPTURE_AT == 3


def test_refused_key_stays_eager():
    fg = graphs.FrameGraphs()
    for _ in range(2):
        fg.sight("k")
    entry, action = fg.sight("k")
    assert action == "capture"
    entry.refused = True
    assert [fg.sight("k")[1] for _ in range(3)] == ["eager"] * 3


def test_lru_bound_evicts_the_oldest_key():
    fg = graphs.FrameGraphs()
    for k in "abcd":
        fg.sight(k, keep=(k,))
    fg.sight("a")  # a is now the most recent
    fg.sight("e")
    assert fg.keys() == ["c", "d", "a", "e"]
    assert graphs.MAX_KEYS == 4
    # an evicted key starts its sightings over
    assert [fg.sight("b")[1] for _ in range(3)] == ["eager", "eager", "capture"]


def test_entry_holds_what_its_key_names():
    fg = graphs.FrameGraphs()
    held = torch.zeros(3)
    entry, _ = fg.sight("k", keep=(held,))
    assert entry.keep[0] is held


@pytest.mark.parametrize("err,flag,want", [(0, 0, 0), (0, 2, 2), (1, 0, 1), (3, 1, 3),
                                           (1, 3, 3)])
def test_flag_merge_never_clears_a_set_flag(err, flag, want):
    e = torch.tensor([err], dtype=torch.int32)
    out = graphs.merge_flag(e, torch.tensor([flag], dtype=torch.int32))
    assert out is e and int(e[0]) == want


def test_keyless_frame_runs_eager_and_counts():
    fg = graphs.FrameGraphs()
    reset_graphs()
    x, err = torch.arange(4), torch.zeros(1, dtype=torch.int32)
    assert torch.equal(fg.run(None, x, err, lambda i, e: i * 2), x * 2)
    assert GRAPHS == {"captured": 0, "replayed": 0, "eager": 1, "refused": 0}
    assert fg.keys() == []


def test_failed_capture_refuses_the_key_and_runs_eager():
    """A capture that raises (here: a CPU tensor, which no graph captures)
    is counted, its key runs eagerly from then on, and LAUNCHES counts
    only the eager frames' launches."""
    fg = graphs.FrameGraphs()
    reset_graphs()
    reset_launches()
    x, err = torch.arange(4), torch.zeros(1, dtype=torch.int32)

    def program(i, e):
        LAUNCHES["otsu"] += 1
        return i + 1

    with pytest.warns(RuntimeWarning, match="capture refused"):
        outs = [fg.run("k", x, err, program) for _ in range(5)]
    assert all(torch.equal(o, x + 1) for o in outs)
    assert GRAPHS == {"captured": 0, "replayed": 0, "eager": 5, "refused": 1}
    assert LAUNCHES["otsu"] == 5
    assert fg.last_refusal


def test_threads_lose_no_count_and_keep_the_bound():
    """16 threads, 6 keys over a bound of 4 (so keys are dropped and seen
    anew while others try to capture), the interpreter switching
    threads as often as it can: every frame runs and is counted once, and
    no more than 4 keys are kept."""
    import sys
    import threading
    import warnings

    fg = graphs.FrameGraphs()
    reset_graphs()
    x, err = torch.arange(4), torch.zeros(1, dtype=torch.int32)
    ran = []

    def worker(t):
        for i in range(100):
            ran.append(fg.run(f"k{(t + i // 3) % 6}", x, err, lambda im, e: im))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(ran) == 1600 and GRAPHS["eager"] == 1600 and GRAPHS["replayed"] == 0
    assert len(fg.keys()) <= 4


def test_device_constant_hands_values_to_a_capture():
    calls = []

    @device_constant(maxsize=2)
    def table(n):
        calls.append(n)
        return torch.arange(n)

    outside = table(3)
    keep = []
    with recording(keep, {}):
        a, b = table(3), table(4)
    assert a is outside and keep[0] is a and keep[1] is b and len(keep) == 2
    assert table(4) is b and len(keep) == 2  # nothing held outside the block
    assert calls == [3, 4] and table.cache_info().currsize == 2
    table.cache_clear()
    assert table.cache_info().currsize == 0


def test_recording_counts_only_its_own_thread():
    """Launches inside ``recording`` go to its record, on that thread
    alone: four threads launching at the same time keep their counts in
    LAUNCHES, none lost and none taken into the record; a nested record
    gives the outer one back."""
    import threading

    otsu, blob = Kernel("otsu"), Kernel("blob_filter")
    reset_launches()
    inside, start = threading.Event(), threading.Barrier(5)
    outer, inner = {}, {}

    def capturing():
        with recording([], outer):
            start.wait(timeout=30)
            for _ in range(300):
                otsu.launched()
            with recording([], inner):
                blob.launched()
            otsu.launched()
            inside.set()

    def eager():
        start.wait(timeout=30)
        for _ in range(500):
            otsu.launched()
            blob.launched()

    threads = [threading.Thread(target=capturing)] + [
        threading.Thread(target=eager) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert inside.is_set() and not any(th.is_alive() for th in threads)
    assert outer == {"otsu": 301} and inner == {"blob_filter": 1}
    assert LAUNCHES["otsu"] == 2000 and LAUNCHES["blob_filter"] == 2000
    otsu.launched()
    assert LAUNCHES["otsu"] == 2001 and outer == {"otsu": 301}


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_capture_counts_launches_apart_from_other_threads(monkeypatch):
    """The capture's bookkeeping on the CPU, the CUDA calls made stand-ins
    (a graph whose replay does nothing): four threads are inside eager
    frames, launching, while another warms up and captures a key.
    LAUNCHES then holds every eager frame's launches and each of the
    capturing key's frames once (two eager, the capturing frame and two
    replays), and the key's record holds one frame's launches alone."""
    import contextlib
    import threading

    stream = _FakeStream()
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: type("Graph", (), {"replay": lambda self: None})())
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext())
    fg = graphs.FrameGraphs()
    reset_graphs()
    reset_launches()
    otsu, tail, blob = Kernel("otsu"), Kernel("seg_tail"), Kernel("blob_filter")
    entered = [threading.Event(), threading.Event()]  # the warm-up, the capture
    go_on = [threading.Event(), threading.Event()]
    ready, done = threading.Barrier(5), [threading.Barrier(5), threading.Barrier(5)]
    calls = []

    def keyed(img, flag):
        calls.append(len(calls))
        otsu.launched()
        tail.launched()
        if len(calls) in (3, 4):  # inside the warm-up, then the capture
            entered[len(calls) - 3].set()
            assert go_on[len(calls) - 3].wait(timeout=30)
        tail.launched()
        return img * 2, (img + 1, None)

    def other(img, flag):
        blob.launched()
        ready.wait(timeout=30)
        for phase in range(2):
            assert entered[phase].wait(timeout=30)
            for _ in range(25):
                otsu.launched()
                blob.launched()
            done[phase].wait(timeout=30)
        return img

    x, err = torch.arange(4), torch.zeros(1, dtype=torch.int32)
    outs, eager_outs = [], []
    workers = [threading.Thread(target=lambda: eager_outs.append(fg.run(None, x, err, other)))
               for _ in range(4)]
    for th in workers:
        th.start()
    ready.wait(timeout=30)  # every worker inside its frame
    line = threading.Thread(target=lambda: outs.extend(fg.run("k", x, err, keyed)
                                                       for _ in range(5)))
    line.start()
    for phase in range(2):
        done[phase].wait(timeout=30)
        go_on[phase].set()
    for th in [line, *workers]:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in [line, *workers])
    assert len(outs) == 5 and len(eager_outs) == 4 and len(calls) == 4
    for got in outs:
        _assert_same(got, (x * 2, (x + 1, None)))
    assert GRAPHS == {"captured": 1, "replayed": 3, "eager": 6, "refused": 0}
    assert LAUNCHES["otsu"] == 5 + 4 * 50 and LAUNCHES["seg_tail"] == 5 * 2
    assert LAUNCHES["blob_filter"] == 4 * 51
    (entry,) = (fg._entries[k] for k in fg.keys())
    assert entry.launches == {"otsu": 1, "seg_tail": 2}


def test_cpu_calls_never_touch_graphs():
    reset_graphs()
    keys = graphs.FRAMES.keys()
    image = make_mold_image(GRID, (150, 160), seed=3, defect_rate=0.6)
    for _ in range(4):
        err = error_flag("cpu")
        teng._inspect_image_device(torch.from_numpy(image), _ORIGINS, (60, 64), SEG, DEF, EXCL,
                                   None, True, True, err)
    teng.inspect_image(image, GRID, SEG, DEF, EXCL, device="cpu")
    assert GRAPHS == {"captured": 0, "replayed": 0, "eager": 0, "refused": 0}
    assert graphs.FRAMES.keys() == keys


def test_inspect_image_shares_one_origins_tensor_a_grid():
    a = teng.origins_on(GRID, "cpu")
    assert teng.origins_on(GRID, "cpu") is a
    assert np.array_equal(a.numpy(), grid_origins(GRID))


# ---- on the card ------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph captures only CUDA work")
    graphs.FRAMES.clear()
    reset_graphs()
    return torch.device("cuda")


def _flat(outs):
    if isinstance(outs, tuple):
        return [t for o in outs for t in _flat(o)]
    return [] if outs is None else [outs]


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


# the sample grid's default recipe and its heaviest one, on 4096x3000
_BIG = None


def _big():
    """The 48-unit sample grid with its exclusion, the reference capture and
    five captures shifted up to 8 px (the anchored cell's traffic)."""
    global _BIG
    if _BIG is None:
        from tpu_inspect_torch.synthetic import sample_grid_params

        grid = sample_grid_params()
        shifts = [(0, 0), (7, -4), (-8, 3), (2, 8), (-5, -6), (4, 1)]
        images = [make_mold_image(grid, (3000, 4096), seed=10 + i, defect_rate=0.3, shift=s)
                  for i, s in enumerate(shifts)]
        _BIG = grid, images
    return _BIG


_ROUTES = {
    "chained otsu": dict(chain=True, seg=SegmentationParams(), anchored=False),
    "split anchored": dict(chain=False, seg=SegmentationParams(), anchored=True),
    "split adaptive canny": dict(chain=False, seg=SegmentationParams(method="adaptive",
                                                                     adapt_block=51, adapt_C=10),
                                 defect=DefectParams(method="canny"), anchored=True),
    "whole otsu": dict(chain=False, seg=SegmentationParams(), anchored=False, whole=True),
}


def _setup(dev, case, monkeypatch):
    """(dispatch(image, err), eager(image, err), device captures) for a
    route of ``_ROUTES``: dispatch is the engine's entry, eager its body
    alone."""
    spec = _ROUTES[case]
    monkeypatch.setattr(teng, "_ENABLE_CHAIN", spec["chain"])
    grid, images = _big()
    if spec.get("whole"):  # each capture as one 4096x3000 unit
        grid = GridParams(base_unit=(0, 0, 4096, 3000))
    seg = spec["seg"].validated()
    dp = spec.get("defect", DefectParams()).validated()
    origins = teng.origins_on(grid, str(dev))
    _, _, w, h = grid.base_unit
    caps = [torch.from_numpy(im).to(dev) for im in images]
    anchors = None
    if spec["anchored"]:
        ref, _ = teng.inspect_image(images[0], grid, seg, None, EXCL, device=dev)
        anchors = ref.centroid_dict()
    is_ref = anchors is None
    chained = is_ref and teng._seg_roi_chain_fits((len(origins), h, w), seg)

    def dispatch(image, err):
        return teng._inspect_image_device(image, origins, (h, w), seg, dp, EXCL, anchors, is_ref,
                                          True, err)

    def eager(image, err):
        return teng._program(image, origins, (h, w), seg, dp, EXCL, anchors, is_ref, True,
                             chained, err)

    reset_graphs()
    return dispatch, eager, caps


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_ROUTES))
def test_replay_matches_eager_and_no_output_is_aliased(cuda, case, monkeypatch):
    """Five successive replays on five different captures, every output
    kept, then each compared with its own eager run; the bound flag stays
    0, one graph captured, no capture refused."""
    dispatch, eager, caps = _setup(cuda, case, monkeypatch)
    for i in range(3):  # eager, eager, capture
        dispatch(caps[i % len(caps)], error_flag(cuda))
    reset_graphs()
    errs = [error_flag(cuda) for _ in range(5)]
    kept = [dispatch(caps[1 + i], errs[i]) for i in range(5)]
    assert GRAPHS["replayed"] == 5 and GRAPHS["eager"] == 0 and GRAPHS["refused"] == 0
    for i, got in enumerate(kept):
        want_err = error_flag(cuda)
        _assert_same(got, eager(caps[1 + i], want_err))
        assert int(errs[i].item()) == 0 and int(want_err.item()) == 0
    # distinct storage for every frame's outputs
    ptrs = [t.data_ptr() for out in kept for t in _flat(out)]
    assert len(set(ptrs)) == len(ptrs)
    assert graphs.FRAMES.last_refusal is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chained otsu", "split anchored"])
def test_replayed_frame_counts_an_eager_frames_launches(cuda, case, monkeypatch):
    """LAUNCHES grows by the same counts for an eager frame, the capturing
    frame and a replayed one; a replay's spans are its root and
    ``graph.replay`` alone."""
    dispatch, eager, caps = _setup(cuda, case, monkeypatch)
    deltas = []
    for i in range(4):  # eager, eager, capture, replay
        reset_launches()
        dispatch(caps[i], error_flag(cuda))
        deltas.append({k: n for k, n in LAUNCHES.items() if n})
    assert deltas[0] and all(d == deltas[0] for d in deltas), deltas
    assert GRAPHS["captured"] == 1 and GRAPHS["replayed"] == 2 and GRAPHS["eager"] == 2
    trace.reset()
    trace.enable(True)
    try:
        dispatch(caps[4], error_flag(cuda))
    finally:
        trace.enable(False)
    recs = trace.records()
    trace.reset()
    root = "frame.chained" if case == "chained otsu" else "frame.split"
    assert sorted((r[1], r[2]) for r in recs) == [("", root), (root, "graph.replay")]


@pytest.mark.cuda
def test_replay_waits_nowhere(cuda, monkeypatch):
    """A replayed frame dispatches under set_sync_debug_mode("error"); its
    flag is read after."""
    from tpu_inspect_torch.kernels import build

    dispatch, eager, caps = _setup(cuda, "split anchored", monkeypatch)
    for i in range(3):
        dispatch(caps[i], error_flag(cuda))
    torch.cuda.synchronize()
    err = error_flag(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dispatch(caps[3], err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    build.check_bounded("replay", err)
    assert GRAPHS["replayed"] == 2
    _assert_same(out, eager(caps[3], error_flag(cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chained otsu", "split adaptive canny"])
def test_replay_holds_its_constants_after_the_caches_clear(cuda, case, monkeypatch):
    """Every device_constant cache cleared and the freed memory written
    over: the graph still reads its own copies, and a replay still equals
    the eager program (which uploads the constants anew)."""
    from tpu_inspect_torch.ops import blob_select, gaussian, morphology

    dispatch, eager, caps = _setup(cuda, case, monkeypatch)
    for i in range(3):
        dispatch(caps[i], error_flag(cuda))
    for fn in (morphology.stage_program_tensor, blob_select.contour_table,
               gaussian._reflect101_index, gaussian._blur_taps, gaussian._mean_taps,
               teng._anchor_tensors, teng.origins_on):
        fn.cache_clear()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 20,), 0x7F7F7F7F, dtype=torch.int32, device=cuda)
            for _ in range(64)]
    err = error_flag(cuda)
    got = dispatch(caps[4], err)
    del junk
    assert GRAPHS["replayed"] == 2
    _assert_same(got, eager(caps[4], error_flag(cuda)))
    assert int(err.item()) == 0


@pytest.mark.cuda
def test_bound_flag_raised_in_a_replay_reaches_the_caller(cuda):
    """A program of hand kernels whose labels leave the plane where the
    image holds a 2 (kernel F sets flag 3, as the bound tests do): on
    replay the caller's flag reads 3, the next frame's flag starts at 0,
    and a caller's flag already set stays set."""
    from tpu_inspect_torch.ops.cc import component_stats, label_components

    fg = graphs.FrameGraphs()

    def program(img, flag):
        mask = img > 0
        labels = label_components(mask, err=flag)
        labels = torch.where(img == 2, img.shape[1] * img.shape[2], labels)
        return component_stats(labels, mask, err=flag)

    good = torch.ones((2, 9, 12), dtype=torch.uint8, device=cuda)
    bad = good.clone()
    bad[1, 4, 5] = 2
    flags = []
    for image in (good, good, good, bad, good, good):  # eager, eager, capture, replays
        err = error_flag(cuda)
        fg.run("bound", image, err, program)
        flags.append(int(err.item()))
    assert flags == [0, 0, 0, 3, 0, 0]
    assert GRAPHS["captured"] == 1 and GRAPHS["replayed"] == 4 and GRAPHS["refused"] == 0
    err = torch.ones((1,), dtype=torch.int32, device=cuda)
    fg.run("bound", good, err, program)
    assert int(err.item()) == 1


def test_outputs_hand_out_fresh_equal_tensors():
    """The static outputs (masks, int64 sums, bool flags, int32 shifts and
    areas, nested, None kept) handed out as clones: every set equals the
    statics in dtype, shape and values, and shares no storage with them or
    with another set."""
    g = torch.Generator().manual_seed(5)
    masks = torch.randint(0, 256, (3, 150, 160), dtype=torch.uint8, generator=g)
    sums = torch.randint(-9, 1 << 40, (3, 3), generator=g)
    flags = torch.rand(3, generator=g) > 0.5
    shifts = torch.randint(-8, 9, (3, 2), dtype=torch.int32, generator=g)
    area = torch.randint(0, 999, (3,), dtype=torch.int32, generator=g)
    outs = (masks, sums, flags, shifts, (masks.clone(), flags.clone(), area, ~flags))
    a, b = graphs._clone(outs), graphs._clone(outs)
    for got in (a, b):
        _assert_same(got, outs)
    ptrs = {t.untyped_storage().data_ptr() for out in (a, b) for t in _flat(out)}
    static = {t.untyped_storage().data_ptr() for t in _flat(outs)}
    assert not ptrs & static and len(ptrs) == 2 * len(_flat(outs))
    a[1][0, 0] += 1
    assert torch.equal(b[1], sums) and not torch.equal(a[1], sums)
    assert graphs._clone(outs[:4] + (None,))[4] is None
