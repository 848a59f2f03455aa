#!/usr/bin/env python3
"""Smoke test of the tpu_inspect_torch inspection paths on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card (``nvidia-smi`` name and power limit) and torch/CUDA versions;
2. build the sixteen CUDA kernels (A-L and the head kernels: Otsu, M the
   u8 Gaussian blur, N the adaptive mean, O Canny's gradient, NMS and
   thresholds) from ``tpu_inspect_torch/csrc``
   (one nvcc per source, all started together, sm_90a);
3. each kernel against its plain PyTorch version on the same CUDA inputs,
   bit-exact (tolerance 0): the standard workload's own stage inputs
   (48 units of 315x316: the seg and ROI tails, the median residual, the
   blob filter, Canny's strong/candidate planes for the flood, the
   inverted seg masks for its border form, candidate and fill planes for
   the labeling, and one unit of the diagnostic pass); kernel B also at k =
   45, the largest it takes; the whole-image route's inputs (the standard
   image as one 1x3000x4096 unit: kernels B (k = 21 and 45), D and E on
   whole planes, kernel F on the labels of the seg mask and of the ROI,
   kernel G on the defect tail's fill labels, top-level blobs and
   exterior); kernel H's full median at k = 47, 49 and 101 on the 48 units
   and at k = 47 on the whole plane, at k = 101 and 301 above the unit and
   at k = 46341 (its 64-bit bins) on small planes; kernel I's chains with
   their heads (close/open with the threshold, the ROI erode, the open with
   the ROI AND) on the 48 units and on the whole plane, and the 401x401
   erode (erode_px 200) on the whole plane; kernel F also
   on a whole plane of isolated pixels; kernel J on the 48
   units' eroded seg masks with an empty and a full unit, and on the one
   unit of the erosion preview; kernel K (the chained seg tail, zone and
   ROI tail) on the 48 units with and without the zone at erode_px 0, 6 and
   12; kernel L (the median probe) in its baseline mode at each strip length
   (k = 9 with row bounds, k = 21 on every row);
   the Otsu kernel (histogram and scan) on the 48 blurred crops and on the
   whole plane; kernel M (the blur) at k = 3 on the 48 crops and on the
   whole plane and at k = 31, kernel N (the adaptive compare at block 51,
   C = 10, on the blurred crops and on the whole plane; block 201; the mean
   alone); then M at k 3, 5, 7, 9 (sigma 0 and 1.7), 25 and 31 and N at
   blocks 3, 9, 51, 119 and 201 (the mean and the compare at C -1 and 10)
   on planes of the card's own generator at widths 1 and 31-33, H = 1 and
   units narrower than the pad (2x2, 7x2), on 3 crops of the workload and
   on the whole plane, and N on fault C7's unit (blur 25, block 119, C -1);
   kernel O (the Canny head) at the default thresholds on the 48 crops and
   on the whole plane, then at thresholds (1, 2), (12, 24), (127, 255) and
   the swapped (255, 127) on M's and N's edge planes, at H = 1 and 2 by
   widths 1 and 31-33, on planes whose edges lie on its tiles' edges and on
   ``synthetic.canny_edge_planes`` (a checkerboard, a constant plane,
   ridges and steps across each sector);
   kernels A and K at erode_px 200 and A, C and K on units too
   large for their shared-memory layout (the global-scratch variant);
   seeded random planes of odd sizes with an empty and a full unit, and a
   long 1-px serpentine; then the ``cuda``-marked tests of kernels M, N
   and O (their edge shapes; O also at widths 1-5, 31-33, 63-65, 127-129
   and 316 by H 1, 2, 3 and 40, on views with no row 4-byte aligned, at
   thresholds (-1, 0), (0, 2040) and (2040, 2040); the adaptive mean on
   the card against the CPU) and of the Otsu kernel (one and two grey
   levels, 1x1x1, 140 units of 143 px, 17-px units, a base 5 bytes past a
   16-byte boundary, 999x1001 units),
   of the redesigned A, K and C, of the redesigned D and E, of the
   redesigned B and H and of the redesigned I and F
   (``tests/test_torch_otsu.py``,
   ``tests/test_torch_cuda.py``, ``tests/test_torch_uf.py``,
   ``tests/test_torch_median_hist.py``: word-edge widths, tile seams and
   corners, staircases, spirals, serpentines, solid planes, real Canny
   edges, the sliding-histogram walk's strips and edges), and the captured
   replay of the one-capture program against its eager run
   (``tests/test_torch_graph.py``) and the capture stream's banded upload
   of three 4096x3000 captures against the program on resident captures
   (``tests/test_torch_streaming.py``) in one pytest subprocess, which runs
   beside phase 4 and is read before phase 4b;
4. every path on the card, each driven with the launch counts set to 0 just
   before it and read just after, and held field by field against the same
   engine on ``device="cpu"``: ``engine.inspect_image`` for the four
   otsu/adaptive x threshold/canny method combos on the standard workload
   (the reference capture; for otsu/threshold and adaptive/canny also a
   capture shifted by (7, -4), aligned to the first one's centroids),
   ``engine.defect_intermediates`` on a few units for both defect methods,
   and the whole-image route (kernels B, D, E, F, G and I, never A or C;
   I once a chain, three a seg + defect call, F once a tail):
   ``inspect_image`` with one 4096x3000 unit, ``segment_units`` (config1)
   and ``inspect_units`` (config1defect) on the reference and the shifted
   capture for otsu/threshold; the other combos on the card at full size,
   held against the CPU at full size for adaptive/threshold and on a
   centre crop for the two Canny combos; ``inspect_image`` with
   ``median_k = 47`` (kernel H) on the standard workload; an
   ``InspectionSession(device="cuda")`` (the reference, then the (7, -4)
   capture: segmentation, inspection, a single-unit defect test and its
   log lines, the erosion preview on kernels I and J), and a ``UIServer`` on
   127.0.0.1 driven over HTTP with ``median_k = 47`` (state, indexing,
   segmentation, inspection, a defect test, a selection and the canvas PNG
   with the selected unit's outline), each held against phase 4's CPU
   results for the same image and parameters; the chained path
   (``engine._ENABLE_CHAIN``: kernel K in place of A's two launches) on the
   reference capture against the split path and the CPU run; the six
   4096x3000 stream frames through ``inspect_image`` with the reference's
   anchors and without, each frame an eager one (the captured graphs
   dropped before each call), the references of what follows; the captured
   replay (:mod:`tpu_inspect_torch.graphs`) of the anchored split program:
   the six frames anchored through ``inspect_image``, two eager, one
   capture, three replays, each frame's launches equal and its outputs
   held field by field against its eager run, the (7, -4) capture's also
   against the CPU run, and ``GRAPHS`` read; the capture stream
   (``streaming.stream_inspect``) over the six frames with the reference's
   anchors and again without anchors on the chained path, the graphs
   dropped before each (two eager frames, a capture, three replays, read
   from ``GRAPHS``), every frame held against its eager run on the card;
   ``stream_inspect_paths``
   over PNG files and the CLI as subprocesses (gridgen, inspect, stream,
   doctor, profile), where the host can decode files (the port's
   libpng/libtiff loader, or cv2); the median-probe tool (kernel L's sweep of
   the walk's ablation modes x strip lengths);
   and, after a warm-up call, one capture's default program
   (``engine._inspect_image_device``: the reference capture, otsu/threshold,
   the exclusions) dispatched under ``torch.cuda.set_sync_debug_mode("error")``:
   nothing in it waits for the card; and the same for the whole-image
   route's seg and defect passes on one resident 1x3000x4096 unit; then
   the sharded paths (``tpu_inspect_torch.parallel``,
   ``streaming.stream_inspect_sharded``) through
   ``parallel.launch.run_spmd``, once under NCCL at world size = the GPU
   count and once on 4 gloo ranks sharing the card:
   ``inspect_units_sharded`` on the 48 units (the reference capture, then
   the (7, -4) capture aligned to its anchors), ``inspect_image_batch_
   sharded`` (2 frames on a 2x2 mesh), ``stream_inspect_sharded`` over
   the six frames (an even world), and ``segment_image_sharded`` and
   ``defect_image_sharded`` on the 4096x3000 reference image at every rank
   (at 4 and, on a sub-group, at 2 strips; Canny once), every call on every
   rank bit-exact field by field (:func:`digest`) against the single-GPU
   engine on the card and every rank's launches checked; the walls of each
   call (the slowest rank) are printed: ranks sharing one card measure the
   split's and the collectives' overhead, not scaling;
4b. the seeded differential fuzz (:mod:`tpu_inspect_torch.tools.fuzz_parity`)
   in this process at a fixed seed and trial count (``SMOKE_SEED``,
   ``SMOKE_TRIALS``): every entry point's trial class at least once (units,
   image, chained, whole, diag, preview and sharded), each call on the card
   held field by field against ``device="cpu"`` (and the CPU run against
   the oracle copy where the class has one), each call's launch counts
   equal to its route's; any failing trial exits non-zero;
5. times on the card: each kernel vs its plain version (CUDA events, median
   of repeated runs at the paths' shapes, the whole planes included; the
   kernels with a bound flag share one, read after the timings) beside
   its bound (the bytes the call must move at 3.35 TB/s, for N the larger
   of that and its floating operations at 67 TFLOP/s; for B and H also
   their design's floor, its operation count at the int32 issue rate,
   printed beside the times and kept out of the ``kernels`` line),
   each combo's
   ``inspect_image`` steady-state wall ms/image (host image in, host
   results out), the walls of ``segment_units`` and ``inspect_units`` on one
   4096x3000 unit (host arrays in, host results out; not ``bench.py``'s
   metrics, which time other programs), the
   session's and the UI server's calls, kernel K against kernel A's two
   calls, the chained ``inspect_image`` against the split one, the stream's
   device and wall ms per frame at prefetch 1 and 2 beside its modeled
   bound (frame bytes over the measured pinned H2D rate, plus the device
   time), the native decode per frame, the median probe's table (each
   ablation's share of the baseline), and a
   ``torch.profiler`` breakdown (:mod:`tpu_inspect_torch.utils.profile`) of
   each combo, the chain and the stream;
6. the benchmark runner (:mod:`tpu_inspect_torch.bench`) as a user runs it:
   ``python -m tpu_inspect_torch.cli bench`` and ``python -m
   tpu_inspect_torch.bench config1 | config1defect | stream``, each in its
   own process, its diagnostics and metric lines printed here; any non-zero
   exit, missing metric, null value or error fails the script; then one
   chained window of the headline form and one of config1defect dispatched
   here under ``torch.cuda.set_sync_debug_mode("error")``: the timed loops
   wait for the card nowhere but at their one read.

The second-to-last lines are the card line and one JSON object with the
per-kernel results; the last line is the JSON status object. Without CUDA,
or without the ``tpu_inspect_torch`` package beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS_KERNEL = 10
REPS_E2E = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, the data sheet
# H100 SXM int32 issue rate: 64 int32 lanes an SM a clock (the Hopper
# architecture white paper) x 132 SMs x 1.98 GHz boost
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# the sliding-histogram walk of kernels B and H (csrc/median_hist.cuh):
# operations a sample (byte read, bin address, shared atomic, compare, add)
# and a pixel's query (16 shared reads and their scan)
WALK_OPS_PER_SAMPLE = 5
WALK_OPS_PER_QUERY = 48
COMBOS = (("otsu", "threshold"), ("adaptive", "threshold"), ("otsu", "canny"),
          ("adaptive", "canny"))
SHIFTED = {("otsu", "threshold"), ("adaptive", "canny")}
DIAG_UNITS = 4
# the plain Canny combos take minutes on the CPU at 48 units (130-165 s
# each on an 8-core H100 host): their CPU run covers the grid's first
# two rows, the first 16 units, as bench.py's combo gate does
CPU_ROWS_CANNY = 2
PROFILE_REPS = 5
# the timed stream's profile: one pass over its frames. Each frame's host
# Otsu scan is about 5000 CPU ops, and the profiler's processing of the
# events of five passes took minutes of the script's time
PROFILE_REPS_STREAM = 1
REPS_WHOLE = 10
# the whole-image path each new kernel was ported for
WHOLE_HOME = "whole inspect_units otsu/threshold reference"
# every whole-image combo runs at full size on the card; for the Canny
# combos the CPU comparison takes this centre crop (above the route's gate):
# the crop's plain run already takes 30-35 s on an 8-core H100 host, and the
# full plane, 3.9x its area, would take the script past half its time limit
WHOLE_CROP = (1536, 2048)
CROPPED_DEFECT_METHODS = {"canny"}
# kernel H's path: the threshold method with a window of k*k >= 2048
BIG_K = 47
BIG_K_HOME = f"otsu/threshold median_k={BIG_K} reference"
SESSION_HOME = "session erosion_outline"
REPS_HOST = 5
# kernel K's path: the reference capture with the chain flag on
CHAIN_HOME = "chained otsu/threshold reference"
# the capture stream: (seed, shift) of each 4096x3000 frame; the first two
# are the standard workload's reference and (7, -4) captures
STREAM_FRAMES = ((0, (0, 0)), (1, (7, -4)), (2, (3, 5)), (3, (-6, 2)), (4, (0, -3)),
                 (5, (5, 1)))
STREAM_HOME = "stream anchored"
STREAM_CHAIN_HOME = "stream chained, no anchors"
# the captured replay (tpu_inspect_torch.graphs) of cell 4's program: the
# stream's frames in this order, anchored, through inspect_image; the
# first two run eagerly, the third captures, the rest replay
REPLAY_HOME = "otsu/threshold anchored replay"
REPLAY_ORDER = (2, 3, 4, 5, 1, 0)
STREAM_REPEATS = 3  # the timed stream: the frames this many times over
# kernel L's path: the median-probe tool's sweep
PROBE_HOME = "median probe tool"
PROBE_FORM = "baseline S32"  # kernel B's strip on grid units: L's top-level numbers


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def mark(what: str) -> None:
    """One line with the seconds since the script started, at each phase's
    start: where the run's time goes, against its 1200 s limit."""
    say(f"{what} at {time.perf_counter() - T_START:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi listed no GPU")
    return out[0].strip()


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two integer tensors/arrays of equal shape."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu().numpy()
    if a.shape != b.shape:
        fail(f"shape mismatch {a.shape} vs {b.shape}")
    if a.dtype != b.dtype:
        fail(f"dtype mismatch {a.dtype} vs {b.dtype}")
    if a.size == 0:
        return 0
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def cuda_ms(fn, reps: int) -> float:
    """Median per-call ms of ``fn`` over ``reps`` CUDA-event-timed calls
    (after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*items) -> int:
    """Bytes of every tensor among ``items`` (tuples are walked; an int is
    a byte count already)."""
    import torch

    total = 0
    for it in items:
        if isinstance(it, torch.Tensor):
            total += it.numel() * it.element_size()
        elif isinstance(it, int):
            total += it
        elif isinstance(it, (tuple, list)):
            total += nbytes(*it)
    return total


def roi_rows_bytes(x, k: int, row_lo, row_hi) -> int:
    """Bytes of the uint8 planes ``x`` [U, H, W] that a median residual on
    rows [row_lo, row_hi) of each unit must read: those rows and k // 2
    more on each side for the window, none for an empty range (every other
    row of the output is 0 without reading the input)."""
    import torch

    _, h, w = x.shape
    r = k // 2
    lo, hi = row_lo.cpu().long(), row_hi.cpu().long()
    rows = ((hi + r).clamp(max=h) - (lo - r).clamp(min=0)).clamp(min=0)
    return int(torch.where(hi > lo, rows, 0).sum()) * w * x.element_size()


def walk_ops(rows, h: int, w: int, k: int, strip: int) -> int:
    """Operations the sliding-histogram walk of kernels B and H does on
    planes of h x w whose units walk ``rows`` rows each, in strips of
    ``strip`` rows: each strip's warm-up adds min(k, h) rows of min(k, w)
    samples, each further row 2 min(k, w) (edge repeats not counted), and
    every walked pixel is queried once. The design's own count, not a bound
    on the function's work."""
    kc, kr = min(k, w), min(k, h)
    samples = 0
    for n in rows:
        strips = -(-n // strip)
        samples += w * (strips * kr * kc + (n - strips) * 2 * kc)
    return WALK_OPS_PER_SAMPLE * samples + WALK_OPS_PER_QUERY * w * sum(rows)


def http_json(srv, op: str, body: dict | None = None) -> dict:
    """GET /api/state (``op == "state"``) or POST /api/<op> on the UI
    server; fails on any status but 200."""
    import urllib.request

    if op == "state":
        req = urllib.request.Request(f"{srv.url}api/state")
    else:
        req = urllib.request.Request(f"{srv.url}api/{op}", data=json.dumps(body or {}).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            fail(f"ui: {op} answered {r.status}")
        return json.loads(r.read())


def http_get(srv, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"{srv.url}api/{path}", timeout=300) as r:
        if r.status != 200 or r.headers.get("Content-Type") != "image/png":
            fail(f"ui: {path} answered {r.status} {r.headers.get('Content-Type')}")
        return r.read()


def png_pixels(data: bytes):
    """Pixels of a PNG from the port's encoder (8-bit gray or RGB, filter 0
    on every row), read with zlib: the card's host has no cv2."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("not a PNG")
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if depth != 8 or raw[:, 0].any():
        fail("PNG with a bit depth or a row filter this reader does not take")
    return raw[:, 1:].reshape((h, w, ch) if ch == 3 else (h, w))


def wall_ms(fn, reps: int) -> float:
    """Median host wall ms of ``fn`` (ending in a device sync) over ``reps``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_combo(label: str, run, card: str, per: int = 1, unit: str = "image",
                  reps: int = PROFILE_REPS):
    """Device time per kernel (and copy) over ``reps`` calls of ``run``
    under torch.profiler (:func:`tpu_inspect_torch.utils.profile.profile_device`),
    per call divided by ``per`` (the frames a call streams), beside the host
    wall of the same calls; the device's idle share is 1 - busy / wall (the
    profiler adds host cost, so the share is an upper bound). Returns the
    profile."""
    from tpu_inspect_torch.utils.profile import profile_device

    prof = profile_device(run, reps)
    if not prof.rows:
        say(f"phase 5: profile {label}: the profiler recorded no device time")
        return prof
    say(f"phase 5: profile {label}: device busy {prof.busy_ms / per:.4f} ms of "
        f"{prof.wall_ms / per:.4f} ms wall per {unit} under the profiler (idle share "
        f"{prof.idle_share:.3f}) on {card}")
    for key, ms, count in prof.rows[:12]:
        say(f"phase 5:   {ms / per:9.4f} ms  x{count / per:g}  {key[:90]}")
    return prof


# ---- the sharded paths (tpu_inspect_torch.parallel, streaming) ---------------
# ranks sharing the one card under gloo (NCCL takes one rank a GPU)
SHARDED_GLOO_RANKS = 4
# the kernels each sharded call must launch on every rank
SHARDED_KERNELS = {
    "units": ("gauss_blur", "otsu", "seg_tail", "median_residual", "blob_filter"),
    "segment": ("gauss_blur", "otsu", "morph", "propagate"),
    "defect threshold": ("morph", "median_residual", "label", "cc_stats", "propagate",
                         "blob_select"),
    "defect canny": ("morph", "label", "cc_stats", "propagate", "blob_select", "canny_head"),
}


def digest(obj, prefix: str = "") -> dict:
    """Field by field, a result's fingerprint: each array's dtype, shape and
    sha256, each scalar's type and value (dataclasses, tuples and lists
    walked). Two results are bit-exact where their digests are equal."""
    import hashlib

    import numpy as np

    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (list, tuple)):
        items = list(enumerate(obj))
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {prefix: f"{a.dtype}{a.shape}:{hashlib.sha256(a.tobytes()).hexdigest()[:20]}"}
    else:
        return {prefix: f"{type(obj).__name__}:{obj!r}"}
    out = {}
    for k, v in items:
        out.update(digest(v, f"{prefix}{k}."))
    return out


def sharded_ranks(spec: dict) -> dict:
    """One rank's program of the sharded phase: every sharded entry point on
    the inputs ``spec`` names (arrays in ``spec["dir"]``), each call made
    once to warm up, then timed from a barrier to its host results, with
    this rank's launch counts in the timed call. Returns {call: {"digest",
    "wall_ms", "launches"}}."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
    from tpu_inspect_torch.parallel import (
        defect_image_sharded,
        inspect_image_batch_sharded,
        inspect_units_sharded,
        segment_image_sharded,
        strip_mesh,
    )
    from tpu_inspect_torch.streaming import stream_inspect_sharded

    arr = {n: np.load(Path(spec["dir"]) / f"{n}.npy", mmap_mode="r")
           for n in ("crops", "crops_shifted", "frames", "seg_mask")}
    world, rank = dist.get_world_size(), dist.get_rank()
    seg, dp, dp_canny, excl = spec["seg"], spec["dp"], spec["dp_canny"], spec["excl"]
    image = arr["frames"][0]
    out = {}

    def run(name, fn, group=None):
        fn()
        dist.barrier(group=group)
        reset_launches()
        t0 = time.perf_counter()
        res = fn()
        wall = (time.perf_counter() - t0) * 1e3
        out[name] = {"digest": digest(res), "wall_ms": wall, "launches": dict(LAUNCHES)}

    units = dict(seg=seg, defect=dp, exclusions=excl)
    run("units reference", lambda: inspect_units_sharded(arr["crops"], is_reference=True, **units))
    run("units aligned", lambda: inspect_units_sharded(
        arr["crops_shifted"], ref_centroids=spec["unit_anchors"], is_reference=False, **units))
    n_img = 2 if world % 2 == 0 else 1
    run(f"image batch {n_img}", lambda: inspect_image_batch_sharded(
        arr["frames"][:n_img], spec["grid"], seg, dp, excl, ref_centroids=spec["stream_anchors"]))
    if world % 2 == 0:
        run("stream", lambda: list(stream_inspect_sharded(
            arr["frames"], spec["grid"], seg, dp, excl, ref_centroids=spec["stream_anchors"],
            fetch_masks=True)))
    meshes = [(world, None)]
    if world >= 4:
        # a 2-strip mesh over ranks 0 and 1 (every rank makes the group)
        meshes.append((2, dist.new_group([0, 1])))
    for n, group in meshes:
        if rank >= n:
            continue
        run(f"segment {n} strips", lambda: segment_image_sharded(
            image, seg, mesh=strip_mesh(group)), group)
        run(f"defect threshold {n} strips", lambda: defect_image_sharded(
            image, arr["seg_mask"], dp, mesh=strip_mesh(group)), group)
        if group is None:
            run(f"defect canny {n} strips", lambda: defect_image_sharded(
                image, arr["seg_mask"], dp_canny, mesh=strip_mesh()))
    torch.cuda.synchronize()
    return out


def sharded_phase(work, frames, frame_refs, stream_anchors, seg, dparams, card):
    """The sharded paths on the card: :func:`sharded_ranks` under NCCL at
    world size = the GPU count, then under gloo on ``SHARDED_GLOO_RANKS``
    ranks sharing the card; every call on every rank held by
    :func:`digest` against the single-GPU engine on the card
    (``inspect_units``; ``inspect_image`` for the batch and the stream, from
    phase 4's ``frame_refs``; ``segment_units`` and ``detect_defects_batch``
    on one 4096x3000 unit for the strips), and every rank's launches
    checked. Returns (launches by path, walls by run)."""
    import numpy as np
    import torch

    from tpu_inspect_torch import engine
    from tpu_inspect_torch.config import DefectParams
    from tpu_inspect_torch.imageio import crops_for_grid
    from tpu_inspect_torch.parallel.launch import run_spmd
    from tpu_inspect_torch.streaming import StreamResult

    grid, excl = work["grid"], work["exclusions"]
    dp_canny = DefectParams(method="canny").validated()
    crops = crops_for_grid(frames[0], grid, device="cuda").cpu().numpy()
    crops_shifted = crops_for_grid(frames[1], grid, device="cuda").cpu().numpy()

    def units_ref(c, **kw):
        s, i = engine.inspect_units(c, seg, dparams, excl, device="cuda", **kw)
        return s, dataclasses.replace(i, areas=i.areas.astype(np.int64))

    ref_units = units_ref(crops)
    unit_anchors = ref_units[0].centroid_dict()
    refs = {"units reference": ref_units,
            "units aligned": units_ref(crops_shifted, ref_centroids=unit_anchors,
                                       is_reference=False)}
    for n_img in (1, 2):
        fr = frame_refs[:n_img]
        refs[f"image batch {n_img}"] = tuple(np.stack(x) for x in zip(*[
            (i.verdicts, i.areas, i.valid, s.masks, i.defect_masks) for s, i in fr]))
    refs["stream"] = [StreamResult(index=j, verdicts=i.verdicts, areas=i.areas, valid=i.valid,
                                   ng_count=int(i.verdicts.sum()), seg_masks=s.masks,
                                   defect_masks=i.defect_masks)
                      for j, (s, i) in enumerate(frame_refs)]
    whole = frames[0][None]
    seg_mask = engine.segment_units(whole, seg, (), device="cuda").masks[0]
    for tag, dp in (("threshold", dparams), ("canny", dp_canny)):
        i = engine.detect_defects_batch(whole, seg_mask[None], dp, device="cuda")
        refs[f"defect {tag}"] = (i.defect_masks[0], bool(i.valid[0]), int(i.areas[0]),
                                 bool(i.verdicts[0]))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_")
    for name, a in (("crops", crops), ("crops_shifted", crops_shifted),
                    ("frames", np.stack(frames)), ("seg_mask", seg_mask)):
        np.save(Path(tmp.name) / f"{name}.npy", a)
    spec = dict(dir=tmp.name, grid=grid, seg=seg, dp=dparams, dp_canny=dp_canny, excl=excl,
                unit_anchors=unit_anchors, stream_anchors=stream_anchors)
    torch.cuda.empty_cache()
    launches_by_path, walls = {}, {}
    for backend, world in (("nccl", torch.cuda.device_count()), ("gloo", SHARDED_GLOO_RANKS)):
        run_name = f"{backend} x{world}"
        t0 = time.perf_counter()
        ranks = run_spmd(functools.partial(sharded_ranks, spec), world, backend)
        total_s = time.perf_counter() - t0
        walls[run_name] = {}
        for name in ranks[0]:
            strips = name.endswith(" strips")
            kind = name.rsplit(" ", 2)[0] if strips else "units"
            want = digest(seg_mask if kind == "segment" else refs[kind if strips else name])
            on = [r for r in ranks if name in r]
            for rank, r in enumerate(on):
                got = r[name]
                bad = sorted(k for k in want.keys() | got["digest"].keys()
                             if want.get(k) != got["digest"].get(k))
                if bad:
                    fail(f"sharded {run_name} {name}: rank {rank} differs from the single-GPU "
                         f"engine on the card in {bad[:6]}")
                missed = [k for k in SHARDED_KERNELS[kind] if got["launches"][k] < 1]
                if missed:
                    fail(f"sharded {run_name} {name}: rank {rank} launched no {missed}: "
                         f"{got['launches']}")
            launches_by_path[f"sharded {run_name} {name}"] = ranks[0][name]["launches"]
            walls[run_name][name] = max(r[name]["wall_ms"] for r in on)
            say(f"phase 4: sharded {run_name} {name}: bit-exact on its {len(on)} ranks, wall "
                f"{walls[run_name][name]:.4f} ms (slowest rank), rank 0 launches "
                f"{ {k: v for k, v in ranks[0][name]['launches'].items() if v} }")
        walls[run_name]["run_spmd total s"] = total_s
        say(f"phase 4: sharded {run_name}: {len(ranks[0])} calls, run_spmd {total_s:.2f} s "
            f"with spawning, on {card}")
    say("phase 4: sharded walls: ranks sharing one card measure the split's and the "
        "collectives' overhead, not scaling")
    tmp.cleanup()
    return launches_by_path, walls


# ---- the benchmark runner (tpu_inspect_torch.bench) ---------------------------

# each form as a user runs it: the command and the metrics it prints
RUNNER_FORMS = (
    (("-m", "tpu_inspect_torch.cli", "bench"), ("full_grid_4096x3000_seg_defect_ms_per_image",)),
    (("-m", "tpu_inspect_torch.bench", "config1"), ("single_unit_4096x3000_segmentation_ms",)),
    (("-m", "tpu_inspect_torch.bench", "config1defect"), ("single_unit_4096x3000_seg_defect_ms",)),
    (("-m", "tpu_inspect_torch.bench", "stream"), ("stream_4096x3000_device_ms_per_frame",
                                                  "stream_4096x3000_wall_ms_per_frame")),
)
RUNNER_SYNC_PASSES = 4  # passes of each chained window under the sync check


def runner_phase(work, seg, dparams, card) -> dict:
    """Phase 6: every form of the benchmark runner as a subprocess (its
    diagnostics and metric lines printed here), each metric line parsed and
    required non-null without an error, every process required to exit 0;
    then one chained window of the headline form and one of config1defect
    dispatched in this process under ``set_sync_debug_mode("error")``.
    Returns {metric: its line}."""
    import torch

    from tpu_inspect_torch import bench
    from tpu_inspect_torch.kernels import LAUNCHES, build, error_flag, reset_launches

    lines = {}
    for argv, metrics in RUNNER_FORMS:
        form = " ".join(argv[1:])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                              timeout=400)
        for line in proc.stderr.strip().splitlines():
            say(f"phase 6: {form} | {line}")
        if proc.returncode != 0:
            fail(f"runner form {form} exited {proc.returncode}")
        for line in proc.stdout.strip().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                fail(f"runner form {form} printed a line that is not JSON: {line!r}")
            if rec.get("value") is None or "error" in rec:
                fail(f"runner form {form}: {line}")
            lines[rec["metric"]] = rec
            say(f"phase 6: {form} | {line}")
        missing = [m for m in metrics if m not in lines]
        if missing:
            fail(f"runner form {form} printed no line for {missing}")
        say(f"phase 6: {form} took {time.perf_counter() - t0:.1f} s (process wall)")

    dev = torch.device("cuda")
    image = torch.from_numpy(work["image"]).to(dev)
    origins = torch.from_numpy(work["origins"]).to(dev)
    windows = (
        ("headline", lambda err: bench.image_step(origins, work["unit_hw"], seg, dparams,
                                                  work["exclusions"], err), image),
        ("config1defect", lambda err: bench.unit_step(seg, dparams, err), image[None]),
    )
    for label, make_step, x in windows:
        flag = error_flag(dev)
        int(bench.chain(make_step(flag), x, 1)[0])
        flag = error_flag(dev)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc, _ = bench.chain(make_step(flag), x, RUNNER_SYNC_PASSES)
        except RuntimeError as e:
            fail(f"runner sync check ({label}): the chained window waited for the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        total = int(acc)
        build.check_bounded(f"runner sync check ({label})", flag)
        say(f"phase 6: {label}'s chained window of {RUNNER_SYNC_PASSES} passes dispatched "
            f"under set_sync_debug_mode('error') without a wait (accumulator {total}), "
            f"launches {dict(LAUNCHES)} on {card}")
    return lines


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (ROOT / "tpu_inspect_torch" / "csrc").is_dir():
        fail(f"tpu_inspect_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from tpu_inspect_torch import engine, geometry, graphs, native, render
    from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
    from tpu_inspect_torch.imageio import crops_for_grid, gather_crops
    from tpu_inspect_torch.kernels import (
        GRAPHS,
        LAUNCHES,
        build,
        error_flag,
        reset_graphs,
        reset_launches,
    )
    from tpu_inspect_torch.ops.blob import blob_filter, blob_filter_plain, candidate_mask
    from tpu_inspect_torch.ops.blob_select import blob_select, blob_select_plain
    from tpu_inspect_torch.ops.canny import canny_planes, canny_planes_plain, canny_u8
    from tpu_inspect_torch.ops.contour import fill_regions
    from tpu_inspect_torch.ops.cc import (
        component_stats,
        component_stats_plain,
        label_components,
        label_components_plain,
        largest_component,
        largest_component_sums,
    )
    from tpu_inspect_torch.ops.flood import propagate, propagate_plain
    from tpu_inspect_torch.ops.fused import (
        seg_roi_tail,
        seg_roi_tail_plain,
        seg_tail,
        seg_tail_plain,
        tail_mask,
    )
    from tpu_inspect_torch.ops.gaussian import (
        adaptive_gaussian_mean,
        adaptive_gaussian_mean_plain,
        gaussian_blur_u8,
        gaussian_blur_u8_plain,
    )
    from tpu_inspect_torch.ops.median import (
        median_blur_u8,
        median_blur_u8_plain,
        median_residual_mask,
        median_residual_mask_plain,
        strip_rows,
    )
    from tpu_inspect_torch.ops.morphology import (
        close_open_stages,
        morph_chain,
        morph_chain_plain,
        open_stages,
        rect_erode_stages,
    )
    from tpu_inspect_torch.ops.threshold import (
        adaptive_threshold_inv,
        adaptive_threshold_inv_plain,
        histogram_u8,
        otsu_threshold,
        otsu_threshold_from_hist,
        otsu_threshold_plain,
    )
    from tpu_inspect_torch.persistence import load_grid
    from tpu_inspect_torch.png import encode_png
    from tpu_inspect_torch.session import InspectionSession
    from tpu_inspect_torch.streaming import stream_inspect, stream_inspect_paths
    from tpu_inspect_torch.tools import fuzz_parity, median_probe
    from tpu_inspect_torch.ui import UIServer
    from tpu_inspect_torch.synthetic import (
        canny_edge_planes,
        make_mold_image,
        serpentine_plane,
        standard_workload,
    )

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

    # ---- phase 1: the card -------------------------------------------------
    card = card_line()
    say(card)
    say(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: build --------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = build.build(extra_flags=("-Xptxas", "-v"))
    build.lib()
    say(f"phase 2: built {lib_path.name} from {len(build.sources())} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernels vs plain versions, bit-exact ------------------
    mark("phase 3 starts")
    seg = SegmentationParams().validated()
    seg_ad = SegmentationParams(method="adaptive").validated()
    dparams = DefectParams().validated()
    work = standard_workload()
    h, w = work["unit_hw"]
    image = torch.from_numpy(work["image"]).to(dev)
    origins = torch.from_numpy(work["origins"]).to(dev)
    crops = gather_crops(image, origins, (h, w))
    x = gaussian_blur_u8(crops, seg.gaussian_blur)
    thr = otsu_threshold(x)
    ad_block, ad_c = max(3, seg_ad.adapt_block | 1), seg_ad.adapt_C
    x_ad = adaptive_threshold_inv(x, ad_block, ad_c)
    co = close_open_stages(seg.morph_kernel)
    erode = rect_erode_stages(dparams.erode_px)
    k, t_res = dparams.median_k, dparams.threshold
    seg_masks = engine._segment(crops, seg, work["exclusions"], None, True)[0]
    roi, roi_st = seg_tail(seg_masks, erode, out_largest=True)
    row_lo, row_hi = roi_st[:, 4].contiguous(), roi_st[:, 5].contiguous()
    max_area = torch.clamp(
        torch.floor(roi_st[:, 0].to(torch.float64) * dparams.max_area_frac),
        min=dparams.min_area,
    ).to(torch.int32)
    max_x2 = (2 * max_area).contiguous()
    min_x2 = 2 * dparams.min_area
    cand = median_residual_mask(crops, k, t_res, row_lo, row_hi)
    lo_c, hi_c = max(1, t_res // 2), max(2, t_res)
    strong, cand_c = canny_planes(crops, lo_c, hi_c)
    edges = propagate(strong, cand_c, True).to(torch.uint8) * 255
    free = (seg_masks == 0).contiguous()
    cand_roi = (cand_c & (roi > 0)).contiguous()
    fill_roi = (~propagate(None, (~cand_roi).contiguous(), False, border_seed=True)).contiguous()
    # the diagnostic pass's planes: the first unit whose ROI is not empty
    u0 = int(torch.nonzero(roi_st[:, 3] > 0)[0, 0])
    fg1 = cand_roi[u0 : u0 + 1].contiguous()
    free1 = (~fg1).contiguous()
    fill1 = (~propagate(None, free1, False, border_seed=True)).contiguous()

    # the whole-image route's planes: the standard image as ONE unit
    # (1x3000x4096, bench.py's config1 / config1defect), otsu/threshold
    whole = image[None].contiguous()
    x_w = gaussian_blur_u8(whole, seg.gaussian_blur)
    seg_pre_w = tail_mask(x_w, co, otsu_threshold(x_w))
    free_w = (~seg_pre_w).contiguous()
    seg_fill_w = seg_pre_w | ~propagate(None, free_w, False, border_seed=True)
    seg_lab_w = label_components(seg_fill_w)
    seg_mask_w = engine._segment(whole, seg, work["exclusions"], None, True)[0]
    roi_pre_w = tail_mask(seg_mask_w, erode)
    roi_lab_w = label_components(roi_pre_w)
    roi_w, roi_st_w = engine._whole_tail(seg_mask_w, erode, out_largest=True)
    row_lo_w = roi_st_w[:, 4].to(torch.int32).contiguous()
    row_hi_w = roi_st_w[:, 5].to(torch.int32).contiguous()
    max_x2_w = (2 * torch.clamp(
        torch.floor(roi_st_w[:, 0].to(torch.float64) * dparams.max_area_frac),
        min=dparams.min_area,
    ).to(torch.int32)).contiguous()
    m_w = candidate_mask(median_residual_mask(whole, k, t_res, row_lo_w, row_hi_w), roi_w, True)
    free_mw = (~m_w).contiguous()
    fill_w, top_w, ext_w = fill_regions(m_w)
    fill_plane_w = (~ext_w).contiguous()
    lin_w = torch.arange(m_w[0].numel(), dtype=torch.int32, device=dev).reshape(m_w.shape)
    seed_w = (m_w & (fill_w == lin_w)).contiguous()
    # the Canny form of the defect tail on the same ROI
    m_cw = candidate_mask(canny_u8(whole, lo_c, hi_c), roi_w, False)
    regions_cw = fill_regions(m_cw)
    say(f"phase 3: whole-image planes 1x3000x4096: seg mask {int(seg_fill_w.sum())} px, "
        f"ROI {int(roi_st_w[0, 0])} px, candidates {int(m_w.sum())} px (Canny "
        f"{int(m_cw.sum())} px)")
    # kernel I's inputs: each chain takes its head's own planes (the seg
    # tail's gray and threshold, the seg masks, the residual and its ROI)
    open3 = open_stages(3)
    thr_w = otsu_threshold(x_w)
    cand_w = median_residual_mask(whole, k, t_res, row_lo_w, row_hi_w)
    # kernel F's further form: a plane of isolated pixels on a 2-pixel grid,
    # the most components a plane holds (3.07 M)
    iso_w = torch.zeros_like(whole, dtype=torch.bool)
    iso_w[:, ::2, ::2] = True
    iso_lab_w = label_components(iso_w)
    # kernel J's planes: the eroded seg masks (an empty and a full unit in
    # place of the first two) and the erosion preview's unit
    j_plane = tail_mask(seg_masks, erode)
    j_plane[0], j_plane[1] = False, True
    j_one = tail_mask(seg_masks[u0 : u0 + 1], erode).contiguous()
    # kernel K's zone: the standard workload's exclusions rasterized once at
    # zero shift (the reference capture's), shared by every unit
    z0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    zone = engine.exclusion_zone((h, w), *engine.pack_exclusions(work["exclusions"]), z0, z0)[0]
    roi_rows_b = roi_rows_bytes(crops, k, row_lo, row_hi)

    # per kernel: (label, call, inputs read) at the paths' shapes; "path"
    # cases are what one inspect_image (or one diagnostic pass) runs, the
    # others are further forms, checked and timed alongside
    path_cases = {
        "seg_tail": [
            ("seg form", lambda f: f(x, co, fill=True, thr=thr), (x, thr)),
            ("roi form", lambda f: f(seg_masks, erode, out_largest=True), (seg_masks,)),
        ],
        "median_residual": [
            ("roi rows", lambda f: f(crops, k, t_res, row_lo, row_hi),
             (roi_rows_bytes(crops, k, row_lo, row_hi), row_lo, row_hi)),
        ],
        "blob_filter": [
            ("roi+open", lambda f: f(cand, max_x2, min_x2=min_x2, roi=roi, pre_open=True),
             (cand, max_x2, roi)),
        ],
        "propagate": [
            ("canny hysteresis", lambda f: f(strong, cand_c, True), (strong, cand_c)),
        ],
        "label": [
            ("diag fill plane", lambda f: f(fill1), (fill1,)),
            ("diag fg plane", lambda f: f(fg1), (fg1,)),
        ],
        "median_blur": [
            (f"k {BIG_K}, 48 units", lambda f: f(crops, BIG_K), (crops,)),
        ],
        "label_stats": [
            ("erosion preview unit", lambda f: f(j_one), (j_one,)),
        ],
        "seg_roi_tail": [
            ("chained, zone, erode 6", lambda f: f(x, co, erode, thr, zone), (x, thr, zone)),
        ],
        "median_probe": [
            (f"baseline S{sp}",
             lambda f, sp=sp: f(crops, k, t_res, row_lo, row_hi, "baseline", sp),
             (roi_rows_b, row_lo, row_hi))
            for sp in median_probe.STRIPS
        ],
        "otsu": [
            ("48 blurred crops", lambda f: f(x), (x,)),
        ],
        "gauss_blur": [
            (f"48 units, k {seg.gaussian_blur}", lambda f: f(crops, seg.gaussian_blur), (crops,)),
        ],
        "adaptive": [
            (f"48 units, block {ad_block}, C {ad_c}", lambda f: f(x, ad_block, ad_c), (x,)),
        ],
        "canny_head": [
            (f"48 units, low {lo_c}, high {hi_c}", lambda f: f(crops, lo_c, hi_c), (crops,)),
        ],
    }
    # units too large for kernels A's, C's and K's shared-memory layout:
    # their global-scratch variant
    big_rng = np.random.RandomState(21)
    big_u = torch.from_numpy(((big_rng.rand(2, 401, 421) > 0.45) * 255).astype(np.uint8)).to(dev)
    big_thr = torch.full((2,), 127, dtype=torch.int32, device=dev)
    big_mx = torch.full((2,), 2 * 401 * 421, dtype=torch.int32, device=dev)
    erode200 = rect_erode_stages(200)
    other_cases = {
        "seg_tail": [
            ("adaptive seg form", lambda f: f(x_ad, co, fill=True), (x_ad,)),
            ("roi form, erode 200", lambda f: f(seg_masks, erode200, out_largest=True),
             (seg_masks,)),
            ("global scratch 2x401x421", lambda f: f(big_u, co, fill=True), (big_u,)),
        ],
        "median_residual": [
            ("k 45, roi rows", lambda f: f(crops, 45, t_res, row_lo, row_hi),
             (roi_rows_bytes(crops, 45, row_lo, row_hi), row_lo, row_hi)),
        ],
        "blob_filter": [
            ("canny form (roi, no open)",
             lambda f: f(edges, max_x2, min_x2=min_x2, roi=roi, pre_open=False),
             (edges, max_x2, roi)),
            ("global scratch 2x401x421", lambda f: f(big_u, big_mx, min_x2=0, pre_open=True),
             (big_u, big_mx)),
        ],
        "propagate": [
            ("border form, seg masks", lambda f: f(None, free, False, border_seed=True), (free,)),
            ("border form, diag unit", lambda f: f(None, free1, False, border_seed=True), (free1,)),
        ],
        "label": [
            ("canny candidates 48u", lambda f: f(cand_c), (cand_c,)),
            ("fill planes 48u", lambda f: f(fill_roi), (fill_roi,)),
        ],
        "blob_select": [
            ("whole defect tail, Canny", lambda f: f(*regions_cw, max_x2_w, min_x2=min_x2),
             (*regions_cw, max_x2_w)),
        ],
        "median_blur": [
            ("k 49, 48 units", lambda f: f(crops, 49), (crops,)),
            ("k 101, 48 units", lambda f: f(crops, 101), (crops,)),
        ],
        "morph": [
            ("close/open k3, thr head, 48 units", lambda f: f(x, co, thr), (x, thr)),
            ("open 3x3, roi head, 48 units", lambda f: f(cand, open3, roi=roi), (cand, roi)),
            ("erode 13x13, 48 units", lambda f: f(seg_masks, erode), (seg_masks,)),
            ("whole erode 401x401", lambda f: f(seg_mask_w, erode200), (seg_mask_w,)),
        ],
        "cc_stats": [
            ("whole isolated px grid", lambda f: f(iso_lab_w, iso_w), (iso_lab_w, iso_w)),
        ],
        "label_stats": [
            ("eroded seg masks 48u, empty + full", lambda f: f(j_plane), (j_plane,)),
        ],
        "seg_roi_tail": [
            ("no zone, erode 6", lambda f: f(x, co, erode, thr), (x, thr)),
            ("zone, erode 0", lambda f: f(x, co, (), thr, zone), (x, thr, zone)),
            ("zone, erode 12", lambda f: f(x, co, rect_erode_stages(12), thr, zone),
             (x, thr, zone)),
            ("zone, erode 200", lambda f: f(x, co, erode200, thr, zone), (x, thr, zone)),
            ("global scratch 2x401x421", lambda f: f(255 - big_u, co, erode, big_thr),
             (big_u, big_thr)),
        ],
        "gauss_blur": [
            ("48 units, k 31", lambda f: f(crops, 31), (crops,)),
        ],
        "adaptive": [
            (f"48 units, block 201, C {ad_c}", lambda f: f(x, 201, ad_c), (x,)),
            (f"mean, 48 units, block {ad_block}", lambda f: f(x, ad_block), (x,)),
        ],
    }
    # the whole-image route (one inspect_units call on 1x3000x4096): B, D
    # and E on whole planes, and kernels F and G
    whole_cases = {
        "median_residual": [
            ("whole plane, ROI rows", lambda f: f(whole, k, t_res, row_lo_w, row_hi_w),
             (roi_rows_bytes(whole, k, row_lo_w, row_hi_w), row_lo_w, row_hi_w)),
            ("whole plane, ROI rows, k 45", lambda f: f(whole, 45, t_res, row_lo_w, row_hi_w),
             (roi_rows_bytes(whole, 45, row_lo_w, row_hi_w), row_lo_w, row_hi_w)),
        ],
        "propagate": [
            ("whole seg hole fill", lambda f: f(None, free_w, False, border_seed=True), (free_w,)),
            ("whole defect exterior", lambda f: f(None, free_mw, False, border_seed=True),
             (free_mw,)),
            ("whole top-level blobs", lambda f: f(seed_w, m_w, True), (seed_w, m_w)),
        ],
        "label": [
            ("whole seg mask", lambda f: f(seg_fill_w), (seg_fill_w,)),
            ("whole ROI", lambda f: f(roi_pre_w), (roi_pre_w,)),
            ("whole fill regions", lambda f: f(fill_plane_w), (fill_plane_w,)),
        ],
        "cc_stats": [
            ("whole seg mask", lambda f: f(seg_lab_w, seg_fill_w), (seg_lab_w, seg_fill_w)),
            ("whole ROI", lambda f: f(roi_lab_w, roi_pre_w), (roi_lab_w, roi_pre_w)),
        ],
        "blob_select": [
            ("whole defect tail",
             lambda f: f(fill_w, top_w, ext_w, max_x2_w, min_x2=min_x2),
             (fill_w, top_w, ext_w, max_x2_w)),
        ],
        "median_blur": [
            (f"k {BIG_K}, whole plane", lambda f: f(whole, BIG_K), (whole,)),
        ],
        "morph": [
            ("whole close/open k3, thr head", lambda f: f(x_w, co, thr_w), (x_w, thr_w)),
            ("whole erode 13x13", lambda f: f(seg_mask_w, erode), (seg_mask_w,)),
            ("whole open 3x3, roi head", lambda f: f(cand_w, open3, roi=roi_w), (cand_w, roi_w)),
        ],
        "otsu": [
            ("whole plane", lambda f: f(x_w), (x_w,)),
        ],
        "gauss_blur": [
            (f"whole plane, k {seg.gaussian_blur}", lambda f: f(whole, seg.gaussian_blur),
             (whole,)),
        ],
        "adaptive": [
            (f"whole plane, block {ad_block}, C {ad_c}", lambda f: f(x_w, ad_block, ad_c), (x_w,)),
        ],
        "canny_head": [
            (f"whole plane, low {lo_c}, high {hi_c}", lambda f: f(whole, lo_c, hi_c), (whole,)),
        ],
    }
    # kernel N's floating operations a form does (its bound is the larger
    # of these at the float32 rate and its bytes): at block k, k FMAs, a
    # multiply and (k - 1) / 2 adds and FMAs a pixel, an FMA counted as two
    def adaptive_flops(plane, kk):
        return plane.numel() * (2 * kk + 1 + 3 * (kk // 2))

    form_flops = {
        ("adaptive", f"48 units, block {ad_block}, C {ad_c}"): adaptive_flops(x, ad_block),
        ("adaptive", f"48 units, block 201, C {ad_c}"): adaptive_flops(x, 201),
        ("adaptive", f"mean, 48 units, block {ad_block}"): adaptive_flops(x, ad_block),
        ("adaptive", f"whole plane, block {ad_block}, C {ad_c}"): adaptive_flops(x_w, ad_block),
    }
    # the walk's forms (kernels B, H and L): the rows each unit walks and
    # the strip rows, for the design's operation count (walk_ops): B's and
    # L's ROI rows, H's every row; B and H at their wrappers' strips
    def roi_rows(lo, hi, n_rows):
        return [max(0, min(b, n_rows) - max(a, 0)) for a, b in zip(lo.tolist(), hi.tolist())]

    def walk_form(name, rows, hh, ww, kk, strip=None):
        return rows, hh, ww, kk, strip or strip_rows(name, len(rows), hh, ww)

    hh_w, ww_w = whole.shape[1:]
    walk_forms = {
        ("median_residual", "roi rows"):
            walk_form("median_residual", roi_rows(row_lo, row_hi, h), h, w, k),
        ("median_residual", "k 45, roi rows"):
            walk_form("median_residual", roi_rows(row_lo, row_hi, h), h, w, 45),
        ("median_residual", "whole plane, ROI rows"):
            walk_form("median_residual", roi_rows(row_lo_w, row_hi_w, hh_w), hh_w, ww_w, k),
        ("median_residual", "whole plane, ROI rows, k 45"):
            walk_form("median_residual", roi_rows(row_lo_w, row_hi_w, hh_w), hh_w, ww_w, 45),
        **{("median_blur", f"k {kb}, 48 units"):
           walk_form("median_blur", [h] * crops.shape[0], h, w, kb) for kb in (BIG_K, 49, 101)},
        ("median_blur", f"k {BIG_K}, whole plane"):
            walk_form("median_blur", [hh_w], hh_w, ww_w, BIG_K),
        **{("median_probe", f"baseline S{sp}"):
           walk_form("median_probe", roi_rows(row_lo, row_hi, h), h, w, k, sp)
           for sp in median_probe.STRIPS},
    }

    def design_floor(name, label):
        """(ops per walked pixel, ms at the int32 issue rate) of a walk form."""
        rows, hh, ww, kk, strip = walk_forms[(name, label)]
        ops = walk_ops(rows, hh, ww, kk, strip)
        return ops / max(1, ww * sum(rows)), ops / INT32_OPS_PER_S * 1e3

    def adaptive_fn(x_, k_, c_=None):
        """Kernel N: the path's form (the compare at ``c_``), or the mean."""
        return adaptive_gaussian_mean(x_, k_) if c_ is None else adaptive_threshold_inv(x_, k_, c_)

    def adaptive_fn_plain(x_, k_, c_=None):
        return (adaptive_gaussian_mean_plain(x_, k_) if c_ is None
                else adaptive_threshold_inv_plain(x_, k_, c_))

    def probe_plain(x_, k_, thr_, lo=None, hi=None, mode="baseline", strip=None):
        """Kernel L's plain version: kernel B's (its baseline mode only; the
        ablations are timed, never compared)."""
        if mode != "baseline":
            fail(f"median_probe: no plain version of the {mode} ablation")
        return median_residual_mask_plain(x_, k_, thr_, lo, hi)

    # every kernel with a bound (A, C, K, D, E, F, G) sets one flag, read
    # after the comparisons and after the timings (a wrapper given none
    # would wait for its own flag inside every timed call)
    bound_flag = error_flag(dev)

    def flagged(fn):
        return functools.partial(fn, err=bound_flag)

    kernel_fns = {
        "seg_tail": (flagged(seg_tail), seg_tail_plain),
        "median_residual": (median_residual_mask, median_residual_mask_plain),
        "blob_filter": (flagged(blob_filter), blob_filter_plain),
        "propagate": (flagged(propagate), propagate_plain),
        "label": (flagged(label_components), label_components_plain),
        "cc_stats": (flagged(component_stats), component_stats_plain),
        "blob_select": (flagged(blob_select), blob_select_plain),
        "median_blur": (median_blur_u8, median_blur_u8_plain),
        "morph": (morph_chain, morph_chain_plain),
        "label_stats": (flagged(largest_component_sums), largest_component),
        "seg_roi_tail": (flagged(seg_roi_tail), seg_roi_tail_plain),
        "median_probe": (median_probe.probe, probe_plain),
        "otsu": (otsu_threshold, otsu_threshold_plain),
        "gauss_blur": (gaussian_blur_u8, gaussian_blur_u8_plain),
        "adaptive": (adaptive_fn, adaptive_fn_plain),
        "canny_head": (canny_planes, canny_planes_plain),
    }

    def compare(name, label, got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        if err != 0:
            fail(f"{name} [{label}] differs from its plain version: max |err| {err}")
        return err

    errs = {name: 0 for name in kernel_fns}
    out_bytes = {}
    for cases in (path_cases, other_cases, whole_cases):
        for name, lst in cases.items():
            fast, plain = kernel_fns[name]
            for label, call, _ in lst:
                got, ref = call(fast), call(plain)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], compare(name, label, got, ref))
                out_bytes[(name, label)] = nbytes(got)
                shape = "x".join(str(d) for d in (got[0] if isinstance(got, tuple) else got).shape)
                say(f"phase 3: {name} [{label}] {shape} bit-exact vs plain")

    # seeded random planes: odd sizes, an empty and a full unit, edge-touching
    # blobs, and a long 1-px serpentine for the flood and the labeling
    rng = np.random.RandomState(0)
    for (u, hh, ww) in [(3, 37, 53), (2, 64, 41), (1, 5, 7)]:
        gray = torch.from_numpy(rng.randint(0, 256, (u, hh, ww), dtype=np.uint8)).to(dev)
        blobs = (rng.rand(u, hh, ww) > 0.55).astype(np.uint8) * 255
        blobs[0] = 0  # empty unit
        blobs_t = torch.from_numpy(blobs).to(dev)
        full = blobs_t.clone()
        full[-1] = 255  # full unit
        seeds = torch.from_numpy((rng.rand(u, hh, ww) > 0.97).astype(np.uint8)).to(dev)
        roi_r = torch.from_numpy(
            (rng.rand(u, hh, ww) > 0.1).astype(np.uint8) * 255).to(dev)
        thr_r = torch.from_numpy(rng.randint(60, 200, u).astype(np.int32)).to(dev)
        lo_r = torch.from_numpy(rng.randint(0, hh // 2, u).astype(np.int32)).to(dev)
        hi_r = torch.from_numpy(rng.randint(hh // 2, hh + 1, u).astype(np.int32)).to(dev)
        mx_r = torch.from_numpy(rng.randint(0, 2 * hh * ww, u).astype(np.int32)).to(dev)
        full_b = (full > 0).contiguous()
        gray_ef = gray.clone()
        gray_ef[0] = 255  # nothing at or below the threshold: an empty unit
        gray_ef[-1] = 0  # everything: a full unit
        zone_r = torch.from_numpy(
            (np.random.RandomState(hh * ww).rand(hh, ww) > 0.8).astype(np.uint8)).to(dev)
        lab_r = label_components(full_b)
        regions_r = fill_regions(full_b)
        cases = [
            ("seg_tail", "seg form", lambda f: f(gray, close_open_stages(3), fill=True, thr=thr_r)),
            ("seg_tail", "morph 7", lambda f: f(gray, close_open_stages(7), fill=True, thr=thr_r)),
            ("seg_tail", "morph 31", lambda f: f(gray, close_open_stages(31), fill=True, thr=thr_r)),
            ("seg_tail", "roi erode 25", lambda f: f(blobs_t, rect_erode_stages(25), out_largest=True)),
            ("seg_tail", "roi erode 2", lambda f: f(blobs_t, rect_erode_stages(2), out_largest=True)),
            ("seg_tail", "no stages", lambda f: f(blobs_t, (), out_largest=True)),
            ("median_residual", "k 9", lambda f: f(gray, 9, 24, lo_r, hi_r)),
            ("median_residual", "k 21", lambda f: f(gray, 21, 0)),
            ("median_residual", "k 3, thr 255", lambda f: f(gray, 3, 255, lo_r, hi_r)),
            ("median_residual", "k 45, 0/255", lambda f: f(blobs_t, 45, 0, lo_r, hi_r)),
            ("blob_filter", "roi+open", lambda f: f(blobs_t, mx_r, min_x2=6, roi=roi_r, pre_open=True)),
            ("blob_filter", "plain", lambda f: f(blobs_t, mx_r, min_x2=0)),
            ("propagate", "seeded 8-conn", lambda f: f(seeds, full, True)),
            ("propagate", "seeded 4-conn", lambda f: f(seeds, full, False)),
            ("propagate", "border 4-conn", lambda f: f(None, full, False, border_seed=True)),
            ("propagate", "border 8-conn", lambda f: f(None, full, True, border_seed=True)),
            ("label", "random", lambda f: f(full)),
            ("label", "inverted", lambda f: f((full == 0).contiguous())),
            ("cc_stats", "random", lambda f: f(lab_r, full_b)),
            ("blob_select", "random", lambda f: f(*regions_r, mx_r, min_x2=6)),
            ("blob_select", "random, min 0", lambda f: f(*regions_r, mx_r, min_x2=0)),
            ("median_blur", "k 3", lambda f: f(gray, 3)),
            ("median_blur", "k 47, 0/255", lambda f: f(blobs_t, 47)),
            ("morph", "close/open 7", lambda f: f(blobs_t, close_open_stages(7))),
            ("morph", "erode 25", lambda f: f(full, rect_erode_stages(25))),
            ("morph", "open 3", lambda f: f(full, open3)),
            ("morph", "close/open 3, thr head", lambda f: f(gray_ef, close_open_stages(3), thr_r)),
            ("morph", "close/open 4, roi head", lambda f: f(full_b, close_open_stages(4), roi=roi_r)),
            ("morph", "erode 200", lambda f: f(blobs_t, erode200)),
            ("label_stats", "random", lambda f: f(full_b)),
            ("label_stats", "inverted", lambda f: f((~full_b).contiguous())),
            ("seg_roi_tail", "zone, erode 6",
             lambda f: f(gray_ef, close_open_stages(3), rect_erode_stages(6), thr_r, zone_r)),
            ("seg_roi_tail", "no zone, erode 12",
             lambda f: f(gray_ef, close_open_stages(3), rect_erode_stages(12), thr_r)),
            *(case for sp in median_probe.STRIPS for case in (
                ("median_probe", f"baseline S{sp}",
                 lambda f, sp=sp: f(gray, 9, 24, lo_r, hi_r, "baseline", sp)),
                ("median_probe", f"baseline S{sp}, every row",
                 lambda f, sp=sp: f(gray, 21, 0, None, None, "baseline", sp)))),
            ("otsu", "random", lambda f: f(gray)),
            ("otsu", "two-level", lambda f: f(blobs_t)),
        ]
        if u == 3:
            # windows above the unit, on the first planes only (the plain
            # version's per-row loop is long at these k): 16- and 32-bit bins
            cases += [
                ("median_blur", "k 101, above the unit", lambda f: f(gray, 101)),
                ("median_blur", "k 301, 32-bit bins", lambda f: f(gray, 301)),
            ]
        for name, label, call in cases:
            fast, plain = kernel_fns[name]
            got, ref = call(fast), call(plain)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], compare(name, label, got, ref))
        say(f"phase 3: random {u}x{hh}x{ww} planes bit-exact for all kernels")
    # kernel H's 64-bit form: k = 46341, k*k > 2^31, on a 2x3x5 plane (the
    # plain version one output row a step, bounding its padded cumsum)
    tiny = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 3, 5),
                                                             dtype=np.uint8)).to(dev)
    errs["median_blur"] = max(errs["median_blur"], compare(
        "median_blur", "64-bit bins", median_blur_u8(tiny, 46341),
        median_blur_u8_plain(tiny, 46341, rows_per_step=1)))
    say("phase 3: median_blur [k 46341, 64-bit bins] 2x3x5 bit-exact vs plain")
    # kernels M and N at their edges: planes of the card's own generator at
    # widths 1 and 31-33, H = 1 and units narrower than the pad (2x2 at
    # k 31, 7x2 at block 201), 3 crops of the workload (raw and blurred),
    # the whole plane, and fault C7's unit (seed 3014 trial 91's first unit,
    # blur 25, block 119, C -1)
    gen = torch.Generator(device=dev).manual_seed(15)
    edge = [torch.randint(0, 256, sh, generator=gen, device=dev, dtype=torch.uint8)
            for sh in ((3, 40, 1), (2, 1, 64), (2, 37, 31), (1, 33, 32), (2, 29, 33), (1, 2, 2),
                       (1, 7, 2))]
    edge[2][1], edge[4][1] = 77, 255  # a flat and a saturated unit
    edge += [crops[:3].contiguous(), x[:3].contiguous()]
    n_head = 0
    for kb, sg in ((3, 0.0), (5, 0.0), (7, 0.0), (9, 0.0), (9, 1.7), (25, 0.0), (31, 0.0)):
        for pl in edge + [whole]:
            errs["gauss_blur"] = max(errs["gauss_blur"], compare(
                "gauss_blur", f"k {kb}, sigma {sg}, {tuple(pl.shape)}",
                gaussian_blur_u8(pl, kb, sg), gaussian_blur_u8_plain(pl, kb, sg)))
            n_head += 1
    for blk in (3, 9, 51, 119, 201):
        for pl in edge + [x_w]:
            for c_ in ((None, -1, 10) if pl is not x_w else (ad_c,)):
                errs["adaptive"] = max(errs["adaptive"], compare(
                    "adaptive", f"block {blk}, C {c_}, {tuple(pl.shape)}",
                    adaptive_fn(pl, blk, c_), adaptive_fn_plain(pl, blk, c_)))
                n_head += 1
    t7 = fuzz_parity.trials(3014, 1, start=91)[0]
    c7 = crops_for_grid(fuzz_parity.capture(t7, False), t7.get("grid"), device="cuda")[:1]
    x7 = gaussian_blur_u8(c7.contiguous(), 25)
    errs["gauss_blur"] = max(errs["gauss_blur"], compare(
        "gauss_blur", "C7 unit, k 25", x7, gaussian_blur_u8_plain(c7, 25)))
    m7 = adaptive_fn(x7, 119, -1)
    errs["adaptive"] = max(errs["adaptive"], compare(
        "adaptive", "C7 unit, block 119, C -1", m7, adaptive_fn_plain(x7, 119, -1)))
    torch.cuda.synchronize()
    say(f"phase 3: gauss_blur (k 3-31, sigma 0 and 1.7) and adaptive (blocks 3-201, the mean and "
        f"the compare) bit-exact vs plain in {n_head + 2} cases: widths 1 and 31-33, H = 1, "
        f"2x2 and 7x2 units, workload crops, the whole plane, and C7's unit "
        f"{tuple(c7.shape)} (pixel (275, 12): {int(m7[0, 275, 12])})")
    # kernel O at its edges: M's and N's edge planes, H = 1 and 2 by widths
    # 1 and 31-33, planes whose edges lie on its 32x64 tiles' edges (or one
    # past), and the sector and tie planes, at the path's thresholds for
    # threshold 0, 24 and 255 and a swapped pair
    canny_edge = edge + [
        torch.randint(0, 256, sh, generator=gen, device=dev, dtype=torch.uint8)
        for sh in [(2, hh, ww) for hh in (1, 2) for ww in (1, 31, 32, 33)]
        + [(1, 32, 64), (2, 33, 65), (1, 64, 128)]]
    canny_edge += [torch.from_numpy(canny_edge_planes(hh, ww, seed=hh)).to(dev)
                   for hh, ww in ((37, 45), (64, 128))]
    n_canny = 0
    for lo_e, hi_e in ((1, 2), (12, 24), (127, 255), (255, 127)):
        for pl in canny_edge:
            errs["canny_head"] = max(errs["canny_head"], compare(
                "canny_head", f"low {lo_e}, high {hi_e}, {tuple(pl.shape)}",
                canny_planes(pl, lo_e, hi_e), canny_planes_plain(pl, lo_e, hi_e)))
            n_canny += 1
    torch.cuda.synchronize()
    say(f"phase 3: canny_head bit-exact vs plain in {n_canny} cases: H = 1 and 2 by widths 1 "
        f"and 31-33, tile-edge planes, the sector and tie planes, workload crops, at "
        f"thresholds (1, 2), (12, 24), (127, 255) and (255, 127)")
    # kernel J beyond the paths' units: 2x401x421 and 1x1024x1024 (bands in
    # shared memory), and 1x8x131072, whose band slots (8 bytes a 2x2 block)
    # exceed a block's shared memory: the global-scratch form
    for (uj, hj, wj) in ((2, 401, 421), (1, 1024, 1024), (1, 8, 131072)):
        big_j = torch.from_numpy(np.random.RandomState(1).rand(uj, hj, wj) > 0.55).to(dev)
        errs["label_stats"] = max(errs["label_stats"], compare(
            "label_stats", f"{uj}x{hj}x{wj}", kernel_fns["label_stats"][0](big_j),
            largest_component(big_j)))
        say(f"phase 3: label_stats [{uj}x{hj}x{wj}] bit-exact vs plain")
    snake = torch.from_numpy(serpentine_plane(125, 316)[None]).to(dev)
    tip = torch.zeros_like(snake).flatten()
    tip[snake.flatten().nonzero().max()] = 1  # seed only the path's far end
    tip = tip.reshape(snake.shape)
    t0 = time.perf_counter()
    got = propagate(tip, snake, True)
    torch.cuda.synchronize()
    d_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = propagate_plain(tip, snake, True)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    errs["propagate"] = max(errs["propagate"], compare("propagate", "serpentine", got, ref))
    if not torch.equal(got, snake > 0):
        fail("propagate: the serpentine's far-end seed did not reach the whole path")
    lab = label_components(snake)
    errs["label"] = max(errs["label"], compare("label", "serpentine", lab, label_components_plain(snake)))
    if int(lab[snake > 0].unique().numel()) != 1:
        fail("label: the serpentine is not one component")
    say(f"phase 3: serpentine 1x125x316 ({int(snake.sum())} px path) bit-exact for "
        f"propagate ({d_ms:.2f} ms wall) vs plain ({p_ms:.1f} ms wall, a round per "
        f"pixel) and label")
    build.check_bounded("phase 3", bound_flag)
    # the cuda-marked tests of the Otsu kernel, of the redesigned A, K and C
    # (word-edge widths, staircases, spirals, erode 200, real Canny edges,
    # the global-scratch variant) and of the redesigned D and E (tile seams
    # and corners, word-edge widths, H = 1, solid planes, a U = 3 batch, a
    # spiral and a serpentine), of the redesigned B and H (widths 1, 31-33
    # and 315-316, H = 1, strips ending inside the ROI rows, empty and full
    # row ranges, flat and 0/255 planes, thr 0 and 255, k from 3 to 301 and
    # 46341, units never mixed), of the redesigned I and F (every head,
    # widths 1, 31-33, 63-65 and 4096, H = 1, morph_kernel 2/3/4/31,
    # erode_px 0/1/6/200; block-rank ties, the isolated-pixel grid, one
    # component, an empty unit, a label outside the plane), of the
    # redesigned J and G (band seams, diagonal joins at a seam, a tie across
    # bands, H = 1 and 2, widths 1 and 31-33, the global scratch; regions
    # first in the last odd row or column, one over many chunks, a whole
    # capture whose sums pass 2^31), the adaptive mean's float64 ops on the
    # card against the CPU (fault C7's unit, blocks 9-201), and the sync
    # checks, kernels M, N and O at their edge shapes (O also on the 48
    # crops and the whole plane, and at every width around its words and
    # tiles), the Otsu kernel's edge units, each against its plain version;
    # the files' other tests repeat this script's own checks. They run in a
    # process of their own beside phase 4 (both spend most of their time in
    # CPU runs to compare with), read before phase 4b and ended if this
    # process exits first.
    mark("phase 3: the cuda-marked tests start, beside phase 4")
    tests = ["tests/test_torch_cuda.py", "tests/test_torch_otsu.py", "tests/test_torch_uf.py",
             "tests/test_torch_median_hist.py", "tests/test_torch_cluster.py",
             "tests/test_torch_graph.py", "tests/test_torch_streaming.py"]
    selected = ("otsu or tails_ or roi_erode or canny_form or waits_nowhere or uf_ or median_hist "
                "or mask_chain or cc_stats_ or test_torch_cluster or public_name or adaptive_mean "
                "or gauss_blur_kernel or adaptive_kernel or head_kernels or canny_head_kernel "
                "or test_torch_graph or stream_on_card")
    test_log = tempfile.TemporaryFile(mode="w+")
    test_proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", *tests, "-q", "-m", "cuda", "-k", selected,
         "--noconftest", "-p", "no:cacheprovider"],
        cwd=ROOT, stdout=test_log, stderr=subprocess.STDOUT, text=True,
    )
    atexit.register(lambda: test_proc.poll() is None and test_proc.kill())

    # ---- phase 4: every path on the card vs the CPU run -----------------
    mark("phase 4 starts")
    grid = work["grid"]
    shifted_img = make_mold_image(grid, (3000, 4096), seed=1, shift=(7, -4))
    expect = {
        "threshold": ("seg_tail", "median_residual", "blob_filter"),
        "canny": ("seg_tail", "canny_head", "propagate", "blob_filter"),
    }
    launches_by_path = {}
    cpu_runs = {}  # path -> the CPU run's results, held against the session's
    for seg_m, def_m in COMBOS:
        sp = SegmentationParams(method=seg_m).validated()
        dp = DefectParams(method=def_m).validated()
        captures = [("reference", work["image"], True)]
        if (seg_m, def_m) in SHIFTED:
            captures.append(("shifted", shifted_img, False))
        ref_cent = None
        for cap_name, img, is_ref in captures:
            path = f"{seg_m}/{def_m} {cap_name}"
            kw = dict(exclusions=work["exclusions"], is_reference=is_ref,
                      ref_centroids=None if is_ref else ref_cent)
            reset_launches()
            s_gpu, i_gpu = engine.inspect_image(img, grid, sp, dp, device="cuda", **kw)
            launches = dict(LAUNCHES)
            launches_by_path[path] = launches
            # every unit is computed on its own, so the first rows of the
            # grid on the CPU must equal the first units of the card's run
            cpu_grid = grid
            if def_m == "canny":
                cpu_grid = dataclasses.replace(grid, units_y=CPU_ROWS_CANNY, blocks_y=1)
            n_cpu = cpu_grid.num_units
            t0 = time.perf_counter()
            s_cpu, i_cpu = engine.inspect_image(img, cpu_grid, sp, dp, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            cpu_runs[path] = (s_cpu, i_cpu)
            if (launches["seg_tail"] < 2 or any(launches[n] < 1 for n in expect[def_m])
                    or launches["otsu"] != (2 if seg_m == "otsu" else 0)
                    or launches["adaptive"] != (seg_m == "adaptive")
                    or launches["gauss_blur"] != 1
                    or launches["canny_head"] != (def_m == "canny")):
                fail(f"{path}: the path missed a kernel, launches {launches}")
            for field in ("masks", "centroids", "centroid_valid", "shifts"):
                a, b = getattr(s_gpu, field)[:n_cpu], getattr(s_cpu, field)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f"{path}: segmentation {field} differs from the CPU run")
            for field in ("defect_masks", "valid", "areas", "verdicts"):
                a, b = getattr(i_gpu, field)[:n_cpu], getattr(i_cpu, field)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f"{path}: inspection {field} differs from the CPU run")
            ng = int(i_gpu.verdicts.sum())
            if ng <= 0:
                fail(f"{path}: no NG unit (expected defects at rate 0.3)")
            med_shift = np.median(s_gpu.shifts, axis=0).tolist()
            say(f"phase 4: {path} 48 units on the card, the first {n_cpu} bit-exact vs "
                f"device=cpu ({cpu_s:.1f} s on the CPU): NG {ng}/{len(i_gpu.verdicts)}, "
                f"median shift {med_shift}, launches {launches}")
            if not is_ref and med_shift != [7.0, -4.0]:
                fail(f"{path}: shift not recovered: median {med_shift}, expected [7, -4]")
            if is_ref:
                ref_cent = s_gpu.centroid_dict()

    # one capture's program waits for the card nowhere: after a warm-up
    # call, the reference capture's default program (otsu/threshold, the
    # exclusions) dispatched under the sync debug mode "error", which raises
    # at any call that would wait (a blocking copy, an .item(), a bincount);
    # the bound flag is read after, where a caller copies results out. The
    # anchored program (a later capture with the reference's anchors) too.
    anchors_ref = cpu_runs["otsu/threshold reference"][0].centroid_dict()
    for label, ref_c, is_ref in (("reference", None, True), ("anchored", anchors_ref, False)):
        def dispatch(err, ref_c=ref_c, is_ref=is_ref):
            return engine._inspect_image_device(image, origins, (h, w), seg, dparams,
                                                work["exclusions"], ref_c, is_ref, True, err)

        dispatch(error_flag(dev))
        torch.cuda.synchronize()
        flag = error_flag(dev)
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(flag)
        except RuntimeError as e:
            fail(f"sync check ({label}): the program waited for the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        build.check_bounded(f"sync check ({label})", flag)
        ng = int(out[4][3].sum())
        if is_ref and ng != int(cpu_runs["otsu/threshold reference"][1].verdicts.sum()):
            fail(f"sync check ({label}): NG {ng} differs from the CPU run")
        say(f"phase 4: {label} capture's default program dispatched under "
            f"set_sync_debug_mode('error') without a wait: NG {ng}/48, launches {dict(LAUNCHES)}")

    crops_np = crops.cpu().numpy()
    masks_np = seg_masks.cpu().numpy()
    for def_m in ("threshold", "canny"):
        dp = DefectParams(method=def_m).validated()
        path = f"defect_intermediates/{def_m}"
        totals = dict.fromkeys(LAUNCHES, 0)
        for u in range(DIAG_UNITS):
            reset_launches()
            got = engine.defect_intermediates(crops_np[u], masks_np[u], dp, device="cuda")
            launches = dict(LAUNCHES)
            ref = engine.defect_intermediates(crops_np[u], masks_np[u], dp, device="cpu")
            if got != ref:
                fail(f"{path} unit {u}: {got} differs from the CPU run {ref}")
            needed = ["seg_tail"] + ([] if got["roi_empty"] else ["propagate", "label"])
            if any(launches[n] < 1 for n in needed):
                fail(f"{path} unit {u}: the path missed a kernel, launches {launches}")
            if not got["roi_empty"]:
                if launches["label"] < 2:
                    fail(f"{path} unit {u}: label launched {launches['label']} < 2 times")
                launches_by_path.setdefault(path, launches)  # one full pass
            for n, c in launches.items():
                totals[n] += c
        if path not in launches_by_path:
            fail(f"{path}: every unit had an empty ROI")
        say(f"phase 4: {path} on {DIAG_UNITS} units equal to device=cpu, launches "
            f"{totals} in all (last: {got})")

    # the whole-image route: the standard image as one 4096x3000 unit
    mark("phase 4: the whole-image route starts")
    whole_np = work["image"][None]
    whole_grid = GridParams(base_unit=(0, 0, 4096, 3000))
    cy, cx = (3000 - WHOLE_CROP[0]) // 2, (4096 - WHOLE_CROP[1]) // 2
    crop_np = np.ascontiguousarray(whole_np[:, cy : cy + WHOLE_CROP[0], cx : cx + WHOLE_CROP[1]])
    sp0 = SegmentationParams().validated()
    dp0 = DefectParams().validated()
    excl = work["exclusions"]

    def route_launches(path, launches, expect):
        """Fail unless every kernel of ``expect`` launched on the path,
        kernels A and C never, kernel I once a chain (the seg tail's; the
        ROI's and the candidates' with a defect pass), F once a tail, M
        once (the one seg pass) and O once on a Canny defect pass."""
        launches_by_path[path] = launches
        chains = {"morph": 3, "cc_stats": 2} if "blob_select" in expect else {
            "morph": 1, "cc_stats": 1}
        chains["gauss_blur"] = 1
        chains["canny_head"] = int("canny_head" in expect)
        if (any(launches[n] < 1 for n in expect) or launches["seg_tail"]
                or launches["blob_filter"] or any(launches[n] != c for n, c in chains.items())):
            fail(f"{path}: not the whole-image route, launches {launches}")

    def held(path, got, ref):
        """Fail unless the card's results equal the CPU run's, field by
        field, dtypes included."""
        pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
        for g, r in pairs:
            for field in dataclasses.fields(g):
                a, b = getattr(g, field.name), getattr(r, field.name)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f"{path}: {field.name} differs")

    seg_kernels = ("gauss_blur", "otsu", "propagate", "label", "cc_stats")
    def_kernels = {"threshold": seg_kernels + ("median_residual", "blob_select"),
                   "canny": seg_kernels + ("blob_select", "canny_head")}

    def route_kernels(seg_m, def_m):
        """The kernels a whole-image combo must launch (the Otsu kernel for
        the otsu method only, kernel N for the adaptive one)."""
        return tuple(n for n in def_kernels[def_m] if n != "otsu" or seg_m == "otsu") + (
            ("adaptive",) if seg_m == "adaptive" else ())
    # each entry point on the card is held against its own CPU run at full size
    whole_runs = [
        ("whole inspect_image otsu/threshold",
         lambda d: engine.inspect_image(work["image"], whole_grid, sp0, dp0, exclusions=excl,
                                        device=d), def_kernels["threshold"], False),
        ("whole segment_units (config1)",
         lambda d: engine.segment_units(whole_np, sp0, excl, device=d), seg_kernels, True),
        (WHOLE_HOME,
         lambda d: engine.inspect_units(whole_np, sp0, dp0, excl, device=d),
         def_kernels["threshold"], False),
    ]
    for path, run, expect, seg_only in whole_runs:
        reset_launches()
        got = run("cuda")
        launches = dict(LAUNCHES)
        route_launches(path, launches, expect)
        t0 = time.perf_counter()
        ref = run("cpu")
        cpu_s = time.perf_counter() - t0
        held(path, got, ref)
        s_res = got if seg_only else got[0]
        ng = "" if seg_only else f", NG {got[1].verdicts.tolist()}, area {got[1].areas.tolist()}"
        say(f"phase 4: {path} 1x3000x4096 on the card bit-exact vs device=cpu "
            f"({cpu_s:.1f} s on the CPU): centroid {s_res.centroids.tolist()}"
            f"{ng}, launches {launches}")
    ref_cent = s_res.centroid_dict()
    whole_cpu = ref  # WHOLE_HOME's CPU run

    # the whole-image route waits for the card nowhere either: after a
    # warm-up, one resident 1x3000x4096 unit's seg pass then defect pass
    # (kernels D, E, F and G setting one bound flag) under the sync debug
    # mode "error", the flag read after
    whole_dev = torch.from_numpy(whole_np).to(dev)

    def whole_program(err):
        m = engine._segment(whole_dev, sp0, excl, None, True, err)[0]
        return engine._defect(whole_dev, m, dp0, err)

    whole_program(error_flag(dev))
    torch.cuda.synchronize()
    flag = error_flag(dev)
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = whole_program(flag)
    except RuntimeError as e:
        fail(f"sync check (whole image): the route waited for the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    build.check_bounded("sync check (whole image)", flag)
    route_launches("whole sync check", dict(LAUNCHES), def_kernels["threshold"])
    if (out[2].cpu().numpy().tolist() != whole_cpu[1].areas.tolist()
            or not np.array_equal(out[0].cpu().numpy(), whole_cpu[1].defect_masks)):
        fail("sync check (whole image): the defect masks or areas differ from the CPU run")
    say(f"phase 4: whole-image seg + defect pass on a resident 1x3000x4096 unit dispatched "
        f"under set_sync_debug_mode('error') without a wait: area {out[2].tolist()}, "
        f"launches {dict(LAUNCHES)}")
    path = "whole inspect_units otsu/threshold shifted"
    shifted_np = shifted_img[None]
    reset_launches()
    got = engine.inspect_units(shifted_np, sp0, dp0, excl, ref_centroids=ref_cent,
                               is_reference=False, device="cuda")
    launches = dict(LAUNCHES)
    route_launches(path, launches, def_kernels["threshold"])
    t0 = time.perf_counter()
    ref = engine.inspect_units(shifted_np, sp0, dp0, excl, ref_centroids=ref_cent,
                               is_reference=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    held(path, got, ref)
    say(f"phase 4: {path} (7, -4) on the card bit-exact vs device=cpu "
        f"({cpu_s:.1f} s on the CPU): shift {got[0].shifts.tolist()}, NG "
        f"{got[1].verdicts.tolist()}, launches {launches}")
    if got[0].shifts.tolist() != [[7, -4]]:
        fail(f"{path}: shift not recovered: {got[0].shifts.tolist()}, expected [[7, -4]]")
    # the other combos at full size on the card; adaptive/threshold is held
    # against the CPU at full size too, the Canny combos on the centre crop
    # (above the gate: it takes the same route)
    for seg_m, def_m in COMBOS[1:]:
        sp = SegmentationParams(method=seg_m).validated()
        dp = DefectParams(method=def_m).validated()
        path = f"whole inspect_image {seg_m}/{def_m}"

        def run(d, sp=sp, dp=dp):
            return engine.inspect_image(work["image"], whole_grid, sp, dp, exclusions=excl,
                                        device=d)

        reset_launches()
        got = run("cuda")
        launches = dict(LAUNCHES)
        route_launches(path, launches, route_kernels(seg_m, def_m))
        if ((seg_m != "otsu" and launches["otsu"])
                or launches["adaptive"] != (seg_m == "adaptive") or launches["gauss_blur"] != 1):
            fail(f"{path}: not the {seg_m} head, launches {launches}")
        verdicts, areas = got[1].verdicts.tolist(), got[1].areas.tolist()
        if def_m not in CROPPED_DEFECT_METHODS:
            t0 = time.perf_counter()
            ref = run("cpu")
            cpu_s = time.perf_counter() - t0
            held(path, got, ref)
            say(f"phase 4: {path} 1x3000x4096 on the card bit-exact vs device=cpu "
                f"({cpu_s:.1f} s on the CPU): NG {verdicts}, area {areas}, launches {launches}")
            continue
        reset_launches()
        got = engine.inspect_units(crop_np, sp, dp, excl, device="cuda")
        route_launches(f"{path} crop", dict(LAUNCHES), route_kernels(seg_m, def_m))
        t0 = time.perf_counter()
        ref = engine.inspect_units(crop_np, sp, dp, excl, device="cpu")
        cpu_s = time.perf_counter() - t0
        held(f"{path} crop", got, ref)
        say(f"phase 4: {path} 1x3000x4096 on the card (NG {verdicts}, area "
            f"{areas}, launches {launches}); its centre crop "
            f"{WHOLE_CROP[0]}x{WHOLE_CROP[1]} bit-exact vs device=cpu ({cpu_s:.1f} s on the CPU)")

    # kernel H's path: the threshold method with median_k = 47 on the
    # standard workload (the full median, never kernel B)
    big = DefectParams(median_k=BIG_K).validated()
    excl = work["exclusions"]
    reset_launches()
    got = engine.inspect_image(work["image"], grid, seg, big, exclusions=excl, device="cuda")
    launches = dict(LAUNCHES)
    launches_by_path[BIG_K_HOME] = launches
    t0 = time.perf_counter()
    big_cpu = engine.inspect_image(work["image"], grid, seg, big, exclusions=excl, device="cpu")
    cpu_s = time.perf_counter() - t0
    if (launches["median_blur"] < 1 or launches["median_residual"] or launches["seg_tail"] < 2
            or launches["blob_filter"] < 1):
        fail(f"{BIG_K_HOME}: not the full-median path, launches {launches}")
    held(BIG_K_HOME, got, big_cpu)
    say(f"phase 4: {BIG_K_HOME} 48 units on the card bit-exact vs device=cpu ({cpu_s:.1f} s "
        f"on the CPU): NG {int(got[1].verdicts.sum())}/48, defect px "
        f"{int(got[1].areas.sum())}, launches {launches}")

    mark("phase 4: the session and the UI server start")
    # the interactive session on the card: the reference, then the (7, -4)
    # capture, each held against phase 4's CPU run of the same image
    cpu_ref, cpu_shift = (cpu_runs[f"otsu/threshold {c}"] for c in ("reference", "shifted"))
    sess = InspectionSession(device="cuda")
    sess.add_image("reference", work["image"])
    sess.add_image("shifted", shifted_img)
    sess.apply_indexing(grid)
    for e in excl:
        sess.add_exclusion(e)
    if sess.exclusions != list(excl):
        fail(f"session: the exclusions were clamped to {sess.exclusions}")
    reset_launches()
    held("session reference run_segmentation", sess.run_segmentation(), cpu_ref[0])
    sess.switch_to("shifted")  # re-runs segmentation on the reference's anchors
    seg_sh = sess.results().seg
    held("session shifted segmentation", seg_sh, cpu_shift[0])
    insp = sess.run_inspection()
    launches_by_path["session shifted"] = dict(LAUNCHES)
    for field in ("defect_masks", "valid", "verdicts"):
        if not np.array_equal(getattr(insp, field), getattr(cpu_shift[1], field)):
            fail(f"session shifted run_inspection: {field} differs from the CPU run")
    if not np.array_equal(insp.areas.astype(np.int64), cpu_shift[1].areas):
        fail("session shifted run_inspection: areas differ from the CPU run")
    u = int(np.flatnonzero(cpu_shift[1].verdicts)[0])
    crops_sh = gather_crops(torch.from_numpy(shifted_img), torch.from_numpy(work["origins"]),
                            (h, w)).numpy()
    d = engine.defect_intermediates(crops_sh[u], cpu_shift[0].masks[u], dp0, device="cpu")
    area_u, found_u = int(cpu_shift[1].areas[u]), bool(cpu_shift[1].valid[u])
    want = [f"Seg mask area (roi)={d['seg_area0']}, erode_px={d['erode_px']}"]
    if d["roi_empty"]:
        want.append("Segmentation mask empty after erode — skipping detection for this unit")
    else:
        if "resid_area" in d:
            want.append(f"Residual mask area={d['resid_area']}")
        want.append(f"Defect area filter: min={d['min_area']}, max={d['max_area']}, "
                    f"seg_area={d['roi_area']}")
        want += [f"Skipping large contour area={a} (>max={d['max_area']})"
                 for a in d["skipped_large"]]
    if not found_u:
        want.append("No defects found (or detection failed).")
    want.append(f"Unit {u}: defect area={area_u} px -> "
                f"{'NG' if area_u >= dp0.min_area else 'OK'}")
    n0 = len(sess.log.lines)
    res = sess.test_defect_unit(u)
    lines = list(sess.log.lines)[n0:]
    if lines != want:
        fail(f"session test_defect_unit({u}) logged {lines}, the CPU values give {want}")
    if (res["area"], res["found"]) != (area_u, found_u) or not np.array_equal(
            res["mask"], cpu_shift[1].defect_masks[u]):
        fail(f"session test_defect_unit({u}) differs from the CPU run")
    boxes = geometry.grid_boxes(grid)
    reset_launches()
    kind, outline = render.erosion_outline(seg_sh.masks[u], boxes[u], dp0.erode_px,
                                           device="cuda")
    launches = dict(LAUNCHES)
    launches_by_path[SESSION_HOME] = launches
    ref_outline = render.erosion_outline_mask(cpu_shift[0].masks[u], dp0.erode_px, device="cpu")
    if kind != "mask" or not np.array_equal(outline, ref_outline):
        fail(f"session erosion_outline of unit {u} differs from the CPU run")
    if launches["label_stats"] != 1 or launches["morph"] != 2:
        fail(f"{SESSION_HOME}: not kernels I and J, launches {launches}")
    say(f"phase 4: session (device=cuda) reference + (7, -4) capture equal to phase 4's CPU "
        f"runs: shift median {np.median(seg_sh.shifts, axis=0).tolist()}, NG "
        f"{int(insp.verdicts.sum())}/48; unit {u}'s defect test logged {len(lines)} lines "
        f"equal to the CPU values; its erosion outline ({int(outline.sum())} px) equal, "
        f"launches {launches}")

    # the UI server over HTTP, its session on the card with preloaded arrays,
    # median_k = 47: held against the k = 47 CPU run above
    ui_sess = InspectionSession(device="cuda")
    ui_sess.add_image("reference", work["image"])
    srv = UIServer(session=ui_sess)
    srv.start()
    reset_launches()
    st0 = http_json(srv, "state")
    if st0["current"] != "reference" or st0["image_size"] != [4096, 3000]:
        fail(f"ui: unexpected state {st0}")
    http_json(srv, "indexing", dataclasses.asdict(grid))
    for e in excl:
        http_json(srv, "exclusion_add", {"excl": e})
    http_json(srv, "defect_params", dataclasses.asdict(big))
    if http_json(srv, "run_segmentation", {})["units"] != 48:
        fail("ui: run_segmentation did not cover 48 units")
    ng = http_json(srv, "inspection", {"enabled": True})["ng"]
    st = http_json(srv, "state")
    big_insp = big_cpu[1]
    if (st["verdicts"], st["areas"], st["found"], ng) != (
            big_insp.verdicts.tolist(), big_insp.areas.tolist(), big_insp.valid.tolist(),
            int(big_insp.verdicts.sum())):
        fail("ui: the inspection state differs from the CPU run")
    idx = int(np.flatnonzero(big_insp.verdicts)[0]) if big_insp.verdicts.any() else 0
    r = http_json(srv, "test_defect", {"idx": idx})
    want_r = (int(big_insp.areas[idx]), "NG" if big_insp.verdicts[idx] else "OK",
              bool(big_insp.valid[idx]), list(boxes[idx]))
    if (r["area"], r["verdict"], r["found"], r["zoom_to"]) != want_r:
        fail(f"ui: test_defect {r} differs from the CPU run {want_r}")
    if http_json(srv, "select", {"idx": idx})["selected"] != idx:
        fail("ui: select")
    canvas_q = f"canvas.png?selected={idx}&outline=1"
    got_px = png_pixels(http_get(srv, canvas_q))
    ui_launches = dict(LAUNCHES)
    launches_by_path["ui server"] = ui_launches
    # the same render from the CPU run's results (no second CPU pass)
    exp = InspectionSession(device="cpu")
    exp.add_image("reference", work["image"])
    exp.grid, exp.exclusions, exp.defect_params = grid, list(excl), big
    exp.results().seg, exp.results().insp = big_cpu
    exp.overlay_mode, exp.inspection_enabled = ui_sess.overlay_mode, False
    want_px = png_pixels(UIServer(session=exp).render_png(
        {"selected": [str(idx)], "outline": ["1"]}))
    if got_px.shape != want_px.shape or not np.array_equal(got_px, want_px):
        fail("ui: the canvas PNG's pixels differ from the CPU run's render")
    if any(ui_launches[n] < 1 for n in ("median_blur", "morph", "label_stats", "seg_tail",
                                        "blob_filter")):
        fail(f"ui: kernels H, I and J did not all run, launches {ui_launches}")
    say(f"phase 4: UI server 127.0.0.1:{srv.port} (session on the card, median_k={BIG_K}) "
        f"equal to the CPU run: state verdicts/areas/found, test_defect unit {idx} "
        f"({r['verdict']}, {r['area']} px), canvas {got_px.shape} with the outline, "
        f"launches {ui_launches}")

    mark("phase 4: the chained path, the stream, the CLI and the probe start")
    # the chained path (kernel K in place of kernel A's two launches) on the
    # reference capture, against the split path on the card and the CPU run
    cpu_ref = cpu_runs["otsu/threshold reference"]
    engine._ENABLE_CHAIN = True
    reset_launches()
    chained = engine.inspect_image(work["image"], grid, seg, dparams, exclusions=excl,
                                   device="cuda")
    launches = dict(LAUNCHES)
    engine._ENABLE_CHAIN = False
    launches_by_path[CHAIN_HOME] = launches
    if (launches["seg_roi_tail"] != 1 or launches["seg_tail"] or launches["median_residual"] != 1
            or launches["blob_filter"] != 1 or launches["otsu"] != 2
            or launches["gauss_blur"] != 1):
        fail(f"{CHAIN_HOME}: not the chained path, launches {launches}")
    split = engine.inspect_image(work["image"], grid, seg, dparams, exclusions=excl,
                                 device="cuda")
    held(f"{CHAIN_HOME} vs the split path", chained, split)
    held(f"{CHAIN_HOME} vs device=cpu", chained, cpu_ref)
    say(f"phase 4: {CHAIN_HOME} 48 units on the card equal to the split path on the card and "
        f"to device=cpu: NG {int(chained[1].verdicts.sum())}/48, launches {launches}")

    # the capture stream: six 4096x3000 frames, first with the reference's
    # anchors, then without anchors (every frame a reference capture) on the
    # chained path; every frame held against inspect_image on the card
    frames = [work["image"], shifted_img] + [
        make_mold_image(grid, (3000, 4096), seed=sd, shift=sh) for sd, sh in STREAM_FRAMES[2:]]
    anchors = cpu_ref[0].centroid_dict()

    def eager_frame(f, anchored):
        """inspect_image on the card as an eager frame: the graphs dropped,
        so the call is its key's first sighting."""
        graphs.FRAMES.clear()
        return engine.inspect_image(
            f, grid, seg, dparams, exclusions=excl, ref_centroids=anchors if anchored else None,
            is_reference=not anchored, device="cuda")

    reset_graphs()
    frame_refs = {anchored: [eager_frame(f, anchored) for f in frames]
                  for anchored in (True, False)}
    if GRAPHS != {"captured": 0, "replayed": 0, "eager": 2 * len(frames), "refused": 0}:
        fail(f"the stream frames' references: not all eager, GRAPHS {GRAPHS}")

    # the captured replay of the anchored split program (cell 4's): every
    # frame's launches counted alone and equal, every frame held against
    # its eager run, the (7, -4) capture's also against the CPU run
    graphs.FRAMES.clear()
    reset_graphs()
    replayed, replay_launches = {}, []
    for i in REPLAY_ORDER:
        reset_launches()
        replayed[i] = engine.inspect_image(frames[i], grid, seg, dparams, exclusions=excl,
                                           ref_centroids=anchors, is_reference=False,
                                           device="cuda")
        replay_launches.append(dict(LAUNCHES))
    launches_by_path[REPLAY_HOME] = replay_launches[-1]
    n_rep = len(REPLAY_ORDER)
    if GRAPHS != {"captured": 1, "replayed": n_rep - 2, "eager": 2, "refused": 0}:
        fail(f"{REPLAY_HOME}: GRAPHS {GRAPHS}, expected 2 eager frames, one capture and "
             f"{n_rep - 2} replays (last refusal: {graphs.FRAMES.last_refusal})")
    if any(c != replay_launches[0] for c in replay_launches) or replay_launches[0]["seg_tail"] != 2:
        fail(f"{REPLAY_HOME}: launches differ between eager, captured and replayed frames: "
             f"{replay_launches}")
    for i, out in replayed.items():
        held(f"{REPLAY_HOME} frame {i} vs its eager run", out, frame_refs[True][i])
    held(f"{REPLAY_HOME} (7, -4) capture vs device=cpu", replayed[1],
         cpu_runs["otsu/threshold shifted"])
    say(f"phase 4: {REPLAY_HOME}: frames {list(REPLAY_ORDER)} 3000x4096 anchored, GRAPHS "
        f"{dict(GRAPHS)}, each frame equal to its eager run on the card and the (7, -4) "
        f"capture to device=cpu, launches a frame {replay_launches[0]}")

    def held_stream(path, results, refs):
        """Fail unless each streamed frame equals inspect_image's results on
        the card: verdicts, areas, found flags, and the masks if fetched."""
        if [r.index for r in results] != list(range(len(refs))):
            fail(f"{path}: frames {[r.index for r in results]} out of order")
        for r, (s_ref, i_ref) in zip(results, refs):
            for name, a, b in (("verdicts", r.verdicts, i_ref.verdicts),
                               ("areas", r.areas, i_ref.areas), ("valid", r.valid, i_ref.valid),
                               ("seg_masks", r.seg_masks, s_ref.masks),
                               ("defect_masks", r.defect_masks, i_ref.defect_masks)):
                if a is not None and (a.dtype != b.dtype or not np.array_equal(a, b)):
                    fail(f"{path}: frame {r.index} {name} differs from inspect_image on the card")
            if r.ng_count != int(i_ref.verdicts.sum()):
                fail(f"{path}: frame {r.index} ng_count {r.ng_count}")

    n_fr = len(frames)
    for path, anchored, prefetch in ((STREAM_HOME, True, 1), (STREAM_CHAIN_HOME, False, 2)):
        engine._ENABLE_CHAIN = not anchored
        graphs.FRAMES.clear()
        reset_graphs()
        reset_launches()
        res = list(stream_inspect(frames, grid, seg, dparams, exclusions=excl,
                                  ref_centroids=anchors if anchored else None,
                                  prefetch=prefetch, fetch_masks=True))
        launches = dict(LAUNCHES)
        engine._ENABLE_CHAIN = False
        launches_by_path[path] = launches
        if GRAPHS != {"captured": 1, "replayed": len(frames) - 2, "eager": 2, "refused": 0}:
            fail(f"{path}: GRAPHS {GRAPHS}, expected 2 eager frames, one capture and "
                 f"{len(frames) - 2} replays (last refusal: {graphs.FRAMES.last_refusal})")
        tails = {"seg_tail": 2 * n_fr, "seg_roi_tail": 0} if anchored else {
            "seg_tail": 0, "seg_roi_tail": n_fr}
        if any(launches[n] != c for n, c in {**tails, "median_residual": n_fr,
                                            "blob_filter": n_fr, "otsu": 2 * n_fr,
                                            "gauss_blur": n_fr, "adaptive": 0}.items()):
            fail(f"{path}: launches {launches} for {n_fr} frames")
        held_stream(path, res, frame_refs[anchored])
        say(f"phase 4: {path}: {n_fr} frames 3000x4096 at prefetch {prefetch}, each equal to "
            f"its eager run on the card (masks included): NG {[r.ng_count for r in res]}, "
            f"GRAPHS {dict(GRAPHS)}, launches {launches}")

    # files: stream_inspect_paths and the CLI read PNGs through the port's
    # native libpng/libtiff loader, or through cv2 where the host has no
    # libpng/libtiff to build it against; a host with neither reads no file
    decoder = ("native libpng/libtiff" if native.get_lib() is not None
               else "cv2" if importlib.util.find_spec("cv2") is not None else None)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    paths = []
    if decoder:
        for i, f in enumerate(frames):
            paths.append(str(Path(tmp.name) / f"frame_{i}.png"))
            Path(paths[-1]).write_bytes(encode_png(f))
        reset_launches()
        res = list(stream_inspect_paths(paths, grid, seg, dparams, exclusions=excl,
                                        ref_centroids=anchors))
        launches_by_path["stream_inspect_paths anchored"] = dict(LAUNCHES)
        held_stream("stream_inspect_paths", res, frame_refs[True])
        say(f"phase 4: stream_inspect_paths: {n_fr} PNG frames from the port's encoder, "
            f"decoded by {decoder}, equal to the in-memory stream")
    else:
        say("phase 4: stream_inspect_paths and the CLI's file commands not run: this host "
            "has neither libpng/libtiff nor cv2 to decode files (tests/test_torch_streaming.py "
            "and tests/test_torch_cli.py hold them on the CPU)")

    def run_cli(*args, env=None):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tpu_inspect_torch.cli", *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=600,
                           env={**os.environ, **(env or {})})
        if r.returncode != 0:
            fail(f"cli {args[0]} exited {r.returncode}: {r.stderr[-3000:]}")
        cli_s[args[0]] = time.perf_counter() - t0
        return r.stdout.strip().splitlines()

    def report_of(insp):
        """The CLI's per-image report fields from an engine result."""
        return {"ng_units": np.flatnonzero(insp.verdicts).tolist(),
                "ng_count": int(insp.verdicts.sum()), "unit_count": len(insp.verdicts),
                "areas": {str(i): int(a) for i, a in enumerate(insp.areas) if insp.valid[i]}}

    cli_s = {}
    grid_json = str(Path(tmp.name) / "grid.json")
    run_cli("gridgen", "--base", "251,232,316,315", "--units", "4x6", "--blocks", "2x1",
            "--unit-space", "133,136", "--block-space", "252,0", "--image-size", "4096x3000",
            "--out", grid_json)
    if geometry.grid_boxes(load_grid(grid_json).grid_params) != geometry.grid_boxes(grid):
        fail("cli gridgen: the grid file's boxes differ from the sample grid's")
    if decoder:
        # gridgen writes no exclusions: the engine runs below take none
        report = json.loads(run_cli("inspect", "--grid", grid_json, "--image", *paths[:2])[-1])
        s0, i0 = engine.inspect_image(frames[0], grid, seg, dparams, device="cuda")
        _, i1 = engine.inspect_image(frames[1], grid, seg, dparams,
                                     ref_centroids=s0.centroid_dict(), is_reference=False,
                                     device="cuda")
        if report != {paths[0]: report_of(i0), paths[1]: report_of(i1)}:
            fail(f"cli inspect: its report differs from the engine's: {report}")
        lines = [json.loads(x) for x in run_cli("stream", "--grid", grid_json, *paths,
                                                env={"TPU_INSPECT_ENABLE_CHAIN": "1"})]
        want = []
        for i, f in enumerate(frames):
            rep_i = report_of(engine.inspect_image(f, grid, seg, dparams, device="cuda")[1])
            want.append({"frame": paths[i], "index": i, "ng_count": rep_i["ng_count"],
                         "unit_count": rep_i["unit_count"], "ng_units": rep_i["ng_units"]})
        if lines != want:
            fail(f"cli stream (chained): its lines differ from the engine's: {lines}")
        say(f"phase 4: cli inspect (2 images) and stream ({n_fr} frames, the chain on) on the "
            f"card equal to the engine's results: NG {[x['ng_count'] for x in lines]}")
    doctor = run_cli("doctor")
    if not any(x.startswith("devices: 1 x cuda") for x in doctor) or not any(
            x.startswith("kernel library: libtik_") and "built;" in x for x in doctor):
        fail(f"cli doctor: {doctor}")
    prof_out = run_cli("profile", "--iters", "3")
    if not prof_out[0].startswith("device time:") or not any("seg_tail" in x for x in prof_out):
        fail(f"cli profile: {prof_out}")
    for line in doctor + prof_out[:6]:
        say(f"phase 4: cli | {line}")
    say(f"phase 4: cli subprocess walls (s) {json.dumps(cli_s)}")

    # kernel L's path: the median-probe tool's sweep (modes x strip rows)
    reset_launches()
    probe_table = median_probe.main()
    launches_by_path[PROBE_HOME] = dict(LAUNCHES)
    if LAUNCHES["median_probe"] < len(median_probe.MODES) * len(median_probe.STRIPS):
        fail(f"{PROBE_HOME}: launches {dict(LAUNCHES)}")

    # the sharded paths: NCCL at world size = the GPU count, then gloo ranks
    # sharing the card, every call held against the single-GPU engine on the
    # card (phase 4's stream frames included)
    mark("phase 4: the sharded paths start")
    sharded_launches, sharded_walls = sharded_phase(work, frames, frame_refs[True], anchors, seg,
                                                    dparams, card)
    launches_by_path.update(sharded_launches)
    say(f"phase 4: sharded walls (ms, the slowest rank) {json.dumps(sharded_walls)} on {card}")

    mark("phase 3: the cuda-marked tests read")
    try:
        test_proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        test_proc.kill()
        fail("the cuda-marked tests did not end within 600 s")
    test_log.seek(0)
    test_out = test_log.read()
    tail = (test_out.strip().splitlines() or ["(no output)"])[-1]
    if test_proc.returncode != 0:
        print(test_out[-9000:], file=sys.stderr)
        fail(f"the cuda-marked tests failed: {tail}")
    if "skipped" in tail or "passed" not in tail:
        fail(f"the cuda-marked tests did not all run: {tail}")
    say(f"phase 3: cuda-marked tests ({', '.join(tests)}): {tail}")

    # ---- phase 4b: the seeded differential fuzz ----------------------------
    # a fixed seed and trial count (not a time budget): every run does the
    # same work, every trial class once at least, the sharded one included
    mark("phase 4b starts")
    t0 = time.perf_counter()
    say(f"phase 4b: fuzz_parity seed {fuzz_parity.SMOKE_SEED}, {fuzz_parity.SMOKE_TRIALS} trials")
    fuzz = fuzz_parity.run(fuzz_parity.SMOKE_SEED, fuzz_parity.SMOKE_TRIALS, "cuda",
                           say=lambda line: say(f"phase 4b: {line}"))
    if fuzz["failures"]:
        fail(f"phase 4b: the fuzz found {fuzz['failures']} failing trials")
    if set(fuzz["per_class"]) != set(fuzz_parity.CLASSES):
        fail(f"phase 4b: the fuzz did not run every class: {fuzz['per_class']}")
    say(f"phase 4b: {fuzz['trials']} trials, 0 failures, {fuzz['otsu_ties']} Otsu ties in "
        f"{time.perf_counter() - t0:.1f} s on {card}")

    # ---- phase 5: times ----------------------------------------------------
    mark("phase 5 starts")
    def timed(name, lst):
        fast, plain = kernel_fns[name]
        rows = []
        for label, call, inputs in lst:
            ms = cuda_ms(lambda c=call: c(fast), REPS_KERNEL)
            pms = cuda_ms(lambda c=call: c(plain), REPS_KERNEL)
            bytes_ms = (nbytes(inputs) + out_bytes[(name, label)]) / HBM_BYTES_PER_S * 1e3
            ops_ms = form_flops.get((name, label), 0) / FP32_FLOPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            bound_by = "operations" if ops_ms > bytes_ms else "bytes"
            rows.append({"form": label, "ms": ms, "plain_ms": pms, "bound_ms": bound,
                         "bound_by": bound_by})
            floor = ""
            if (name, label) in walk_forms:
                # a model's count, not a measurement: printed, kept out of
                # the kernels line
                per_px, floor_ms = design_floor(name, label)
                floor = f", design floor {floor_ms:.4f} ms at {per_px:.0f} ops/px"
            say(f"phase 5: {name} [{label}] {ms:.4f} ms (plain {pms:.4f} ms, bound "
                f"{bound * 1e3:.2f} us by {bound_by}{floor}) on {card}")
        return rows

    times = {name: tuple(timed(name, cases.get(name, []))
                         for cases in (path_cases, other_cases, whole_cases))
             for name in kernel_fns}
    # the Otsu kernel's two launches apart: the histogram, and the scan on
    # a histogram already on the card
    for label, plane in (("48 blurred crops", x), ("whole plane", x_w)):
        hist_ms = cuda_ms(lambda p=plane: histogram_u8(p), REPS_KERNEL)
        hist = histogram_u8(plane)
        n_px = plane.shape[1] * plane.shape[2]
        scan_ms = cuda_ms(lambda hh=hist, n=n_px: otsu_threshold_from_hist(hh, n), REPS_KERNEL)
        say(f"phase 5: otsu [{label}] histogram {hist_ms:.4f} ms, scan {scan_ms:.4f} ms "
            f"on {card}")
    mark("phase 5: the kernels' times done; end-to-end times start")
    e2e = {}
    for seg_m, def_m in COMBOS:
        sp = SegmentationParams(method=seg_m).validated()
        dp = DefectParams(method=def_m).validated()
        img_np = work["image"]
        engine.inspect_image(img_np, grid, sp, dp, exclusions=work["exclusions"])
        torch.cuda.synchronize()
        walls = []
        for _ in range(REPS_E2E):
            t0 = time.perf_counter()
            engine.inspect_image(img_np, grid, sp, dp, exclusions=work["exclusions"])
            walls.append((time.perf_counter() - t0) * 1e3)
        e2e[f"{seg_m}/{def_m}"] = statistics.median(walls)
        say(f"phase 5: inspect_image {seg_m}/{def_m} steady state "
            f"{statistics.median(walls):.4f} ms/image (median of {REPS_E2E}, min "
            f"{min(walls):.4f}, wall incl. H2D/D2H) on {card}")
        profile_combo(
            f"{seg_m}/{def_m}",
            lambda: engine.inspect_image(img_np, grid, sp, dp, exclusions=work["exclusions"]),
            card,
        )
    for def_m in ("threshold", "canny"):
        dp = DefectParams(method=def_m).validated()
        walls = []
        for _ in range(REPS_E2E):
            t0 = time.perf_counter()
            engine.defect_intermediates(crops_np[u0], masks_np[u0], dp, device="cuda")
            walls.append((time.perf_counter() - t0) * 1e3)
        say(f"phase 5: defect_intermediates {def_m} {statistics.median(walls):.4f} ms "
            f"per unit (median of {REPS_E2E}, wall) on {card}")
    # the whole-image configurations: segmentation (config1; the centroid
    # stats included) and seg+defect (config1defect), one 4096x3000 unit
    whole_e2e = {
        "segment_units_4096x3000_wall_ms":
            lambda: engine.segment_units(whole_np, sp0, excl),
        "inspect_units_4096x3000_wall_ms":
            lambda: engine.inspect_units(whole_np, sp0, dp0, excl),
    }
    for label, run in whole_e2e.items():
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(REPS_WHOLE):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        e2e[label] = statistics.median(walls)
        say(f"phase 5: {label} steady state {e2e[label]:.4f} ms (median of {REPS_WHOLE}, "
            f"min {min(walls):.4f}, wall incl. H2D/D2H) on {card}")
    profile_combo("whole-image seg+defect (inspect_units, otsu/threshold)",
                  whole_e2e["inspect_units_4096x3000_wall_ms"], card)

    # kernel I's yardstick: its 13x13 rect erode is one library call, a max
    # pool of the negated plane (float16 holds 0..255 exactly; the -inf
    # padding is the erode's clip-to-plane border), timed alone
    lib_ms = {}
    for label, plane in (("erode 13x13, 48 units", seg_masks), ("whole erode 13x13", seg_mask_w)):
        neg = -(plane.to(torch.float16).unsqueeze(1))
        pool = torch.nn.functional.max_pool2d
        r = 2 * dparams.erode_px + 1
        if not torch.equal((-pool(neg, r, 1, r // 2)).squeeze(1) > 0, morph_chain(plane, erode)):
            fail(f"morph [{label}]: the library yardstick computes another function")
        lib_ms[label] = cuda_ms(lambda n=neg: pool(n, r, 1, r // 2), REPS_KERNEL)
        say(f"phase 5: library max_pool2d(-x, {r}, 1, {r // 2}) float16 [{label}] "
            f"{lib_ms[label]:.4f} ms on {card}")
    # the interactive calls on the card (wall, median of REPS_HOST)
    boxes_q = f"canvas.png?selected={idx}&outline=1"
    interactive = {
        "session run_segmentation (48 units)": lambda: sess.run_segmentation(),
        "session run_inspection (48 units)": lambda: sess.run_inspection(),
        "session test_defect_unit (one unit, with diagnostics)":
            lambda: sess.test_defect_unit(u),
        "render erosion_outline_mask (one unit)":
            lambda: render.erosion_outline_mask(seg_sh.masks[u], dp0.erode_px, device="cuda"),
        f"UI POST test_defect (median_k={BIG_K})": lambda: http_json(srv, "test_defect",
                                                                    {"idx": idx}),
        "UI GET canvas.png with the outline": lambda: http_get(srv, boxes_q),
    }
    for label, run in interactive.items():
        e2e[label] = wall_ms(run, REPS_HOST)
        say(f"phase 5: {label} {e2e[label]:.4f} ms (median of {REPS_HOST}, wall) on {card}")
    srv.stop()

    mark("phase 5: the chain and the stream start")
    # kernel K against kernel A's two calls with the zone between them, in
    # turns (K, A, A, K) on the same inputs
    def split_tails():
        m, _ = seg_tail(x, co, fill=True, thr=thr)
        return seg_tail(torch.where(zone, torch.zeros_like(m), m), erode, out_largest=True)

    tails_ms = {"K": [], "A x2 + zone": []}
    for who in ("K", "A x2 + zone", "A x2 + zone", "K"):
        tails_ms[who].append(cuda_ms(
            (lambda: seg_roi_tail(x, co, erode, thr, zone)) if who == "K" else split_tails,
            REPS_KERNEL))
    say(f"phase 5: kernel K {tails_ms['K']} ms vs kernel A's two calls + zone "
        f"{tails_ms['A x2 + zone']} ms (turns K, A, A, K) on {card}")
    # the chained inspect_image against the split one, in turns
    chain_walls = {"split": [], "chained": []}
    img_np = work["image"]
    for mode in ("split", "chained", "chained", "split"):
        engine._ENABLE_CHAIN = mode == "chained"
        chain_walls[mode].append(wall_ms(lambda: engine.inspect_image(
            img_np, grid, seg, dparams, exclusions=excl), REPS_E2E // 2))
    e2e["inspect_image otsu/threshold chained"] = statistics.median(chain_walls["chained"])
    say(f"phase 5: inspect_image otsu/threshold split {chain_walls['split']} vs chained "
        f"{chain_walls['chained']} ms/image (medians of {REPS_E2E // 2}, turns S, C, C, S, "
        f"wall) on {card}")
    engine._ENABLE_CHAIN = True
    profile_combo("chained otsu/threshold", lambda: engine.inspect_image(
        img_np, grid, seg, dparams, exclusions=excl), card)
    engine._ENABLE_CHAIN = False

    # the stream: wall and device ms per frame, beside the modeled bound
    # (a frame's bytes over the measured pinned H2D rate, plus its device time)
    pinned = torch.from_numpy(frames[0].copy()).pin_memory()
    h2d_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), REPS_KERNEL)
    h2d_rate = frames[0].nbytes / (h2d_ms * 1e-3)
    say(f"phase 5: pinned H2D of one 4096x3000 frame {h2d_ms:.4f} ms "
        f"({h2d_rate / 1e9:.2f} GB/s) on {card}")
    timed_frames = frames * STREAM_REPEATS
    n_t = len(timed_frames)
    for label, anchored, prefetch in (("anchored", True, 1), ("anchored", True, 2),
                                      ("chained, no anchors", False, 2)):
        engine._ENABLE_CHAIN = not anchored

        def run(anchored=anchored, prefetch=prefetch):
            return [r.ng_count for r in stream_inspect(
                timed_frames, grid, seg, dparams, exclusions=excl,
                ref_centroids=anchors if anchored else None, prefetch=prefetch)]

        wall = wall_ms(run, REPS_HOST) / n_t
        prof = profile_combo(f"stream {label}, prefetch {prefetch}", run, card, per=n_t,
                             unit="frame", reps=PROFILE_REPS_STREAM)
        engine._ENABLE_CHAIN = False
        device = prof.busy_ms / n_t
        bound = frames[0].nbytes / h2d_rate * 1e3 + device
        key = f"{label}, prefetch {prefetch}"
        e2e[f"stream_4096x3000_wall_ms_per_frame {key}"] = wall
        e2e[f"stream_4096x3000_device_ms_per_frame {key}"] = device
        say(f"phase 5: stream {key}: wall {wall:.4f} ms/frame (median of {REPS_HOST} runs of "
            f"{n_t} frames), device {device:.4f} ms/frame, modeled bound {bound:.4f} ms/frame "
            f"(H2D {frames[0].nbytes / h2d_rate * 1e3:.4f} + device) on {card}")
    if native.get_lib() is not None:
        dec = []
        for p in paths:
            t0 = time.perf_counter()
            img = native.decode(p)
            dec.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(img, frames[len(dec) - 1]):
                fail(f"native decode of {p} differs from the frame written")
        e2e["native_decode_ms_per_frame"] = statistics.median(dec)
        say(f"phase 5: native PNG decode {statistics.median(dec):.4f} ms/frame "
            f"(median of {len(dec)}, host wall)")
    else:
        say("phase 5: native decode not measured: this host has no libpng/libtiff to build "
            f"the port's loader against (files decoded by {decoder})")
    say(f"phase 5: median probe (kernel L) ms per launch by mode and strip: "
        f"{json.dumps({f'{m} S{sp}': v for (m, sp), v in probe_table.items()})}; each "
        f"ablation's share of the baseline: "
        f"{json.dumps({f'{m} S{sp}': v for (m, sp), v in median_probe.shares(probe_table).items()})} "
        f"on {card}")
    tmp.cleanup()

    mark("phase 5 ends")

    # ---- phase 6: the benchmark runner ----------------------------------
    runner_lines = runner_phase(work, seg, dparams, card)
    mark("phase 6 ends")
    sources = {
        "seg_tail": ("tpu_inspect_torch/csrc/seg_tail.cu", "tpu_inspect/ops/fused_pallas.py:145"),
        "median_residual": ("tpu_inspect_torch/csrc/median_residual.cu",
                            "tpu_inspect/ops/median_pallas.py:453"),
        "blob_filter": ("tpu_inspect_torch/csrc/blob_filter.cu",
                        "tpu_inspect/ops/blob_pallas.py:403"),
        "propagate": ("tpu_inspect_torch/csrc/flood.cu", "tpu_inspect/ops/flood_pallas.py:144"),
        "label": ("tpu_inspect_torch/csrc/label.cu", "tpu_inspect/ops/cc_pallas.py:501"),
        "cc_stats": ("tpu_inspect_torch/csrc/cc_stats.cu", "tpu_inspect/ops/cc_pallas.py:602"),
        "blob_select": ("tpu_inspect_torch/csrc/blob_select.cu",
                        "tpu_inspect/ops/cc_pallas.py:689"),
        "median_blur": ("tpu_inspect_torch/csrc/median_blur.cu",
                        "tpu_inspect/ops/median_pallas.py:104"),
        "morph": ("tpu_inspect_torch/csrc/morph.cu", "tpu_inspect/ops/morph_pallas.py:138"),
        "label_stats": ("tpu_inspect_torch/csrc/label_stats.cu",
                        "tpu_inspect/ops/cc_pallas.py:421"),
        "seg_roi_tail": ("tpu_inspect_torch/csrc/seg_roi_tail.cu",
                         "tpu_inspect/ops/fused_pallas.py:1002"),
        "median_probe": ("tpu_inspect_torch/csrc/median_probe.cu", "tools/median_probe.py:142"),
        # head kernels: the JAX package computes the histogram and the scan,
        # the blur and the adaptive mean with XLA ops (no pl.pallas_call)
        "otsu": ("tpu_inspect_torch/csrc/otsu.cu",
                 "none (XLA ops, tpu_inspect/ops/threshold.py:50-125)"),
        "gauss_blur": ("tpu_inspect_torch/csrc/gauss_blur.cu",
                       "none (XLA ops, tpu_inspect/ops/gaussian.py:62-93)"),
        "adaptive": ("tpu_inspect_torch/csrc/adaptive_mean.cu",
                     "none (XLA ops, tpu_inspect/ops/gaussian.py:96-125, "
                     "tpu_inspect/ops/threshold.py:148-160)"),
        "canny_head": ("tpu_inspect_torch/csrc/canny_head.cu",
                       "none (XLA ops, tpu_inspect/ops/canny.py:28-47, :87-122)"),
    }
    # further TPU kernels whose function a kernel serves (whole-image
    # counterparts of tiled TPU kernels, and same-function resident ones)
    also_replaces = {
        "median_residual": ["tpu_inspect/ops/median_pallas.py:539"],
        "propagate": ["tpu_inspect/ops/flood_pallas.py:371", "tpu_inspect/ops/flood_pallas.py:326"],
        "cc_stats": ["tpu_inspect/ops/cc_pallas.py:318"],
        "blob_select": ["tpu_inspect/ops/cc_pallas.py:767", "tpu_inspect/ops/blob_pallas.py:132"],
    }
    # the path each kernel was ported for: its launches and times per image
    # (per diagnostic pass of one unit for the labeling)
    home_path = {
        "seg_tail": "otsu/threshold reference", "median_residual": "otsu/threshold reference",
        "blob_filter": "otsu/threshold reference", "propagate": "otsu/canny reference",
        "label": "defect_intermediates/canny", "cc_stats": WHOLE_HOME,
        "blob_select": WHOLE_HOME, "median_blur": BIG_K_HOME, "morph": WHOLE_HOME,
        "label_stats": SESSION_HOME, "seg_roi_tail": CHAIN_HOME, "median_probe": PROBE_HOME,
        "otsu": "otsu/threshold reference", "gauss_blur": "otsu/threshold reference",
        "adaptive": "adaptive/threshold reference", "canny_head": "otsu/canny reference",
    }
    # the whole-image path of each kernel's whole-plane forms
    whole_home = {"adaptive": "whole inspect_image adaptive/threshold",
                  "canny_head": "whole inspect_image otsu/canny"}
    # kernel I's top-level numbers are its 13x13 erode form on the whole
    # plane, the form with a library yardstick (one of its launches there);
    # kernel L's its baseline at kernel B's strip
    home_form = {"morph": "whole erode 13x13", "median_probe": PROBE_FORM}

    def summed(rows, path):
        bound = sum(r["bound_ms"] for r in rows)
        return {"path": path, "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": bound,
                "bound_us": bound * 1e3}

    entries = []
    for name in kernel_fns:
        path_rows, other_rows, whole_rows = times[name]
        home_rows = whole_rows if home_path[name] == WHOLE_HOME else path_rows
        if name in home_form:
            home_rows = [r for r in home_rows if r["form"] == home_form[name]]
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "also_replaces": also_replaces.get(name, []),
            "launches": launches_by_path[home_path[name]][name],
            "launches_by_path": {p: c[name] for p, c in launches_by_path.items()},
            "max_abs_err": errs[name],
            **summed(home_rows, home_path[name]),
            "bound_by": ("operations" if any(r["bound_by"] == "operations" for r in home_rows)
                         else "bytes"),
            "library_ms": lib_ms.get(home_form.get(name)),
            "forms": path_rows + other_rows + whole_rows,
        }
        if name in home_form:
            entry["form"] = home_form[name]
        if name == "morph":
            entry["library_ms_48_units"] = lib_ms["erode 13x13, 48 units"]
        if name == "median_probe":
            entry["sweep_ms"] = {f"{m} S{sp}": v for (m, sp), v in probe_table.items()}
        if whole_rows and home_rows is not whole_rows:
            w_path = whole_home.get(name, WHOLE_HOME)
            entry["whole"] = {**summed(whole_rows, w_path),
                              "launches": launches_by_path[w_path][name]}
        entries.append(entry)
    build.check_bounded("phase 5", bound_flag)
    say(f"phase 5: ms per call by path {json.dumps(e2e)} on {card}")
    say(f"phase 6: the runner's metrics (ms) "
        f"{json.dumps({m: r['value'] for m, r in runner_lines.items()})} on {card}")
    say(card)
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
