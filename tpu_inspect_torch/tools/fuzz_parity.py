"""Seeded differential fuzz of every entry point and kernel route of the port.

Usage::

    python -m tpu_inspect_torch.tools.fuzz_parity --seed S --trials N
        [--device cuda|cpu] [--classes units,image,...] [--start I] [--small]

Every trial is drawn from one ``np.random.RandomState(seed)``, in order, so
trial ``I`` of seed ``S`` is the same on every run (``--start I --trials 1``
runs it alone) and prints as one line. The configuration spans the clamped
ranges of :mod:`tpu_inspect_torch.config`: both methods of each stage,
``gaussian_blur`` and ``morph_kernel`` 0-31 (odd and even: an even morph
kernel runs close and open in four stages), ``adapt_block`` 3-201,
``adapt_C`` -50..50, ``threshold`` 0-255, ``min_area`` 0-100000 (mostly
0-200), ``erode_px`` 0-200 (mostly 0-20) and ``median_k`` any odd 3-101, so
both kernel B (``k*k < 2048``) and kernel H run.

Trial classes (``CLASSES``; trial ``i`` is sharded where ``i % 20 == 5``,
the whole-image route on a real unit above 2^20 px where ``i % 25 == 9``,
else ``ROTATION[i % 6]``):

- ``units``: ``engine.inspect_units`` on 1-140 units whose H and W lie on
  word and layout edges (1, 2, 31-33, 63-65, 255, 315, 316), 1-4
  squares of 380-420 px (kernels A's, C's and K's global scratch), or
  thin units of 1-16 rows and 1000 columns up to the int32 gate of kernels
  A and C (:func:`int32_gate_width`: 11,000-32,700 columns, where A's and
  C's layouts and kernel O's grid are widest); noise,
  two-level blobs, mold surfaces and a 1-px serpentine, an empty and a
  full unit in the same batch;
- ``image``: ``engine.inspect_image`` on a random grid over a
  ``synthetic.make_mold_image`` capture (crops may exceed 316x315 and touch
  the border), 0-3 rect or circle exclusions: the reference capture, then
  a capture shifted by a random (dx, dy) aligned to its centroids;
- ``chained``: the same with ``engine._ENABLE_CHAIN`` set and the otsu
  method (kernel K in place of A's two launches on the reference);
- ``whole``: ``engine.inspect_units`` on the whole-image route, with
  ``engine.WHOLE_MIN_PX`` lowered to 1000 for units of 64-600 px a side,
  or at its own value on one 1024x1040 unit or one thin unit (1-8 rows)
  just past kernel A's or C's int32 sums;
- ``diag``: ``engine.defect_intermediates`` on one unit;
- ``preview``: the session's erosion preview
  (``render.erosion_outline_mask``, kernels I and J) on one unit, and
  ``ops.cc.largest_component_sums`` (kernel J) on the eroded (kernel I)
  seg masks of 1-140 units, so J's cluster size ``min(16, SMs / U)`` spans
  16 down to 1 (or of one thin 2^20 px unit, J's global scratch);
- ``sharded``: ``parallel.segment_image_sharded`` and
  ``defect_image_sharded`` on 1-4 row strips through
  ``parallel.launch.run_spmd`` on gloo ranks (sharing the card, or on the
  CPU with ``--device cpu``), held against the unsharded engine.

Each trial is compared field by field with tolerance 0: (1) the card
against the same entry point on ``device="cpu"`` (any difference is a
fault of the port); (2) ``device="cpu"`` against the oracle copy
(:mod:`tpu_inspect_torch.oracle`, imported where it compares) for the
units, image and diag classes; a segmentation difference on a unit whose
Otsu scan (``ops.threshold.otsu_sigmas_plain``) has its two best
binarizations within 1e-12 relative is an Otsu tie, printed and counted as
``otsu_ties``, never dropped; (3) on the card, the launch counts of each
call (``kernels.reset_launches`` before it) equal its route's, derived
from ``engine.py`` in :func:`route_launches`. A failing trial prints one
line, then runs again on its first differing unit alone. The last line is
the summary: trials, failures, ties, trials per class, each kernel's
launches and the slowest trial. The exit code is 0 only with no failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time
import traceback
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from tpu_inspect_torch import engine, render
from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.device import resolve_device
from tpu_inspect_torch.geometry import grid_boxes
from tpu_inspect_torch.imageio import crops_for_grid
from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.blob import blob_filter_fits, blob_unit_words
from tpu_inspect_torch.ops.cc import LABEL_STATS_MAX_PX, largest_component_sums
from tpu_inspect_torch.ops.common import as_odd
from tpu_inspect_torch.ops.fused import seg_tail_fits, tail_unit_words
from tpu_inspect_torch.ops.gaussian import gaussian_blur_u8
from tpu_inspect_torch.ops.morphology import morph_chain, rect_erode_stages
from tpu_inspect_torch.ops.threshold import histogram_u8, otsu_sigmas_plain
from tpu_inspect_torch.synthetic import make_mold_image, random_blob_mask, serpentine_plane

CLASSES = ("units", "image", "chained", "whole", "diag", "preview", "sharded")
ROTATION = ("units", "image", "chained", "whole", "diag", "preview")
SHARDED_EVERY, SHARDED_AT = 20, 5
WHOLE_BIG_EVERY, WHOLE_BIG_AT = 25, 9
# the kernels a user path launches (kernel L serves the median-probe tool)
USER_KERNELS = ("seg_tail", "median_residual", "blob_filter", "propagate", "label", "cc_stats",
                "blob_select", "median_blur", "morph", "label_stats", "seg_roi_tail", "otsu",
                "gauss_blur", "adaptive", "canny_head")
# trials from which every user-path kernel must have launched on the card
COVER_TRIALS = 20
# chip_smoke.py's fuzz phase: a fixed seed and trial count
SMOKE_SEED, SMOKE_TRIALS = 14, 20
# H and W of the units class: word and layout edges
EDGES = (1, 2, 31, 32, 33, 63, 64, 65, 255, 315, 316)
# units above kernels A's, C's and K's shared-memory layout (the global scratch)
SCRATCH_SIDE = (380, 420)
SCRATCH_MAX_UNITS = 4
# the pixels of one batch: the device="cpu" reference stays within seconds
BATCH_PX = 400_000
WHOLE_SIDE = (64, 600)
WHOLE_LOWERED_PX = 1000
WHOLE_BIG_HW = (1024, 1040)
SERPENTINE_MAX_PX = 70 * 70
# a block's opt-in shared memory on the H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin)
OPTIN_BYTES = 232448
TIE_REL = 1e-12


@dataclass(frozen=True)
class Trial:
    """One trial: its class, shapes, parameters and content seed. ``extra``
    holds the class's own draws (the grid, exclusions and shift of an image
    trial, the strips of a sharded one)."""

    seed: int
    index: int
    cls: str
    u: int
    h: int
    w: int
    seg: SegmentationParams
    dp: DefectParams
    content_seed: int
    extra: tuple = ()

    def line(self) -> str:
        ex = " ".join(f"{k}={v}" for k, v in self.extra)
        return (f"seed={self.seed} trial={self.index} class={self.cls} "
                f"{self.u}x{self.h}x{self.w} {self.seg} {self.dp}" + (f" {ex}" if ex else ""))

    def get(self, key, default=None):
        return dict(self.extra).get(key, default)


# ---------------------------------------------------------------------------
# Trial generator
# ---------------------------------------------------------------------------


def trial_class(i: int) -> str:
    if i % SHARDED_EVERY == SHARDED_AT:
        return "sharded"
    if i % WHOLE_BIG_EVERY == WHOLE_BIG_AT:
        return "whole"
    return ROTATION[i % len(ROTATION)]


def _draw_params(rng) -> tuple[SegmentationParams, DefectParams]:
    seg = SegmentationParams(
        method=str(rng.choice(["otsu", "adaptive"])),
        gaussian_blur=int(rng.randint(0, 32)),
        morph_kernel=int(rng.randint(0, 32)),
        adapt_block=int(rng.randint(3, 202)),
        adapt_C=int(rng.randint(-50, 51)),
    )
    dp = DefectParams(
        method=str(rng.choice(["threshold", "canny"])),
        threshold=int(rng.randint(0, 256)),
        min_area=int(rng.randint(0, 201) if rng.rand() < 0.8 else rng.randint(0, 100001)),
        erode_px=int(rng.randint(0, 21) if rng.rand() < 0.75 else rng.randint(21, 201)),
        median_k=int(2 * rng.randint(1, 51) + 1),
    )
    return seg, dp


def _batch_units(rng, h: int, w: int) -> int:
    """1-140 units, at most ``BATCH_PX`` pixels."""
    return int(min(rng.randint(1, 141), max(1, BATCH_PX // (h * w))))


def _unit_shape(rng, scratch: bool, small: bool) -> tuple[int, int]:
    if small:
        side = (40, 48) if scratch else (1, 33)
        return int(rng.randint(side[0], side[1] + 1)), int(rng.randint(side[0], side[1] + 1))
    if scratch:
        s = int(rng.randint(SCRATCH_SIDE[0], SCRATCH_SIDE[1] + 1))
        return s, s
    return int(rng.choice(EDGES)), int(rng.choice(EDGES))


def _exclusions(rng, h: int, w: int) -> tuple:
    """0-3 rect or circle exclusions in unit coordinates, some past the
    unit's edge."""
    out = []
    for _ in range(int(rng.randint(0, 4))):
        if rng.rand() < 0.5:
            out.append({"shape": "rect", "x": int(rng.randint(-5, w)),
                        "y": int(rng.randint(-5, h)), "w": int(rng.randint(0, w // 2 + 2)),
                        "h": int(rng.randint(0, h // 2 + 2))})
        else:
            out.append({"shape": "circle", "cx": int(rng.randint(0, w)),
                        "cy": int(rng.randint(0, h)), "r": int(rng.randint(0, min(h, w) // 3 + 2))})
    return tuple(out)


def _strip_fits(h: int, n: int, halo: int) -> bool:
    """``parallel.strips._strips``'s condition on the last strip."""
    hs = -(-h // n)
    last = h - (n - 1) * hs
    return last > halo + (hs - last) + 1


def int32_gate_width(h: int) -> int:
    """The least width at which an h-row unit no longer fits kernel A's or
    C's int32 sums (``engine._whole_route``'s second gate)."""
    lo, hi = 1, 1 << 31
    while lo < hi:
        mid = (lo + hi) // 2
        if seg_tail_fits(h, mid) and blob_filter_fits(h, mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def draw_trial(rng, seed: int, i: int, small: bool = False) -> Trial:
    """Trial ``i``: its class from ``i``, everything else from ``rng``.
    The size category cycles with the class's own count: one trial in
    three of a units, image, chained or diag trial has units above kernels
    A's, C's and K's shared memory (the global scratch); in another one in
    three, half the units and preview trials take thin units (1-16 rows,
    1000 columns up to the int32 gate; one 2^20 px unit for kernel J's
    global scratch), and
    every whole trial a thin unit just past kernel A's or C's int32 sums,
    which takes the whole-image route at the real ``WHOLE_MIN_PX``."""
    cls = trial_class(i)
    seg, dp = _draw_params(rng)
    content = int(rng.randint(2**31 - 1))
    scratch = (i // len(ROTATION)) % 3 == 1
    thin = (i // len(ROTATION)) % 3 == 2 and not small
    extra = []
    if cls == "chained":
        seg = dataclasses.replace(seg, method="otsu")
    if cls in ("units", "diag", "preview"):
        h, w = _unit_shape(rng, scratch and cls != "preview", small)
        cap = SCRATCH_MAX_UNITS if h * w > 316 * 315 else 140
        u = 1 if cls == "diag" else min(_batch_units(rng, h, w), cap, 6 if small else 140)
        if thin and cls == "units" and rng.rand() < 0.5:
            h = int(rng.choice([1, 2, 3, 8, 16]))
            w = int(rng.randint(1000, int32_gate_width(h)))
            u = _batch_units(rng, h, w)
        elif thin and cls == "preview" and rng.rand() < 0.5:
            h = int(rng.choice([1, 2, 4, 8]))
            w, u = LABEL_STATS_MAX_PX // h, 1
    elif cls in ("image", "chained"):
        h, w = _unit_shape(rng, scratch, small)
        if min(h, w) < 16:  # a mold surface needs a few pixels
            h, w = max(h, 16), max(w, 16)
        nx, ny = int(rng.randint(1, 5)), int(rng.randint(1, 4))
        bx, by = int(rng.randint(1, 3)), int(rng.randint(1, 3))
        # two captures a trial: half a batch's pixels each, at most two
        # units above 316x315
        cap = 2 if h * w > 316 * 315 else max(1, BATCH_PX // (2 * h * w))
        while nx * ny * bx * by > cap:
            if bx * by > 1:
                bx, by = 1, 1
            else:
                nx, ny = max(1, nx - 1), max(1, ny - 1)
        sux, suy = int(rng.randint(0, 41)), int(rng.randint(0, 41))
        sbx, sby = int(rng.randint(0, 61)), int(rng.randint(0, 61))
        margin = int(rng.choice([0, 0, 5, 20]))
        span_w = bx * (nx * w + (nx - 1) * sux) + (bx - 1) * sbx
        span_h = by * (ny * h + (ny - 1) * suy) + (by - 1) * sby
        # a negative slack makes the last units leave the image (clamped crops)
        slack = int(rng.choice([0, 0, 0, -3]))
        grid = GridParams(base_unit=(margin, margin, w, h), units_x=nx, units_y=ny,
                          blocks_x=bx, blocks_y=by, unit_space_x=sux, unit_space_y=suy,
                          block_space_x=sbx, block_space_y=sby)
        img_hw = (max(h, span_h + 2 * margin + slack), max(w, span_w + 2 * margin + slack))
        shift = (int(rng.randint(-8, 9)), int(rng.randint(-8, 9)))
        u = grid.num_units
        extra = [("grid", grid), ("image_hw", img_hw), ("exclusions", _exclusions(rng, h, w)),
                 ("shift", shift)]
    elif cls == "whole":
        # real_gate: the unit takes the route by engine.WHOLE_MIN_PX's own
        # value (1024x1040) or by the int32 gate (a thin unit)
        real_gate = i % WHOLE_BIG_EVERY == WHOLE_BIG_AT
        if real_gate:
            h, w = (128, 130) if small else WHOLE_BIG_HW
            u = 1
        elif thin:
            h = int(rng.choice([1, 2, 3, 4, 8]))
            w, u = int32_gate_width(h) + int(rng.randint(0, 257)), 1
            real_gate = True
        else:
            lo, hi = (40, 96) if small else WHOLE_SIDE
            h, w = int(rng.randint(lo, hi + 1)), int(rng.randint(lo, hi + 1))
            u = 2 if h * w <= 200_000 and rng.rand() < 0.3 else 1
        extra = [("real_gate", real_gate and not small)]
    else:  # sharded
        n = int(rng.randint(1, 5))
        halo = max(int(dp.erode_px), int(dp.median_k) // 2 if dp.method == "threshold" else 0,
                   as_odd(seg.gaussian_blur) // 2 if seg.gaussian_blur else 0,
                   max(3, seg.adapt_block | 1) // 2 if seg.method == "adaptive" else 0,
                   seg.morph_kernel // 2)
        h = int(rng.randint(64, 301)) if small else int(rng.randint(300, 1101))
        while not _strip_fits(h, n, halo):
            h += 16
        w = int(rng.randint(40, 97)) if small else int(rng.randint(200, 701))
        u = 1
        extra = [("strips", n)]
    return Trial(seed, i, cls, u, h, w, seg, dp, content, tuple(extra))


def trials(seed: int, n: int, classes=CLASSES, start: int = 0, small: bool = False):
    """The first ``n`` trials of ``seed`` at index ``start`` on whose class
    is in ``classes`` (every trial before them drawn too, so an index is
    the same trial whatever the filter)."""
    rng = np.random.RandomState(seed)
    i, out = 0, []
    while len(out) < n:
        t = draw_trial(rng, seed, i, small)
        if i >= start and t.cls in classes:
            out.append(t)
        i += 1
    return out


def _unit_plane(rng, kind: str, h: int, w: int) -> np.ndarray:
    if kind == "noise":
        return rng.randint(0, 256, (h, w)).astype(np.uint8)
    if kind == "empty":
        return np.full((h, w), 255, np.uint8)
    if kind == "full":
        return np.zeros((h, w), np.uint8)
    if kind == "serpentine":
        lo, hi = int(rng.randint(0, 100)), int(rng.randint(150, 256))
        return np.where(serpentine_plane(h, w) > 0, lo, hi).astype(np.uint8)
    if kind == "mold":
        g = GridParams(base_unit=(0, 0, w, h))
        return make_mold_image(g, (h, w), seed=int(rng.randint(2**31 - 1)),
                               defect_rate=0.5, noise=int(rng.randint(0, 12)))
    m = random_blob_mask(h, w, seed=int(rng.randint(2**31 - 1)), n_blobs=int(rng.randint(1, 6)),
                         scale=float(rng.uniform(0.1, 0.5)))
    lo, hi = sorted(int(v) for v in rng.randint(0, 256, 2))
    noise = rng.randint(-int(rng.randint(0, 8)), int(rng.randint(0, 8)) + 1, (h, w))
    return np.clip(np.where(m > 0, lo, hi) + noise, 0, 255).astype(np.uint8)


def unit_crops(t: Trial) -> np.ndarray:
    """The trial's [U, H, W] uint8 content, from its content seed: each unit
    noise, blobs, a mold surface or (up to 70x70) a 1-px serpentine; half
    the batches of two or more hold an empty and a full unit."""
    rng = np.random.RandomState(t.content_seed)
    kinds = ["noise", "blobs"]
    if min(t.h, t.w) >= 16:
        kinds.append("mold")
    if t.h * t.w <= SERPENTINE_MAX_PX and min(t.h, t.w) >= 4:
        kinds.append("serpentine")
    picks = [str(rng.choice(kinds)) for _ in range(t.u)]
    if t.u >= 2 and rng.rand() < 0.5:
        a, b = rng.choice(t.u, 2, replace=False)
        picks[a], picks[b] = "empty", "full"
    crops = np.stack([_unit_plane(rng, k, t.h, t.w) for k in picks])
    k = t.get("unit_of")
    return crops if k is None else crops[k : k + 1]


def capture(t: Trial, shifted: bool) -> np.ndarray:
    """The image trial's reference (or shifted) capture of its drawn grid."""
    return make_mold_image(t.get("grid"), t.get("image_hw"), seed=t.content_seed + int(shifted),
                           defect_rate=0.5, shift=t.get("shift") if shifted else (0, 0))


def capture_like(t: Trial) -> np.ndarray:
    """A mold capture of the sharded trial's size: a 2x2 grid of units
    filling most of it."""
    uh, uw = max(8, t.h // 2 - 10), max(8, t.w // 2 - 10)
    grid = GridParams(base_unit=(5, 5, uw, uh), units_x=2, units_y=2, unit_space_x=5,
                      unit_space_y=5)
    return make_mold_image(grid, (t.h, t.w), seed=t.content_seed, defect_rate=0.5)


def run_grid(t: Trial) -> GridParams:
    """The grid an image trial runs: the drawn one, or its unit ``unit_of``
    alone as a one-unit grid."""
    grid, k = t.get("grid"), t.get("unit_of")
    if k is None:
        return grid
    return GridParams(base_unit=grid_boxes(grid)[k])


def one_unit(t: Trial, unit: int) -> Trial | None:
    """The trial cut to its unit ``unit`` alone (a batch's crop, or a grid's
    box as a one-unit grid on the same captures); None for a trial of one
    unit."""
    if t.u == 1 or t.get("unit_of") is not None:
        return None
    return dataclasses.replace(t, extra=t.extra + (("unit_of", int(unit)),))


def gate_sides(t: Trial) -> set[str]:
    """The sides of the route gates a trial reaches: kernel A's, C's and
    K's shared memory or global scratch (their launchers' test against the
    H100's opt-in shared memory), kernel B or H (``k*k < 2048``), the unit
    or whole-image route, an odd or even ``morph_kernel`` above 1, and
    ``erode_px`` above 100."""
    out = set()
    mk = t.seg.morph_kernel
    if mk > 1:
        out.add(f"morph {'even' if mk % 2 == 0 else 'odd'}")
    if t.dp.erode_px > 100:
        out.add("erode > 100")
    if t.dp.method == "threshold":
        k = engine._median_k(t.dp)
        out.add("H" if k * k >= 2048 else "B")
    if t.cls in ("whole", "sharded"):
        out.add("whole route")
        if t.cls == "whole" and not (seg_tail_fits(t.h, t.w) and blob_filter_fits(t.h, t.w)):
            out.add("whole route by the int32 gate")
        return out
    if t.cls == "preview":
        return out
    out.add("unit route")
    a = "scratch" if 4 * tail_unit_words(t.h, t.w) + 256 > OPTIN_BYTES else "shared"
    c = "scratch" if 4 * blob_unit_words(t.h, t.w) + 1280 > OPTIN_BYTES else "shared"
    out |= {f"A {a}", f"C {c}"}
    if t.cls == "chained":
        out.add(f"K {a}")
    return out


# ---------------------------------------------------------------------------
# Launch counts of each route (engine.py)
# ---------------------------------------------------------------------------


def _cand(dp: DefectParams) -> Counter:
    """``engine._candidates``: Canny's head (O) and hysteresis (D), kernel
    H's full median where k*k >= 2048, else kernel B."""
    if dp.method == "canny":
        return Counter(canny_head=1, propagate=1)
    k = engine._median_k(dp)
    return Counter(median_blur=1) if k * k >= 2048 else Counter(median_residual=1)


def head_launches(seg: SegmentationParams) -> Counter:
    """The head of every segmentation route (``engine._seg_mask``,
    ``_segment_roi``, ``parallel.strips.segment_image_sharded``): M (the
    blur) where ``as_odd(gaussian_blur) > 1`` (k = 1 returns the plane),
    then Otsu (histogram, scan) for otsu or N (the adaptive compare) for
    adaptive."""
    seg = seg.validated()
    head = Counter(otsu=2) if seg.method == "otsu" else Counter(adaptive=1)
    if as_odd(seg.gaussian_blur) > 1:
        head["gauss_blur"] = 1
    return head


def route_launches(route: str, seg: SegmentationParams, dp: DefectParams,
                   roi_empty: bool = False, found: bool = True) -> Counter:
    """The launches of one call, by route (``engine.py``):

    - ``split seg``: the head (:func:`head_launches`: M, then Otsu or N);
      A (seg tail);
    - ``split defect``: A (ROI tail), B | H | O and D (candidates), C;
    - ``chained`` (otsu only): the head, K (seg tail + zone + ROI tail),
      B | H | O and D, C;
    - ``whole seg``: the head; I (head + close/open), D (border flood), E,
      F;
    - ``whole defect``: I (ROI erode), E, F; B | H | O and D; I (ROI AND +
      open), D (exterior), E (fill labels), D (top-level blobs), G;
    - ``diag``: A (ROI tail); unless the ROI is empty, B | H | O and D, I
      (ROI AND + open), D (exterior) and E twice (``analyze_blobs``);
    - ``outline``: I (erode), J, and I again (the 1-px inner erode) where
      the preview is not empty (``found``);
    - ``largest``: I (erode), J.
    """
    head = head_launches(seg)
    if route == "split seg":
        return head + Counter(seg_tail=1)
    if route == "split defect":
        return Counter(seg_tail=1, blob_filter=1) + _cand(dp)
    if route == "chained":
        return head + Counter(seg_roi_tail=1, blob_filter=1) + _cand(dp)
    if route == "whole seg":
        return head + Counter(morph=1, propagate=1, label=1, cc_stats=1)
    if route == "whole defect":
        return Counter(morph=2, label=2, cc_stats=1, propagate=2, blob_select=1) + _cand(dp)
    if route == "diag":
        tail = Counter() if roi_empty else Counter(morph=1, propagate=1, label=2) + _cand(dp)
        return Counter(seg_tail=1) + tail
    if route == "outline":
        return Counter(morph=2 if found else 1, label_stats=1)
    if route == "largest":
        return Counter(morph=1, label_stats=1)
    raise ValueError(route)


# kernels each rank of a sharded call must launch at least once (the strip
# floods and exchanges vary in count); the segment pass also the head's
# (head_launches)
SHARDED_KERNELS = {
    "segment": ("morph", "propagate"),
    "defect threshold": ("label", "cc_stats", "propagate", "blob_select", "morph"),
    "defect canny": ("label", "cc_stats", "propagate", "blob_select", "morph", "canny_head"),
}


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def first_diff(a: dict, b: dict):
    """The first field of ``a`` that differs in ``b`` (dtype, shape or
    value): (field, unit, pixel, a's value, b's value), else None. Arrays
    carry the unit on their first axis."""
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b.get(key))
        if x.dtype != y.dtype or x.shape != y.shape:
            return key, None, None, f"{x.dtype}{x.shape}", f"{y.dtype}{y.shape}"
        if not np.array_equal(x, y):
            idx = tuple(int(v) for v in np.argwhere(x != y)[0])
            return key, (idx[0] if idx else 0), idx[1:], x[idx].item(), y[idx].item()
    return None


def _seg_fields(s) -> dict:
    valid = np.asarray(s.centroid_valid, dtype=bool)
    return {"masks": s.masks, "centroid_valid": valid,
            "centroids": np.where(valid[:, None], s.centroids, 0.0), "shifts": s.shifts}


def _insp_fields(i) -> dict:
    return {"defect_masks": i.defect_masks, "valid": i.valid,
            "areas": np.asarray(i.areas, np.int64), "verdicts": i.verdicts}


def _oracle_seg(crops, seg, exclusions=(), ref_centroids=None, is_reference=True) -> dict:
    from tpu_inspect_torch import oracle

    masks, cents, shifts = oracle.segment_all_units(crops, seg.validated(), exclusions,
                                                    ref_centroids, is_reference)
    out = {"masks": masks, "shifts": shifts.astype(np.int32)}
    if is_reference:  # the oracle records centroids on the reference capture only
        u = crops.shape[0]
        out["centroid_valid"] = np.array([i in cents for i in range(u)], dtype=bool)
        out["centroids"] = np.array([cents.get(i, (0.0, 0.0)) for i in range(u)],
                                    np.float64).reshape(u, 2)
    return out


def _oracle_insp(crops, seg_masks, dp) -> dict:
    from tpu_inspect_torch import oracle

    dms, areas, verdicts = oracle.inspect_units(crops, seg_masks, dp.validated())
    return {"defect_masks": np.stack([np.zeros(crops.shape[1:], np.uint8) if m is None else m
                                      for m in dms]),
            "valid": np.array([m is not None for m in dms], dtype=bool),
            "areas": areas.astype(np.int64), "verdicts": np.asarray(verdicts, dtype=bool)}


def otsu_tie_units(crops: np.ndarray, seg: SegmentationParams) -> np.ndarray:
    """[U] bool: units whose Otsu scan (the port's own,
    ``ops.threshold.otsu_sigmas_plain`` on the blurred crop) has its two
    best binarizations' float64 between-class variances within
    ``TIE_REL`` relative. Thresholds with no pixel between them give the
    same binarization, so each counts once, at its best variance."""
    seg = seg.validated()
    x = torch.from_numpy(np.ascontiguousarray(crops))
    if seg.method != "otsu":
        return np.zeros(x.shape[0], dtype=bool)
    if seg.gaussian_blur and seg.gaussian_blur > 0:
        x = gaussian_blur_u8(x, as_odd(seg.gaussian_blur))
    hist = histogram_u8(x)
    sigma = otsu_sigmas_plain(hist, x.shape[1] * x.shape[2]).numpy()
    below = np.cumsum(hist.numpy(), axis=1)  # pixels <= t: one binarization each
    out = np.zeros(x.shape[0], dtype=bool)
    for u in range(x.shape[0]):
        best: dict[int, float] = {}
        for t in np.flatnonzero(np.isfinite(sigma[u])):
            best[int(below[u, t])] = max(best.get(int(below[u, t]), -np.inf), sigma[u, t])
        top = sorted(best.values(), reverse=True)
        out[u] = len(top) >= 2 and top[0] - top[1] <= TIE_REL * abs(top[0])
    return out


class TrialFailure(Exception):
    """A trial's comparison failed: which one, in which call, and the first
    differing field, unit and pixel."""

    def __init__(self, which: str, call: str, diff):
        field, unit, pixel, got, want = diff
        super().__init__(f"{which} in {call}: field {field} unit {unit} pixel {pixel}: "
                         f"{got!r} vs {want!r}")
        self.unit = unit


@dataclass
class Outcome:
    """What a passing trial leaves: its Otsu ties and its card launches."""

    ties: list = dataclasses.field(default_factory=list)
    launches: Counter = dataclasses.field(default_factory=Counter)


class _Runner:
    """Runs one trial's calls on the device under test and on the CPU,
    with the comparisons and launch checks of the module docstring."""

    def __init__(self, t: Trial, dev: torch.device):
        self.t, self.dev = t, dev
        self.on_card = dev.type == "cuda"
        self.out = Outcome()

    def call(self, name: str, fn, fields, expect):
        """``fn(device)`` on the device under test, its launches checked
        against ``expect(cpu fields)``, then on the CPU: comparison (1) and
        (3). Returns the CPU result's ``fields``."""
        cpu = torch.device("cpu")
        if not self.on_card:
            return fields(fn(cpu))
        reset_launches()
        got = fields(fn(self.dev))
        launched = Counter({k: v for k, v in LAUNCHES.items() if v})
        self.out.launches.update(launched)
        want = fields(fn(cpu))
        diff = first_diff(got, want)
        if diff is not None:
            raise TrialFailure("card vs cpu", name, diff)
        route = expect(want)
        if launched != route:
            raise TrialFailure("launches", name,
                               ("launches", None, None, dict(launched), dict(route)))
        return want

    def vs_oracle(self, name: str, got: dict, want: dict, crops=None, seg_keys=()):
        """Comparison (2). A difference in ``seg_keys`` only on units that
        are all Otsu ties of ``crops`` is recorded as ties, and the other
        fields are still compared. Only ``want``'s fields are compared."""
        got = {k: got[k] for k in want}
        diff = first_diff(got, want)
        if diff is None:
            return
        if crops is not None and diff[0] in seg_keys:
            bad = set()
            for k in set(seg_keys) & set(want):
                x, y = np.asarray(got[k]), np.asarray(want[k])
                if x.shape == y.shape:
                    bad |= {int(v) for v in np.argwhere(x != y)[:, 0]}
            ties = otsu_tie_units(crops, self.t.seg)
            if bad and all(ties[u] for u in bad):
                self.out.ties.append(
                    f"otsu tie: {self.t.line()} {name} units {sorted(bad)} (first: field "
                    f"{diff[0]} unit {diff[1]} pixel {diff[2]}: {diff[3]!r} vs {diff[4]!r})")
                rest = [k for k in got if k not in seg_keys]
                diff = first_diff({k: got[k] for k in rest}, {k: want[k] for k in rest})
                if diff is None:
                    return
        raise TrialFailure("cpu vs oracle", name, diff)


def _both(res) -> dict:
    return {**_seg_fields(res[0]), **_insp_fields(res[1])}


_SEG_KEYS = ("masks", "centroid_valid", "centroids", "shifts")


def _inspect_units(r: _Runner, crops: np.ndarray) -> dict:
    t = r.t
    whole = engine._whole_route(t.h, t.w)
    routes = ("whole seg", "whole defect") if whole else ("split seg", "split defect")
    return r.call(
        "inspect_units", lambda dev: engine.inspect_units(crops, t.seg, t.dp, device=dev), _both,
        lambda _: route_launches(routes[0], t.seg, t.dp) + route_launches(routes[1], t.seg, t.dp))


def run_units(r: _Runner, crops=None):
    crops = unit_crops(r.t) if crops is None else crops
    cpu = _inspect_units(r, crops)
    want = {**_oracle_seg(crops, r.t.seg), **_oracle_insp(crops, cpu["masks"], r.t.dp)}
    r.vs_oracle("inspect_units", cpu, want, crops, _SEG_KEYS)


def run_image(r: _Runner, chained: bool = False):
    """The reference capture, then the shifted one aligned to the CPU
    run's anchors; the oracle takes the same crops (the port's gather)."""
    t = r.t
    grid, excl = run_grid(t), t.get("exclusions")
    anchors = None
    for shifted in (False, True):
        img = capture(t, shifted)
        name = f"inspect_image {'shifted' if shifted else 'reference'}"
        route = (("chained",) if chained and not shifted else ("split seg", "split defect"))

        def run(dev, img=img, shifted=shifted):
            return engine.inspect_image(img, grid, t.seg, t.dp, excl, ref_centroids=anchors,
                                        is_reference=not shifted, device=dev)

        cpu = r.call(name, run, _both,
                     lambda _, route=route: sum((route_launches(k, t.seg, t.dp) for k in route),
                                                Counter()))
        if not chained:
            crops = crops_for_grid(img, grid, device="cpu").numpy()
            want = {**_oracle_seg(crops, t.seg, excl, anchors, not shifted),
                    **_oracle_insp(crops, cpu["masks"], t.dp)}
            r.vs_oracle(name, cpu, want, crops, _SEG_KEYS)
        if not shifted:
            valid, cents = cpu["centroid_valid"], cpu["centroids"]
            anchors = {i: (float(cents[i, 0]), float(cents[i, 1]))
                       for i in range(len(valid)) if valid[i]}


def run_chained(r: _Runner):
    saved = engine._ENABLE_CHAIN
    engine._ENABLE_CHAIN = True
    try:
        run_image(r, chained=True)
    finally:
        engine._ENABLE_CHAIN = saved


def run_whole(r: _Runner):
    saved = engine.WHOLE_MIN_PX
    if not r.t.get("real_gate"):
        engine.WHOLE_MIN_PX = WHOLE_LOWERED_PX
    try:
        if not engine._whole_route(r.t.h, r.t.w):
            raise AssertionError(f"{r.t.line()}: not on the whole-image route")
        _inspect_units(r, unit_crops(r.t))
    finally:
        engine.WHOLE_MIN_PX = saved


def run_diag(r: _Runner):
    """``defect_intermediates`` on the unit and its CPU seg mask; the
    oracle's ``detect_defects`` stats (roi_empty, roi_area, max_area)."""
    from tpu_inspect_torch import oracle

    t = r.t
    crop = unit_crops(t)[0]
    seg_mask = engine.segment_units(crop[None], t.seg, device="cpu").masks[0]
    cpu = r.call(
        "defect_intermediates",
        lambda dev: engine.defect_intermediates(crop, seg_mask, t.dp, device=dev),
        lambda d: {k: np.asarray(v) for k, v in sorted(d.items())},
        lambda d: route_launches("diag", t.seg, t.dp, roi_empty=bool(d["roi_empty"])))
    st: dict = {}
    oracle.detect_defects(crop, seg_mask, t.dp.validated(), st)
    want = {"roi_empty": np.asarray(bool(st.get("roi_empty", False)))}
    if not want["roi_empty"]:
        want.update(roi_area=np.asarray(st["roi_area"]), max_area=np.asarray(st["max_area"]))
    r.vs_oracle("defect_intermediates", {k: cpu[k] for k in want}, want)


def run_preview(r: _Runner):
    """The erosion preview of the first unit, then kernel J on all the
    units' eroded CPU seg masks."""
    t = r.t
    masks = engine.segment_units(unit_crops(t), t.seg, device="cpu").masks
    erode = int(t.dp.validated().erode_px)
    r.call("erosion_outline_mask",
           lambda dev: render.erosion_outline_mask(masks[0], erode, device=dev),
           lambda o: {"outline": np.zeros((0, 0), bool) if o is None else o},
           lambda o: route_launches("outline", t.seg, t.dp, found=o["outline"].size > 0))

    def largest(dev):
        m = morph_chain(torch.from_numpy(masks > 0).to(dev), rect_erode_stages(erode))
        return (m,) + tuple(largest_component_sums(m))

    r.call("largest_component_sums", largest,
           lambda res: {k: v.cpu().numpy() for k, v in zip(("eroded", "largest", "stats"), res)},
           lambda _: route_launches("largest", t.seg, t.dp))


def _sharded_rank(image, seg, dp):
    """One rank of the sharded class: the two strip entry points on the
    default process group, each with this rank's launch counts."""
    from tpu_inspect_torch.parallel import defect_image_sharded, segment_image_sharded

    reset_launches()
    mask = segment_image_sharded(image, seg)
    seg_launches = dict(LAUNCHES)
    reset_launches()
    defect = defect_image_sharded(image, mask, dp)
    return mask, defect, seg_launches, dict(LAUNCHES)


def run_sharded(r: _Runner):
    """The strips on gloo ranks (sharing the card, or on the CPU) against
    the unsharded engine on the CPU, on every rank."""
    from tpu_inspect_torch.parallel.launch import run_spmd

    t = r.t
    image = capture_like(t) if t.content_seed % 2 else unit_crops(t)[0]
    n = int(t.get("strips"))
    ranks = run_spmd(functools.partial(_sharded_rank, image, t.seg, t.dp), n, "gloo",
                     device=None if r.on_card else "cpu")
    seg_cpu = engine.segment_units(image[None], t.seg, device="cpu").masks[0]
    ins = engine.detect_defects_batch(image[None], seg_cpu[None], t.dp, device="cpu")
    want = {"mask": seg_cpu[None], "defect_mask": ins.defect_masks[:1], "found": ins.valid[:1],
            "area": ins.areas[:1].astype(np.int64), "verdict": ins.verdicts[:1]}
    seg_need = SHARDED_KERNELS["segment"] + tuple(head_launches(t.seg))
    def_need = SHARDED_KERNELS[f"defect {t.dp.method}"] + tuple(_cand(t.dp))
    for rank, (mask, (dm, found, area, verdict), l_seg, l_def) in enumerate(ranks):
        got = {"mask": mask[None], "defect_mask": dm[None], "found": np.array([found]),
               "area": np.array([area], np.int64), "verdict": np.array([verdict])}
        diff = first_diff(got, want)
        if diff is not None:
            raise TrialFailure("card vs cpu" if r.on_card else "strips vs engine",
                               f"sharded rank {rank} of {n}", diff)
        if r.on_card:
            r.out.launches.update(Counter(l_seg) + Counter(l_def))
            missed = [k for k in seg_need if not l_seg[k]] + [k for k in def_need if not l_def[k]]
            if missed:
                raise TrialFailure("launches", f"sharded rank {rank} of {n}",
                                   ("launches", None, None, missed, "each above 0"))


RUNNERS = {"units": run_units, "image": run_image, "chained": run_chained,
           "whole": run_whole, "diag": run_diag, "preview": run_preview,
           "sharded": run_sharded}


def run_trial(t: Trial, dev: torch.device) -> Outcome:
    """Run one trial on ``dev``; raises :class:`TrialFailure`, or the error
    a call raised, where it fails."""
    r = _Runner(t, dev)
    RUNNERS[t.cls](r)
    return r.out


def check_units(t: Trial, crops: np.ndarray, device="cpu") -> Outcome:
    """The units class on given [U, H, W] uint8 ``crops`` (``t``'s shape
    and parameters): a pinned case runs through the same comparisons."""
    r = _Runner(t, resolve_device(device))
    run_units(r, crops)
    return r.out


def _fatal(e: BaseException) -> bool:
    """A CUDA error that leaves the context unusable: no trial after it
    could run."""
    msg = str(e)
    return "CUDA error" in msg or "illegal memory access" in msg or "unspecified launch" in msg


def run(seed: int, n: int, device="cuda", classes=CLASSES, start: int = 0,
        small: bool = False, say=print) -> dict:
    """Run ``n`` trials of ``seed``; print a line per trial, one per
    failure (and its rerun on the first differing unit alone) and per Otsu
    tie, then the summary line. Returns the summary."""
    dev = resolve_device(device)
    per_class, launches, fails, ties = Counter(), Counter(), [], []
    slowest = (0.0, "")
    t_all = time.perf_counter()
    for t in trials(seed, n, tuple(classes), start, small):
        t0 = time.perf_counter()
        status = "ok"
        try:
            out = run_trial(t, dev)
        except Exception as e:  # noqa: BLE001 - every failure is reported, then counted
            status = f"FAIL {type(e).__name__}: {e}"
            fails.append(f"{t.line()} | {status}")
            say(f"fuzz_parity: FAIL {t.line()} | {type(e).__name__}: {e}")
            if not isinstance(e, TrialFailure):
                traceback.print_exc(file=sys.stderr)
            if _fatal(e):
                say("fuzz_parity: the CUDA context is lost; no further trial runs")
                break
            cut = one_unit(t, e.unit) if isinstance(e, TrialFailure) and e.unit is not None \
                else None
            if cut is not None:
                try:
                    run_trial(cut, dev)
                    say(f"fuzz_parity:   alone: unit {e.unit} passes on its own")
                except Exception as e1:  # noqa: BLE001 - the rerun's verdict is printed
                    say(f"fuzz_parity:   alone: unit {e.unit} ({cut.line()}) still fails: "
                        f"{type(e1).__name__}: {e1}")
        else:
            ties += out.ties
            launches.update(out.launches)
            for line in out.ties:
                say(f"fuzz_parity: {line}")
        dt = time.perf_counter() - t0
        per_class[t.cls] += 1
        if dt > slowest[0]:
            slowest = (dt, t.line())
        say(f"fuzz_parity: trial {t.index} {t.cls} {t.u}x{t.h}x{t.w} {dt:.2f} s {status[:4]}")
    summary = {
        "seed": seed, "trials": sum(per_class.values()), "failures": len(fails),
        "otsu_ties": len(ties), "per_class": dict(per_class),
        "launches": {k: launches[k] for k in USER_KERNELS} if dev.type == "cuda" else None,
        "slowest": {"seconds": round(slowest[0], 3), "trial": slowest[1]},
        "seconds": round(time.perf_counter() - t_all, 3), "device": str(dev),
    }
    if (dev.type == "cuda" and not fails and set(classes) == set(CLASSES)
            and summary["trials"] >= COVER_TRIALS):
        missing = [k for k in USER_KERNELS if not launches[k]]
        if missing:
            fails.append(f"kernels never launched: {missing}")
            summary["failures"] = len(fails)
            say(f"fuzz_parity: FAIL kernels never launched in {summary['trials']} trials: "
                f"{missing}")
    say("fuzz_parity summary " + json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_inspect_torch.tools.fuzz_parity")
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--trials", type=int, default=COVER_TRIALS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--classes", default=",".join(CLASSES),
                    help=f"comma-separated subset of {','.join(CLASSES)}")
    ap.add_argument("--start", type=int, default=0, help="first trial index")
    ap.add_argument("--small", action="store_true",
                    help="small shapes (the CPU test's drive)")
    a = ap.parse_args(argv)
    classes = tuple(a.classes.split(","))
    unknown = set(classes) - set(CLASSES)
    if unknown:
        ap.error(f"unknown classes {sorted(unknown)}")
    summary = run(a.seed, a.trials, a.device, classes, a.start, a.small)
    return 0 if summary["failures"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
