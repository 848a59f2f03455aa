"""Morphology: OpenCV structuring elements, stage tuples, the plain stage
chain (OpenCV clip-to-image borders), batched over [U, H, W]; kernel I.

The SE tables are numpy copies of :func:`tpu_inspect.ops.morphology.ellipse_se`
/ ``_se_runs`` and :mod:`tpu_inspect.ops.morph_pallas`'s ``minkowski_sum`` /
``_close_open_stages`` / ``_open_stages``. A *stage* is
``("erode" | "dilate", ((dy, lo, hi), ...))``: per SE row offset ``dy`` the
contiguous column run ``[lo, hi]`` around the anchor. Out-of-image samples
are the op's neutral (255 for erode, 0 for dilate), which is OpenCV's
morphologyDefaultBorderValue.

:func:`morph_chain` runs a stage chain on masks, its head (a threshold
compare, ``!= 0``, an ROI AND) fused: ``csrc/morph.cu`` (the port of
:func:`tpu_inspect.ops.morph_pallas._morph_chain`) for CUDA tensors, one
launch a chain on bit planes, and :func:`morph_chain_plain` (the head, then
:func:`apply_stages` on 0/255 planes, then ``> 0``) for CPU tensors.
Kernels A and C run the same programs inside their own CTAs
(``csrc/planes.cuh``), and their plain versions call the plain chain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_inspect_torch.kernels import Kernel, as_planes, build, check_vector, device_constant

_MORPH = Kernel("morph")


def ellipse_se(k: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (k, k)) bit-exact."""
    k = int(k)
    se = np.zeros((k, k), dtype=np.uint8)
    r = k // 2
    c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(k):
        dy = i - r
        j1 = j2 = 0
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, k)
        se[i, j1:j2] = 1
    return se


def _se_runs(se: np.ndarray) -> list[tuple[int, int, int]]:
    """Decompose an SE into per-row runs [(dy, lo_dx, hi_dx)] around its
    anchor (OpenCV default (k//2, k//2)); every row must be one run."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    runs = []
    for i in range(kh):
        cols = np.flatnonzero(se[i])
        if cols.size == 0:
            continue
        assert (np.diff(cols) == 1).all(), "non-contiguous SE row"
        runs.append((i - ay, int(cols[0]) - ax, int(cols[-1]) - ax))
    return runs


def minkowski_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SE dilation a (+) b (odd square SEs, shared center anchor)."""
    ka, kb = a.shape[0], b.shape[0]
    k = ka + kb - 1
    out = np.zeros((k, k), dtype=np.uint8)
    rb = kb // 2
    ys, xs = np.nonzero(b)
    for y, x in zip(ys, xs):
        dy, dx = int(y) - rb, int(x) - rb
        out[rb + dy : rb + dy + ka, rb + dx : rb + dx + ka] |= a
    return out


def _runs_tuple(se: np.ndarray):
    return tuple(_se_runs(se))


@functools.lru_cache(maxsize=32)
def close_open_stages(k: int):
    """morph_close then morph_open with the k x k ellipse B, as the three
    stages dilate(B), erode(B (+) B), dilate(B) where that is exact, else as
    the four stages dilate(B), erode(B), erode(B), dilate(B).

    :func:`minkowski_sum` centres B (+) B on B's centre, which is B's
    anchor only when B is symmetric about it: every odd k, no even k (the
    anchor k//2 is off centre). For k = 2 and 4 the three stages differ
    from cv2's close then open; the four equal it for every k."""
    se = ellipse_se(k)
    runs = _runs_tuple(se)
    if set(runs) != {(-dy, -hi, -lo) for dy, lo, hi in runs}:
        return (("dilate", runs), ("erode", runs), ("erode", runs), ("dilate", runs))
    return (
        ("dilate", runs),
        ("erode", _runs_tuple(minkowski_sum(se, se))),
        ("dilate", runs),
    )


@functools.lru_cache(maxsize=32)
def open_stages(k: int):
    """morph_open with the k x k ellipse SE."""
    se = ellipse_se(k)
    return (("erode", _runs_tuple(se)), ("dilate", _runs_tuple(se)))


def rect_erode_stages(n: int):
    """cv2.erode(x, None, iterations=n) == one (2n+1)^2 rect erode."""
    n = int(n)
    if n <= 0:
        return ()
    return (("erode", tuple((dy, -n, n) for dy in range(-n, n + 1))),)


def group_runs(runs) -> list[tuple[int, int, list[int]]]:
    """Group a stage's row-runs by column window: [(lo, hi, [dy, ...])].

    A stage then costs one horizontal sliding reduction per distinct window
    plus one vertical combine per row offset — a rect is one window, i.e.
    separable."""
    by_win: dict[tuple[int, int], list[int]] = {}
    for dy, lo, hi in runs:
        by_win.setdefault((int(lo), int(hi)), []).append(int(dy))
    return [(lo, hi, sorted(dys)) for (lo, hi), dys in sorted(by_win.items())]


def stage_program(stages) -> list[int]:
    """Flatten a stage chain into the CUDA kernels' int32 program
    (``csrc/planes.cuh: apply_stages``): n_stages, then per stage op
    (0 erode, 1 dilate), n_groups, and per group lo, hi, n_dy, dy..."""
    prog = [len(stages)]
    for op, runs in stages:
        if op not in ("erode", "dilate"):
            raise ValueError(f"unknown morphology op {op!r}")
        groups = group_runs(runs)
        prog += [0 if op == "erode" else 1, len(groups)]
        for lo, hi, dys in groups:
            prog += [lo, hi, len(dys), *dys]
    return prog


@device_constant(maxsize=64)
def stage_program_tensor(stages, device: str) -> torch.Tensor:
    """:func:`stage_program` as an int32 tensor on ``device`` (cached per
    stage chain, so a launch does not copy it again)."""
    return torch.tensor(stage_program(stages), dtype=torch.int32, device=device)


def _shift_rows(a: torch.Tensor, dy: int, fill: int) -> torch.Tensor:
    """out[..., y, :] = a[..., y + dy, :], out-of-range rows = fill."""
    if dy == 0:
        return a
    out = torch.full_like(a, fill)
    h = a.shape[-2]
    if abs(dy) >= h:
        return out
    if dy > 0:
        out[..., : h - dy, :] = a[..., dy:, :]
    else:
        out[..., -dy:, :] = a[..., : h + dy, :]
    return out


def _window_red_cols(a: torch.Tensor, lo: int, hi: int, is_erode: bool,
                     fill: int) -> torch.Tensor:
    """red over a[..., x+lo : x+hi+1] along the last axis, out-of-range =
    fill (the neutral is padded in before reducing)."""
    if lo == 0 and hi == 0:
        return a
    w = a.shape[-1]
    pre, post = max(0, -lo), max(0, hi)
    p = torch.full(a.shape[:-1] + (w + pre + post,), fill, dtype=a.dtype,
                   device=a.device)
    p[..., pre : pre + w] = a
    win = p[..., pre + lo : pre + lo + w + (hi - lo)].unfold(-1, hi - lo + 1, 1)
    return win.amin(-1) if is_erode else win.amax(-1)


def apply_stages(v: torch.Tensor, stages) -> torch.Tensor:
    """Apply a stage chain to [U, H, W] uint8 planes (plain torch ops)."""
    for op, runs in stages:
        is_erode = op == "erode"
        fill = 255 if is_erode else 0
        red = torch.minimum if is_erode else torch.maximum
        acc = None
        for lo, hi, dys in group_runs(runs):
            hred = _window_red_cols(v, lo, hi, is_erode, fill)
            for dy in dys:
                s = _shift_rows(hred, dy, fill)
                acc = s if acc is None else red(acc, s)
        v = acc
    return v


_SMEM_FAST = 64 * 1024  # tiles within this keep several CTAs an SM
_SMEM_MAX = 232448  # a Hopper block's dynamic shared memory
_SM_COUNT = 132  # H100 SXM


_ONE_PASS_ROWS = 3  # csrc/morph.cu: kOnePassRows


def _stage_is_small(groups) -> bool:
    """Whether kernel I's ``apply_stages`` (``csrc/planes.cuh``) runs a stage
    in its one pass from registers: every group's column window within +-32
    pixels and at most ``_ONE_PASS_ROWS`` row offsets. Otherwise it takes a
    pass per group (each row's column window once, then the rows), which
    needs three more scratch planes."""
    return all(lo <= hi and lo >= -32 and hi <= 32 and len(dys) <= _ONE_PASS_ROWS
               for lo, hi, dys in groups)


@functools.lru_cache(maxsize=64)
def _stage_layout(stages) -> tuple[tuple[int, int, bool], ...]:
    """Per stage: (column reach rx, row reach ry, run in one pass)."""
    out = []
    for _, runs in stages:
        groups = group_runs(runs)
        rx = max(max(-lo, hi, 0) for lo, hi, _ in groups)
        ry = max(abs(dy) for _, _, dys in groups for dy in dys)
        out.append((rx, ry, _stage_is_small(groups)))
    return tuple(out)


def chain_row_reach(stages) -> int:
    """Rows a stage chain reaches each way: the sum of its stages' row
    reaches (the halo a strip of the plane needs for the chain)."""
    return sum(s[1] for s in _stage_layout(tuple(stages)))


@functools.lru_cache(maxsize=256)
def morph_tiles(u: int, h: int, w: int, stages):
    """Kernel I's tiling of a chain on [u, h, w] masks: (tile rows, tile
    words, row reach, column reach, big, shared bytes), or None when no
    tile fits a block's shared memory.

    A CTA reads its tile plus a halo of the chain's summed reach each way,
    clipped to the plane, into 2 bit planes of shared memory (5 with a
    stage not run in one pass, ``big``). Among tiles of 8-512 rows and 1-32
    words, the pick prefers one within 64 KB, then the least modeled time:
    the buffers' words spread over 132 SMs, or one CTA's buffer at a
    quarter of an SM, whichever is longer; then the fewest words in all."""
    layout = _stage_layout(tuple(stages))
    rx = sum(s[0] for s in layout)
    ry = sum(s[1] for s in layout)
    big = not all(s[2] for s in layout)
    ww = (w + 31) // 32
    rww = (rx + 31) // 32
    planes = 5 if big else 2
    best = None
    for th in (8, 16, 32, 64, 128, 256, 512):
        for tww in (1, 2, 4, 8, 16, 32):
            t_h, t_w = min(th, h), min(tww, ww)
            words = min(h, t_h + 2 * ry) * min(ww, t_w + 2 * rww)
            smem = 4 * planes * words
            n_rows = -(-h // t_h)
            if smem > _SMEM_MAX or n_rows > 65535:
                continue
            ctas = u * n_rows * -(-ww // t_w)
            key = (smem > _SMEM_FAST, max(ctas * words / _SM_COUNT, 4 * words), ctas * words)
            if best is None or key < best[0]:
                best = (key, (t_h, t_w, ry, rx, big, smem))
    return None if best is None else best[1]


def _head(x: torch.Tensor, thr, roi) -> torch.Tensor:
    """The chain's head as a bool plane: ``x <= thr[u]`` with ``thr``, else
    ``x != 0``; ANDed with ``roi != 0`` with ``roi``."""
    if thr is not None:
        m = x.to(torch.int32) <= thr.to(torch.int32).reshape(-1, 1, 1)
    else:
        m = x != 0
    return m if roi is None else m & (roi != 0)


def morph_chain_plain(x: torch.Tensor, stages, thr=None, roi=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`morph_chain` (same contract):
    ``apply_stages(head * 255, stages) > 0``; it launches no kernel."""
    return apply_stages(_head(x, thr, roi).to(torch.uint8) * 255, tuple(stages)) > 0


@_MORPH
def morph_chain(x: torch.Tensor, stages, thr=None, roi=None) -> torch.Tensor:
    """A stage chain on [U, H, W] masks, its head fused; kernel I.

    ``x`` [U, H, W] bool or uint8; the head is ``x <= thr[u]`` with ``thr``
    ([U] int32, THRESH_BINARY_INV: the seg tail's), else ``x != 0``, ANDed
    with ``roi != 0`` with ``roi`` (bool or uint8, x's shape: the defect
    candidates'). Returns the chain's result as a [U, H, W] bool plane:
    :func:`morph_chain_plain`'s, i.e. ``apply_stages(head * 255) > 0``
    (OpenCV borders: out-of-plane samples are each stage's neutral). On CUDA
    the whole chain, head included, is one launch of ``csrc/morph.cu``
    (an empty chain too: the head alone); on the CPU the plain version
    runs. A chain whose summed reach leaves no tile within a block's shared
    memory (a rect erode above 288 pixels each way on a 4096x3000 plane;
    every ``morph_kernel`` and ``erode_px`` the config allows fits) raises
    ValueError."""
    x = as_planes(x, "morph_chain")
    u, h, w = x.shape
    if thr is not None:
        check_vector(thr, "morph_chain thr", u, x.device)
    if roi is not None:
        roi = as_planes(roi, "morph_chain roi")
        if roi.shape != x.shape or roi.device != x.device:
            raise ValueError("morph_chain: roi must match x in shape and device")
    stages = tuple(stages)
    if x.device.type == "cpu":
        return morph_chain_plain(x, stages, thr, roi)
    if u >= 65536:
        raise ValueError(f"morph_chain: {u} units beyond the kernel's grid")
    tiles = morph_tiles(u, h, w, stages)
    if tiles is None:
        raise ValueError("morph_chain: the chain's reach leaves no tile within a block's "
                         "shared memory")
    th, tww, ry, rx, big, _ = tiles
    prog = stage_program_tensor(stages, str(x.device))
    out = torch.empty((u, h, w), dtype=torch.uint8, device=x.device)
    err = build.lib().tik_morph_chain(
        x.data_ptr(), None if thr is None else thr.data_ptr(),
        None if roi is None else roi.data_ptr(), out.data_ptr(), prog.data_ptr(), u, h, w,
        th, tww, ry, rx, int(big), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("morph_chain", err)
    _MORPH.launched()
    return out.view(torch.bool)


def _on_mask(x: torch.Tensor, stages) -> torch.Tensor:
    """:func:`morph_chain` on a mask (any nonzero = fg) as uint8 0/255."""
    return morph_chain(x, stages).to(torch.uint8) * 255


def erode(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2.erode of [U, H, W] masks with the SE ``se`` (OpenCV borders):
    uint8 0/255, what :func:`tpu_inspect.ops.morphology.erode` gives on
    0/255 planes; one launch of kernel I on CUDA tensors."""
    return _on_mask(x, (("erode", _runs_tuple(se)),))


def dilate(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2.dilate of [U, H, W] masks, as :func:`erode`."""
    return _on_mask(x, (("dilate", _runs_tuple(se)),))


def morph_open(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Erode then dilate with ``se``, in one launch of kernel I."""
    runs = _runs_tuple(se)
    return _on_mask(x, (("erode", runs), ("dilate", runs)))


def morph_close(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Dilate then erode with ``se``, in one launch of kernel I."""
    runs = _runs_tuple(se)
    return _on_mask(x, (("dilate", runs), ("erode", runs)))


def erode_rect3(x: torch.Tensor, iterations: int) -> torch.Tensor:
    """cv2.erode(x, None, iterations=n) of [U, H, W] masks: one (2n+1)^2
    rect erode (:func:`rect_erode_stages`), uint8 0/255; n <= 0 returns
    ``x`` as :func:`tpu_inspect.ops.morphology.erode_rect3` does."""
    if int(iterations) <= 0:
        return x
    return _on_mask(x, rect_erode_stages(iterations))
