"""Morphology: OpenCV structuring elements, stage tuples, the plain stage
chain (OpenCV clip-to-image borders), batched over [U, H, W]; kernel I.

The SE tables are numpy copies of :func:`tpu_inspect.ops.morphology.ellipse_se`
/ ``_se_runs`` and :mod:`tpu_inspect.ops.morph_pallas`'s ``minkowski_sum`` /
``_close_open_stages`` / ``_open_stages``. A *stage* is
``("erode" | "dilate", ((dy, lo, hi), ...))``: per SE row offset ``dy`` the
contiguous column run ``[lo, hi]`` around the anchor. Out-of-image samples
are the op's neutral (255 for erode, 0 for dilate), which is OpenCV's
morphologyDefaultBorderValue.

:func:`morph_chain` runs a stage chain: ``csrc/morph.cu`` (the port of
:func:`tpu_inspect.ops.morph_pallas._morph_chain`) for CUDA tensors, one
launch per stage, and :func:`apply_stages` for CPU tensors. Kernels A and
C run the same programs inside their own CTAs (``csrc/planes.cuh``), and
their plain versions call :func:`apply_stages` directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_inspect_torch.kernels import LAUNCHES, build, check_planes


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


@functools.lru_cache(maxsize=64)
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


_MORPH_TILE_W = 32  # csrc/morph.cu: kTileW
_MORPH_SMEM_FAST = 64 * 1024
_MORPH_SMEM_MAX = 232448  # a Hopper block's dynamic shared memory


def _morph_smem(th: int, rx: int, ry: int) -> int:
    """Shared bytes of kernel I's tile: the input tile plus halo and the
    horizontal buffer (``csrc/morph.cu: launch``)."""
    return (th + 2 * ry) * (2 * _MORPH_TILE_W + 2 * rx)


def morph_tile_rows(rx: int, ry: int) -> int | None:
    """Kernel I's output tile rows for a stage reaching rx columns and ry
    rows: the most of 32, 16, 8 within 64 KB of shared memory, else 8 while
    it fits a block at all, else None (the stage is refused)."""
    for th in (32, 16, 8):
        if _morph_smem(th, rx, ry) <= _MORPH_SMEM_FAST:
            return th
    return 8 if _morph_smem(8, rx, ry) <= _MORPH_SMEM_MAX else None


@functools.lru_cache(maxsize=64)
def _stage_layout(stages) -> tuple[tuple[int, bool, int, int], ...]:
    """Per stage of :func:`stage_program`'s program: (word offset of its op,
    erode, column reach rx, row reach ry)."""
    out, p = [], 1
    for op, runs in stages:
        groups = group_runs(runs)
        rx = max(max(-lo, hi, 0) for lo, hi, _ in groups)
        ry = max(abs(dy) for _, _, dys in groups for dy in dys)
        out.append((p, op == "erode", rx, ry))
        p += 2 + sum(3 + len(dys) for _, _, dys in groups)
    return tuple(out)


def morph_chain(x: torch.Tensor, stages) -> torch.Tensor:
    """Apply a stage chain to [U, H, W] uint8 planes; kernel I.

    The result is :func:`apply_stages`'s (OpenCV borders: out-of-plane
    samples are 255 for erode, 0 for dilate). On CUDA each stage is one
    launch of ``csrc/morph.cu`` over ping-pong buffers; an empty chain
    returns ``x``. A stage whose reach does not fit a block's shared memory
    (above 223 pixels each way) raises ValueError."""
    check_planes(x, "morph_chain")
    stages = tuple(stages)
    if x.device.type == "cpu":
        return apply_stages(x, stages)
    if not stages:
        return x
    u, h, w = x.shape
    if u >= 65536:
        raise ValueError(f"morph_chain: {u} units beyond the kernel's grid")
    layout = _stage_layout(stages)
    rows = [morph_tile_rows(rx, ry) for _, _, rx, ry in layout]
    if None in rows:
        raise ValueError("morph_chain: a stage's reach does not fit a block's shared memory")
    prog = stage_program_tensor(stages, str(x.device))
    n = len(stages)
    bufs = (torch.empty_like(x), torch.empty_like(x) if n > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for i, ((off, erode, rx, ry), th) in enumerate(zip(layout, rows)):
        dst = bufs[(n - 1 - i) % 2]  # the last stage writes bufs[0]
        err = build.lib().tik_morph_stage(
            src.data_ptr(), dst.data_ptr(), prog.data_ptr() + 4 * off, u, h, w,
            int(erode), rx, ry, th, stream,
        )
        build.check("morph_chain", err)
        LAUNCHES["morph"] += 1
        src = dst
    return src
