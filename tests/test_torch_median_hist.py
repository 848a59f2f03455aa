"""Kernels B and H, the sliding-histogram walk of ``csrc/median_hist.cuh``,
against their plain PyTorch versions on the walk's hazards.

On the CPU, a numpy model of the walk (strips, the warm-up, clamped rows
and columns counted with their multiplicity, the step down, the band then
bin query with the band carried from row to row) is held against the plain
versions, so the algorithm is checked without a card. On a GPU (``cuda``
marker) the kernels themselves are held against the plain versions on the
same cases. The file imports neither jax nor tpu_inspect:

    python -m pytest tests/test_torch_median_hist.py -q -m cuda --noconftest

Tolerance is exact equality: both compute integer results.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops.median import (
    _median_blur,
    _median_residual,
    median_blur_u8,
    median_blur_u8_plain,
    median_residual_mask,
    median_residual_mask_plain,
    strip_rows,
)


def _plane(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randint(0, 256, shape, dtype=np.uint8)
    if kind == "flat":  # one value
        return np.full(shape, 77, np.uint8)
    if kind == "binary":  # only 0 and 255
        return ((rng.rand(*shape) > 0.5) * 255).astype(np.uint8)
    if kind == "units":  # each unit its own value range: a mixed unit shows
        x = rng.randint(0, 16, shape).astype(np.uint8)
        return (x + 80 * np.arange(shape[0], dtype=np.uint8)[:, None, None]).astype(np.uint8)
    raise ValueError(kind)


# kernel B: (plane, (U, H, W), k, thr, row_lo, row_hi, strip); strip None is
# the wrappers' default (strip_rows)
RESIDUAL_CASES = {
    "k21 rows 0..H, empty, inside": ("random", (3, 37, 53), 21, 24, [0, 4, 37], [37, 30, 0], None),
    "k3 width 1": ("random", (2, 40, 1), 3, 10, [0, 3], [40, 38], None),
    "k21 width 31, strips end in the ROI": ("random", (2, 40, 31), 21, 24, [3, 0], [38, 40], 5),
    "k21 width 32": ("random", (1, 40, 32), 21, 24, [1], [39], 7),
    "k45 width 33": ("random", (2, 40, 33), 45, 24, [0, 10], [40, 11], None),
    "k45 width 315, thr 0": ("random", (1, 24, 315), 45, 0, [2], [22], None),
    "k21 width 316, thr 255": ("random", (2, 24, 316), 21, 255, [0, 5], [24, 19], 8),
    "k21 H = 1": ("random", (2, 1, 40), 21, 24, [0, 0], [1, 0], None),
    "k21 row_lo == row_hi": ("random", (2, 30, 40), 21, 24, [10, 0], [10, 30], None),
    "k45 flat": ("flat", (2, 30, 40), 45, 0, [0, 3], [30, 25], None),
    "k21 0/255, thr 0": ("binary", (2, 30, 40), 21, 0, [0, 3], [30, 25], 6),
    "k3 0/255, thr 255": ("binary", (2, 30, 40), 3, 255, [0, 0], [30, 30], None),
    "k21 units apart": ("units", (3, 30, 41), 21, 4, [0, 0, 0], [30, 30, 30], 9),
}

# kernel H: (plane, (U, H, W), k, strip)
BLUR_CASES = {
    "k3": ("random", (3, 37, 53), 3, None),
    "k47": ("random", (3, 37, 53), 47, None),
    "k49, strips of 5": ("random", (3, 37, 53), 49, 5),
    "k101 above the unit": ("random", (2, 37, 53), 101, None),
    "k301 above the unit (32-bit bins)": ("random", (2, 37, 53), 301, 11),
    "k301 width 316 (rows over 255 columns)": ("random", (1, 20, 316), 301, None),
    "k101 2x64x41": ("random", (2, 64, 41), 101, None),
    "k301 2x64x41": ("random", (2, 64, 41), 301, None),
    "k101 1x5x7, far above the unit": ("random", (1, 5, 7), 101, None),
    "k301 1x5x7, far above the unit": ("random", (1, 5, 7), 301, 2),
    "k47 width 1": ("random", (2, 40, 1), 47, None),
    "k47 widths 31": ("random", (1, 40, 31), 47, 9),
    "k47 width 32": ("random", (1, 40, 32), 47, None),
    "k47 width 33": ("random", (2, 40, 33), 47, None),
    "k47 width 315": ("random", (1, 20, 315), 47, None),
    "k49 width 316": ("random", (1, 20, 316), 49, 6),
    "k47 H = 1": ("random", (2, 1, 40), 47, None),
    "k101 flat": ("flat", (2, 30, 40), 101, None),
    "k47 0/255": ("binary", (2, 30, 40), 47, 7),
    "k47 units apart": ("units", (3, 30, 41), 47, None),
}


def _walk_model(x: np.ndarray, k: int, strip: int, lo=None, hi=None) -> np.ndarray:
    """numpy model of ``median_hist.cuh``'s walk as kernels B and H run it:
    the median at each walked pixel, -1 elsewhere. Strips of ``strip`` rows
    from row 0 (H) or from each unit's max(lo, 0) up to min(hi, H) (B); per
    strip a column's 256 bins, warmed up with the distinct clamped rows and
    columns of its first window, each weighted by its repeats; each step
    removes row clamp(y - r) and adds row clamp(y + 1 + r) (nothing when the
    two are one row). Beside the bins a column carries ``base``, 16 x the
    band of its last median, and ``below``, its window's samples under
    ``base``, kept up to date by every update; the query moves ``base``
    band by band to the band holding the rank, then finds the bin in it."""
    u, h, w = x.shape
    r = k // 2
    rank = (k * k + 1) // 2
    out = np.full(x.shape, -1, np.int64)
    cols = np.arange(w)
    j0, j1 = np.maximum(0, cols - r), np.minimum(w - 1, cols + r)
    left, right = np.maximum(0, r - cols), np.maximum(0, cols + r - (w - 1))
    for ui in range(u):
        y_lo = 0 if lo is None else max(int(lo[ui]), 0)
        y_hi = h if hi is None else min(int(hi[ui]), h)
        for s in range(-(-h // strip)):
            y0 = y_lo + s * strip
            y1 = min(y_hi, y0 + strip)
            if y0 >= y1:
                continue
            bins = np.zeros((w, 256), np.int64)
            base = np.zeros(w, np.int64)
            below = np.zeros(w, np.int64)

            def put(c, v, wt):
                np.add.at(bins, (c, v), wt)
                np.add.at(below, c, np.where(v < base[c], wt, 0))

            def row(i, wt):
                p = x[ui, i].astype(np.int64)
                for t in range(min(k, w)):  # the distinct columns j0..j1
                    ok = j0 + t <= j1
                    put(cols[ok], p[np.minimum(j0 + t, w - 1)][ok], wt)
                for extra, j in ((left, 0), (right, w - 1)):  # edge repeats
                    m = extra > 0
                    put(cols[m], np.full(m.sum(), p[j]), wt * extra[m])

            for i in range(max(0, y0 - r), min(h - 1, y0 + r) + 1):
                row(i, 1 + (max(0, r - y0) if i == 0 else 0)
                    + (max(0, y0 + r - (h - 1)) if i == h - 1 else 0))
            for y in range(y0, y1):
                assert (bins >= 0).all() and (bins.sum(1) == k * k).all()
                while True:
                    cum = np.cumsum(bins, axis=1)
                    assert (below == np.where(base > 0, cum[cols, base - 1], 0)).all()
                    band_sum = bins[cols[:, None], base[:, None] + np.arange(16)].sum(1)
                    down, up = rank <= below, rank > below + band_sum
                    if not (down | up).any():
                        break
                    base = np.where(down, base - 16, np.where(up, base + 16, base))
                    below = np.where(base > 0, cum[cols, np.maximum(base - 1, 0)], 0)
                band_bins = bins[cols[:, None], base[:, None] + np.arange(16)]
                cum_f = below[:, None] + np.cumsum(band_bins, axis=1)
                out[ui, y] = base + np.argmax(cum_f >= rank, axis=1)
                leave, enter = max(0, y - r), min(h - 1, y + 1 + r)
                if y + 1 < y1 and leave != enter:
                    row(leave, -1)
                    row(enter, 1)
    return out


def _residual_model(x, k, thr, lo, hi, strip):
    m = _walk_model(x, k, strip, lo, hi)
    res = np.abs(x.astype(np.int64) - m) > thr
    return np.where((m >= 0) & res, 255, 0).astype(np.uint8)


def _residual_inputs(case):
    kind, shape, k, thr, lo, hi, strip = RESIDUAL_CASES[case]
    x = _plane(kind, shape, seed=len(case))
    strip = strip or strip_rows("median_residual", *shape)
    return x, k, thr, np.array(lo, np.int32), np.array(hi, np.int32), strip


def _blur_inputs(case):
    kind, shape, k, strip = BLUR_CASES[case]
    return _plane(kind, shape, seed=len(case)), k, strip or strip_rows("median_blur", *shape)


@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_walk_model_residual_matches_plain(case):
    x, k, thr, lo, hi, strip = _residual_inputs(case)
    ref = median_residual_mask_plain(torch.from_numpy(x), k, thr, torch.from_numpy(lo),
                                     torch.from_numpy(hi))
    np.testing.assert_array_equal(_residual_model(x, k, thr, lo, hi, strip), ref.numpy())


@pytest.mark.parametrize("case", list(BLUR_CASES))
def test_walk_model_blur_matches_plain(case):
    x, k, strip = _blur_inputs(case)
    got = _walk_model(x, k, strip)
    assert (got >= 0).all()  # every row walked once
    np.testing.assert_array_equal(got, median_blur_u8_plain(torch.from_numpy(x), k).numpy())


def _weighted_median(x: np.ndarray, k: int) -> np.ndarray:
    """The clamped-window median straight from its definition, for a plane
    too small and a k too large for the plain version's padded cumsum: the
    multiset of each window as (value, row repeats x column repeats)."""
    u, h, w = x.shape
    r = k // 2
    rank = (k * k + 1) // 2
    out = np.empty(x.shape, np.int64)
    for y in range(h):
        wr = np.bincount(np.clip(np.arange(y - r, y + r + 1), 0, h - 1), minlength=h)
        for c in range(w):
            wc = np.bincount(np.clip(np.arange(c - r, c + r + 1), 0, w - 1), minlength=w)
            for ui in range(u):
                counts = np.bincount(x[ui].ravel(), weights=np.outer(wr, wc).ravel(),
                                     minlength=256)
                out[ui, y, c] = int(np.argmax(np.cumsum(counts) >= rank))
    return out


def test_walk_model_64bit_window():
    """k = 46341, k*k > 2^31: the 64-bit form's window on a 3x5 plane."""
    x = _plane("random", (2, 3, 5), seed=5)
    np.testing.assert_array_equal(_walk_model(x, 46341, strip_rows("median_blur", 2, 3, 5)),
                                  _weighted_median(x, 46341))


def test_strip_rows_and_bad_strip():
    # the 48 units and the whole plane keep their strips; one unit halves
    # them down to 8 rows, so that its few columns still make many strips
    assert strip_rows("median_residual", 48, 315, 316) == 32
    assert strip_rows("median_residual", 1, 3000, 4096) == 16
    assert strip_rows("median_blur", 48, 315, 316) == 128
    assert strip_rows("median_blur", 1, 3000, 4096) == 128
    assert strip_rows("median_residual", 1, 315, 316) == strip_rows("median_blur", 1, 315, 316) == 8
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="strip"):
            _median_residual(x, 3, 0, strip=bad)
        with pytest.raises(ValueError, match="strip"):
            _median_blur(x, 3, strip=bad)


_CSRC = Path(__file__).resolve().parents[1] / "tpu_inspect_torch" / "csrc"
# the ablation modes' bound on band moves (csrc/median_hist.cuh)
MAX_MOVES = int(re.search(r"kMaxMoves = (\d+);", (_CSRC / "median_hist.cuh").read_text())[1])


def _band_query(bins: np.ndarray, rank: int, base: int, below: int, bounded: bool):
    """numpy model of one column's band query in ``median_hist.cuh``'s walk:
    move ``base`` band by band to the band holding the rank, then find the
    bin. ``bounded`` is the ablation modes' loop: at most MAX_MOVES moves,
    ``base`` clamped to 0..240. Returns (median, base after, the bases read);
    the unbounded loop gives up after 1000 moves (the kernel would not)."""
    read = []
    for moves in range(1000):
        read.append(base)
        s = bins[base:base + 16].sum() if 0 <= base <= 240 else 0
        if bounded and moves == MAX_MOVES:
            return base, base, read
        if rank <= below:
            base = max(base - 16, 0) if bounded else base - 16
            read.append(base)
            below -= bins[base:base + 16].sum() if 0 <= base <= 240 else 0
        elif rank > below + s:
            below += s
            base = min(base + 16, 240) if bounded else base + 16
        else:
            hit = np.nonzero(below + np.cumsum(bins[base:base + 15]) >= rank)[0]
            return base + (int(hit[0]) if hit.size else 15), base, read
    return None, base, read


# wrong counts the ablations can leave (nowarm: removals from bins never
# added to; noatomic: lost updates; both: a 16-bit half that borrowed from
# its neighbour reads as up to 65535), with a carried base and below that
# no longer match them
BAD_HISTOGRAMS = {
    "empty": lambda rng: np.zeros(256, np.int64),
    "negative": lambda rng: -rng.randint(0, 50, 256),
    "borrowed halves": lambda rng: np.where(rng.rand(256) < 0.1, 65535, 0),
    "signed mix": lambda rng: rng.randint(-441, 442, 256),
}


@pytest.mark.parametrize("kind", list(BAD_HISTOGRAMS))
def test_ablation_band_loop_ends_in_bounds(kind):
    """The ablation modes' bounded band loop ends within MAX_MOVES moves
    with every band it reads, and ``base``, in 0..240, on any counts and
    any carried base/below; on counts where the unbounded loop (the
    baseline's) walks out of the bins, it still does. On exact counts it
    gives the baseline's median."""
    rng = np.random.RandomState(len(kind))
    left_bins = 0
    for trial in range(200):
        bins = BAD_HISTOGRAMS[kind](rng)
        rank = (rng.choice([3, 21, 45]) ** 2 + 1) // 2
        base = 16 * rng.randint(0, 16)
        below = int(rng.randint(-2000, 2000))
        m, end, read = _band_query(bins, rank, base, below, bounded=True)
        assert m is not None and 0 <= m <= 255
        assert 0 <= end <= 240 and all(0 <= b <= 240 for b in read)
        assert len(read) <= 2 * (MAX_MOVES + 1)
        _, _, read_free = _band_query(bins, rank, base, below, bounded=False)
        left_bins += any(b < 0 or b > 240 for b in read_free)
    if kind in ("empty", "negative"):
        assert left_bins, "the unbounded loop should leave the bins on these counts"
    # exact counts: a k x k window's histogram with its base and below
    for trial in range(50):
        k = int(rng.choice([3, 21, 45]))
        bins = np.bincount(rng.randint(0, 256, k * k), minlength=256)
        base = 16 * rng.randint(0, 16)
        below = int(bins[:base].sum())
        rank = (k * k + 1) // 2
        want = int(np.argmax(np.cumsum(bins) >= rank))
        assert _band_query(bins, rank, base, below, bounded=False)[0] == want
        assert _band_query(bins, rank, base, below, bounded=True)[0] == want


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_equal(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), f"max |err| {(got.int() - ref.int()).abs().max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_median_residual_kernel_matches_plain(cuda, case):
    x, k, thr, lo, hi, strip = _residual_inputs(case)
    x, lo, hi = (torch.from_numpy(a).to(cuda) for a in (x, lo, hi))
    reset_launches()
    got = _median_residual(x, k, thr, lo, hi, strip=strip)
    assert LAUNCHES["median_residual"] == 1
    _assert_equal(got, median_residual_mask_plain(x, k, thr, lo, hi))
    # the default strip too, and one unit at a time: units never mix
    _assert_equal(median_residual_mask(x, k, thr, lo, hi), got)
    for ui in range(x.shape[0]):
        one = _median_residual(x[ui : ui + 1].contiguous(), k, thr, lo[ui : ui + 1],
                               hi[ui : ui + 1], strip=strip)
        _assert_equal(one[0], got[ui])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BLUR_CASES))
def test_median_blur_kernel_matches_plain(cuda, case):
    x, k, strip = _blur_inputs(case)
    x = torch.from_numpy(x).to(cuda)
    reset_launches()
    got = _median_blur(x, k, strip=strip)
    assert LAUNCHES["median_blur"] == 1
    _assert_equal(got, median_blur_u8_plain(x, k))
    _assert_equal(median_blur_u8(x, k), got)
    for ui in range(x.shape[0]):
        _assert_equal(_median_blur(x[ui : ui + 1].contiguous(), k, strip=strip)[0], got[ui])


@pytest.mark.cuda
def test_median_blur_kernel_64bit_window(cuda):
    """k = 46341 (k*k > 2^31): 64-bit bins and int64 counts, against the
    plain version (one output row a step, to bound its padded cumsum)."""
    x = torch.from_numpy(_plane("random", (2, 3, 5), seed=5)).to(cuda)
    got = median_blur_u8(x, 46341)
    _assert_equal(got, median_blur_u8_plain(x, 46341, rows_per_step=1))
    assert np.array_equal(got.cpu().numpy(), _weighted_median(x.cpu().numpy(), 46341))
