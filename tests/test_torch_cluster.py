"""Kernel J's band split over a thread-block cluster and kernel G's region
slot per 2x2 block: their traps, each case exact against the plain version.

On the CPU (the JAX package imported inside those tests only, so that the
``cuda`` tests run on a host without JAX with ``--noconftest``):

- a numpy model of J's passes (``csrc/label_stats.cu``) over bands of
  block rows, each band seeing only its own pixel rows and the halo row
  below it: its runs, the unions at pixel-run starts inside each band,
  each block under its band root, the seams united by band roots, each
  band root under its unit root, the winner key and the stats merged from
  per-band partials, held against the JAX package's
  ``cc.largest_component_sums`` over random band heights;
- G's slot (the 2x2 block of a region's label pixel) is one slot per fill
  region of ``ops.contour.fill_regions``, on random planes.

On the card (``cuda``): J on components crossing one and several seams,
diagonal joins exactly at a seam, an equal-area tie between roots in
different bands, heights that do not divide into bands, units of 1 and 2
rows, widths 1 and 31-33, the global-scratch form; G on regions whose first
pixel lies in the last odd row or column, a region over many CTAs' chunks
and a whole capture whose region sums pass 2^31. Tolerance 0 everywhere:
every output is an integer.
"""

import numpy as np
import pytest
import torch

from tpu_inspect_torch.kernels import LAUNCHES, reset_launches
from tpu_inspect_torch.ops._contour_table import CONTOUR_TABLE_X2
from tpu_inspect_torch.ops.blob_select import blob_select, blob_select_plain
from tpu_inspect_torch.ops import cc
from tpu_inspect_torch.ops.cc import largest_component, largest_component_sums
from tpu_inspect_torch.ops.contour import fill_regions

KCLUSTER = 16  # label_stats.cu: kMaxCluster, one unit's cluster on an H100


def bands_of(h: int, w: int, cluster: int = KCLUSTER):
    """label_stats.cu: bands_of -> (block rows a band, bands)."""
    hb = (h + 1) // 2
    br = -(-hb // cluster)
    return br, -(-hb // br)


def band_model(fg: np.ndarray, cluster: int):
    """Kernel J's passes on one [H, W] bool plane split into bands of at
    most ``cluster``: (mask, stats row). Each band sees only its own pixel
    rows and the halo row below them."""
    h, w = fg.shape
    hb, wb = (h + 1) // 2, (w + 1) // 2
    br_, nbands = bands_of(h, w, cluster)
    bands = []
    for r in range(nbands):
        b0, b1 = r * br_, min(hb, r * br_ + br_)
        bands.append((b0, b1, fg[2 * b0 : min(h, 2 * b1 + 1)]))  # the halo row included

    def bit(rows, ry, c):
        return bool(0 <= c < w and ry < rows.shape[0] and rows[ry, c])

    par = np.arange(hb * wb)  # unit-global block indices throughout

    def find(x):
        while par[x] != x:
            par[x] = par[par[x]]
            x = par[x]
        return x

    def unite(a, b):
        a, b = find(a), find(b)
        if a != b:
            par[max(a, b)] = min(a, b)

    def unions(rows, b0, by, visit):
        """S1/S2 at the pixel-run starts of rows 2by+1 and 2by+2."""
        up, lo = 2 * (by - b0) + 1, 2 * (by - b0) + 2
        for c in range(w):
            uc, up1 = bit(rows, up, c), bit(rows, up, c - 1)
            lc, lp1 = bit(rows, lo, c), bit(rows, lo, c - 1)
            if uc and not up1 and (lc or lp1):
                visit(by * wb + c // 2, (by + 1) * wb + (c if lc else c - 1) // 2)
            if lc and not lp1 and up1:
                visit(by * wb + (c - 1) // 2, (by + 1) * wb + c // 2)

    blk = np.zeros((2 * hb, 2 * wb), bool)
    blk[:h, :w] = fg
    cnt = blk.reshape(hb, 2, wb, 2).sum(axis=(1, 3)).reshape(-1)
    area = np.zeros(hb * wb, np.int64)
    for b0, b1, rows in bands:
        # runs: a block's parent is its run's first block (runs of the OR
        # of the block row's two pixel rows)
        for by in range(b0, b1):
            ry = 2 * (by - b0)
            col = [bit(rows, ry, c) or (2 * by + 1 < h and bit(rows, ry + 1, c))
                   for c in range(w)]
            last, start = -1, []
            for c in range(w):
                if col[c] and (c == 0 or not col[c - 1]):
                    last = c
                start.append(last)
            for bx in range(wb):
                if any(col[2 * bx : 2 * bx + 2]):
                    par[by * wb + bx] = by * wb + start[min(2 * bx + 1, w - 1)] // 2
        # the unions inside the band, then every block under its band root
        # and each band root's area
        for by in range(b0, b1 - 1):
            unions(rows, b0, by, unite)
        for b in range(b0 * wb, b1 * wb):
            if cnt[b]:
                par[b] = find(b)
                area[par[b]] += cnt[b]
    # the seams, united by band roots (the next band's root read from its
    # slots), then each band root under its unit root with its area
    for b0, b1, rows in bands:
        if b1 < hb:
            unions(rows, b0, b1 - 1, lambda a, b: unite(par[a], par[b]))
    for b in np.flatnonzero(area):
        r = find(b)
        if r != b:
            par[b] = r
            area[r] += area[b]
    key, root = 0, -1
    for b in np.flatnonzero(area):
        if par[b] == b:
            k = (int(area[b]) << 32) | (0xFFFFFFFF - int(b))
            if k > key:
                key, root = k, b
    # the mask and the stats, from each band's rows (not its halo row): a
    # block's unit root is its band root's parent (a band root's own)
    mask = np.zeros((h, w), bool)
    parts = []
    for b0, b1, rows in bands:
        sx = sy = 0
        rlo, rhi, clo, chi = h, 0, w, 0
        for y in range(2 * b0, min(h, 2 * b1)):
            for x in range(w):
                b = (y // 2) * wb + x // 2
                r = par[b] if area[b] else par[par[b]]
                if key and rows[y - 2 * b0, x] and r == root:
                    mask[y, x] = True
                    sx, sy = sx + x, sy + y
                    rlo, rhi, clo, chi = min(rlo, y), max(rhi, y + 1), min(clo, x), max(chi, x + 1)
        parts.append((sx, sy, rlo, rhi, clo, chi))
    p = np.array(parts)
    stats = [key >> 32, p[:, 0].sum(), p[:, 1].sum(), int(key != 0), p[:, 2].min(),
             p[:, 3].max(), p[:, 4].min(), p[:, 5].max()]
    return mask, np.array(stats, np.int64)


def _seam_planes():
    """[name, (H, W) bool plane]: the card cases' planes (the 315x316
    preview unit has 16 bands of 10 block rows on an H100, 8 of 20 where a
    cluster of 16 does not fit: seams at pixel rows 40, 80, ... either
    way)."""
    rng = np.random.RandomState(23)
    out = []
    a = np.zeros((315, 316), bool)
    a[30:290, 100:104] = True  # a bar through six seams
    a[39, 200] = a[40, 201] = True  # a diagonal pair exactly at a seam,
    a[39, 211] = a[40, 210] = True  # across block columns and within one
    a[79, 250:252] = a[80, 252:260] = True
    out.append(("seams", a))
    t = np.zeros((315, 316), bool)
    t[5:7, 10:13] = True  # six pixels in band 0
    t[300:302, 50:53] = True  # six in the last band: the tie goes to band 0
    t[150, 10] = True
    out.append(("tie across bands", t))
    stair = np.zeros((97, 33), bool)
    for y in range(97):  # a staircase down through every seam
        stair[y, (y // 3) % 33] = True
    out.append(("staircase", stair))
    for h, w in [(1, 1), (1, 40), (2, 33), (2, 1), (17, 31), (19, 32), (37, 33), (41, 1),
                 (63, 64), (315, 316)]:
        out.append((f"random {h}x{w}", rng.rand(h, w) > 0.45))
    return out


# the planes also held against the JAX package (one compile a shape)
JAX_SHAPES = {(97, 33), (2, 33), (17, 31), (41, 1), (23, 29)}


@pytest.mark.parametrize("cluster", [1, 3, 8, 16])
def test_band_model_matches_jax(cluster):
    """The band model equals the JAX package's largest_component_sums on the
    seam planes and random planes (bands of 1 to 49 block rows), and the
    port's plain version on every plane."""
    import jax.numpy as jnp

    from tpu_inspect.ops import cc as jcc

    rng = np.random.RandomState(cluster)
    planes = [p for _, p in _seam_planes() if p.size < 20_000]
    planes += [rng.rand(h, w) > 0.5 for h, w in [(23, 29), (40, 18), (9, 70)]]
    for fg in planes:
        mask, stats = band_model(fg, cluster)
        pm, ps = largest_component(torch.from_numpy(fg[None]))
        np.testing.assert_array_equal(mask, pm[0].numpy())
        np.testing.assert_array_equal(stats, ps[0].numpy())
        if fg.shape in JAX_SHAPES:
            ref = jcc.largest_component_sums(jnp.asarray(fg[None]))
            np.testing.assert_array_equal(mask, np.asarray(ref[0])[0])
            for col, r in zip((0, 1, 2, 3), ref[1:]):
                assert stats[col] == int(np.asarray(r)[0])


def test_band_model_tie_across_bands():
    """An equal-area tie whose roots lie in different bands goes to the
    smaller block index, whichever band holds it."""
    t = dict(_seam_planes())["tie across bands"][:, :80]
    mask, stats = band_model(t, KCLUSTER)
    assert mask[5, 10] and not mask[300, 50] and stats[0] == 6


def test_blob_select_slot_is_one_per_region():
    """G's slot, the 2x2 block of a region's label pixel, never holds two
    fill regions of ``ops.contour.fill_regions`` (8-connected components of
    ~ext: a block's pixels are 8-adjacent)."""
    rng = np.random.RandomState(31)
    for h, w, p in [(37, 53, 0.5), (64, 41, 0.35), (31, 33, 0.6), (1, 19, 0.5), (45, 1, 0.5)]:
        m = torch.from_numpy(rng.rand(2, h, w) > p)
        fill, _, ext = fill_regions(m)
        wb = (w + 1) // 2
        for u in range(2):
            labels = fill[u][~ext[u]].unique().numpy()
            slots = (labels // w // 2) * wb + (labels % w) // 2
            assert len(set(slots.tolist())) == len(labels)


# ---- on the card ------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _j_equal(fg_np, cuda):
    fg = torch.from_numpy(np.ascontiguousarray(fg_np)).to(cuda)
    reset_launches()
    got = largest_component_sums(fg)
    assert LAUNCHES["label_stats"] == 1
    ref = largest_component(fg)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", [name for name, _ in _seam_planes()])
def test_label_stats_seams_match_plain(cuda, case):
    fg = dict(_seam_planes())[case]
    mask, stats = _j_equal(fg[None], cuda)
    if case == "tie across bands":
        assert mask[0, 5, 10] and not mask[0, 300, 50]
    if case == "seams":
        assert mask[0, 30, 100] and mask[0, 289, 103]


def _scratch_words(fg):
    """The global scratch J takes for ``fg`` (0: its bands in shared memory)."""
    import ctypes

    from tpu_inspect_torch.kernels import build

    u, h, w = fg.shape
    optin, max_cluster, sms = cc._label_stats_device(fg.device.index)
    words = ctypes.c_longlong(0)
    build.lib().tik_label_stats_scratch(u, h, w, cc.label_stats_cluster(u, max_cluster, sms),
                                        optin, ctypes.addressof(words))
    return words.value


@pytest.mark.cuda
def test_label_stats_batches_and_global_scratch_match_plain(cuda):
    """A batch of units of one size (each on its own cluster), the largest
    square unit (1024x1024, bands in shared memory) and a flat one whose
    band slots do not fit shared memory (8x131072: the global scratch)."""
    rng = np.random.RandomState(29)
    fg = rng.rand(5, 37, 33) > 0.5
    fg[1] = False
    fg[2] = True
    _j_equal(fg, cuda)
    big = rng.rand(1, 1024, 1024) > 0.55
    big[0, 100:900, 500] = True  # one component through every band
    assert _scratch_words(torch.from_numpy(big).to(cuda)) == 0
    _j_equal(big, cuda)
    flat = rng.rand(1, 8, 131072) > 0.5
    flat[0, :, 70000] = True
    assert _scratch_words(torch.from_numpy(flat).to(cuda)) > 0
    _j_equal(flat, cuda)


def _contrib_abs_sum(top, ext):
    """Sum of |contribution| over a plane's crack vertices (the largest a
    region's partial sum can reach in some order), int64, on the card."""
    u, h, w = top.shape
    state = torch.where(top, 2, torch.where(ext, 1, 0)).to(torch.int64)
    sp = torch.ones((u, h + 2, w + 2), dtype=torch.int64, device=top.device)
    sp[:, 1:-1, 1:-1] = state
    cfg = sp[:, :-1, :-1] + 3 * sp[:, :-1, 1:] + 9 * sp[:, 1:, :-1] + 27 * sp[:, 1:, 1:]
    tbl = torch.as_tensor(CONTOUR_TABLE_X2, dtype=torch.int64, device=top.device)
    vy = torch.arange(h + 1, device=top.device)[None, :, None]
    vx = torch.arange(w + 1, device=top.device)[None, None, :]
    return int((tbl[cfg, 0] + tbl[cfg, 1] * vx + tbl[cfg, 2] * vy).abs().sum())


def _g_equal(m_np, cuda, max_x2, min_x2=6):
    m = torch.from_numpy(np.ascontiguousarray(m_np)).to(cuda)
    fill, top, ext = fill_regions(m)
    mx = torch.tensor(max_x2, dtype=torch.int32, device=cuda)
    reset_launches()
    got = blob_select(fill, top, ext, mx, min_x2=min_x2)
    assert LAUNCHES["blob_select"] == 1
    ref = blob_select_plain(fill, top, ext, mx, min_x2=min_x2)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    return got, (fill, top, ext)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 53), (33, 48), (64, 31), (1, 17), (15, 1)])
def test_blob_select_last_odd_row_and_column_match_plain(cuda, h, w):
    """Regions whose first pixel lies in the last (odd) row or column, so
    their slot's block holds one row or column of the plane."""
    rng = np.random.RandomState(h * w)
    m = rng.rand(2, h, w) > 0.6
    m[0, -1, :] = False
    m[0, -1, w // 2] = True  # a one-pixel region in the last row
    m[1, :, -1] = False
    m[1, h // 2, -1] = True  # and in the last column
    m[1, -1, -1] = True
    (out, area), _ = _g_equal(m, cuda, [2 * h * w, 2 * h * w], min_x2=0)
    assert int(area.sum()) > 0


@pytest.mark.cuda
def test_blob_select_region_over_many_chunks_matches_plain(cuda):
    """One ring-shaped region (a hole inside) over 600 rows x 2000 columns:
    thousands of CTAs add to its slot; beside it, small regions."""
    m = np.zeros((1, 640, 2048), bool)
    m[0, 20:620, 24:2024] = True
    m[0, 60:580, 64:1984] = False  # the hole: in the region, not exterior
    m[0, 300:310, 1000:1010] = True  # a blob nested in the hole
    rng = np.random.RandomState(5)
    m[0, 625:640] = rng.rand(15, 2048) > 0.7
    (out, area), _ = _g_equal(m, cuda, [2 * 640 * 2048])
    assert out[0, 300, 100] == 255 and out[0, 305, 1005] == 255


@pytest.mark.cuda
def test_blob_select_whole_capture_sums_pass_2_31(cuda):
    """A whole 3000x4096 capture holding a comb-shaped region (teeth every
    other column): its crack-vertex contributions sum in absolute value past
    2^31, so an int32 slot could not hold its partial sums."""
    m = np.zeros((1, 3000, 4096), bool)
    m[0, 10:2990:1, 8:4088:2] = True  # teeth
    m[0, 10:14, 8:4088] = True  # their spine
    m[0, 2995, 100:200] = True  # a bar on the last row's neighbour
    rng = np.random.RandomState(7)
    m[0, 2996:, :] = rng.rand(4, 4096) > 0.8
    (out, area), (fill, top, ext) = _g_equal(m, cuda, [2 * 3000 * 4096])
    assert _contrib_abs_sum(top, ext) > 2**31
    assert int(area[0]) > 0
