"""Connected components, batched [U, H, W]; kernel E — min-index labeling;
kernel F — largest-component stats from labels; kernel J — both in one.

Port of :mod:`tpu_inspect.ops.cc`: 8-connected labels whose value is the
linear index ``y*W + x`` of the component's raster-first pixel (BIG on
background, int32), and the largest component with OpenCV's tie-break.

:func:`label_components` launches ``csrc/label.cu`` (the port of
:func:`tpu_inspect.ops.cc_pallas.label_components_pallas`) for CUDA tensors
and runs :func:`label_components_plain` for CPU tensors;
:func:`component_stats` (kernel F, ``csrc/cc_stats.cu``) and
:func:`largest_component_sums` (kernel J, ``csrc/label_stats.cu``) do the
same with :func:`component_stats_plain` and :func:`largest_component`;
:func:`largest_component_sums_tiled` is kernel F under the JAX package's
whole-image contract, and :func:`component_areas` a torch scatter.

Labels come from a min-label fixpoint: per iteration, a 3x3 neighbourhood
min (8-connectivity only) and segmented cummin sweeps along rows and
columns. A sweep carries a label across a whole run of domain pixels in one
step: each run gets a key ``run_id * K`` (run ids grow along the axis, K
exceeds every label), so ``cummin(v - key) + key`` never lets an earlier
run's value into a later run.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_inspect_torch.kernels import Kernel, as_planes, build, check_labels, error_flag

_LABEL = Kernel("label")
_CC_STATS = Kernel("cc_stats")
_LABEL_STATS = Kernel("label_stats")

BIG = 2**30
_K = 2**31  # > every label value; keys stay in int64


def _seg_cummin(lab: torch.Tensor, dom: torch.Tensor, dim: int) -> torch.Tensor:
    """Min of each label over its run of ``dom`` along ``dim``."""

    def forward(v, d):
        key = torch.cumsum((~d).to(torch.int64), dim=dim) * _K
        vals = torch.where(d, v, _K - 1)
        return torch.cummin(vals - key, dim=dim).values + key

    fwd = forward(lab, dom)
    bwd = forward(lab.flip(dim), dom.flip(dim)).flip(dim)
    return torch.where(dom, torch.minimum(lab, torch.minimum(fwd, bwd)), lab)


def _nbhd_min8(lab: torch.Tensor) -> torch.Tensor:
    """3x3 min with out-of-plane = BIG."""
    u, h, w = lab.shape
    p = torch.full((u, h + 2, w + 2), BIG, dtype=lab.dtype, device=lab.device)
    p[:, 1:-1, 1:-1] = lab
    out = lab
    for dy in range(3):
        for dx in range(3):
            if dy != 1 or dx != 1:
                out = torch.minimum(out, p[:, dy : dy + h, dx : dx + w])
    return out


def propagate_min(init: torch.Tensor, dom: torch.Tensor, conn8: bool) -> torch.Tensor:
    """Fixpoint of per-component minima of ``init`` (int64) over ``dom``
    (bool), 4- or 8-connected. Values off the domain are returned as given."""
    lab = init
    while True:
        new = lab
        if conn8:
            new = torch.where(dom, torch.minimum(new, _nbhd_min8(new)), new)
        new = _seg_cummin(new, dom, dim=2)
        new = _seg_cummin(new, dom, dim=1)
        if torch.equal(new, lab):
            return lab
        lab = new


def label_components_plain(fg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`label_components` (same
    contract)."""
    fg = fg != 0
    u, h, w = fg.shape
    lin = torch.arange(h * w, device=fg.device, dtype=torch.int64).reshape(1, h, w)
    init = torch.where(fg, lin, BIG)
    return propagate_min(init, fg, conn8=True).to(torch.int32)


@_LABEL
def label_components(fg: torch.Tensor, plan: str = "crc", *, err=None) -> torch.Tensor:
    """fg [U, H, W] bool (or uint8, nonzero = fg) -> int32 labels: the
    raster-first pixel index ``y*W + x`` of each 8-connected component,
    BIG on background. ``plan`` is the JAX package's sweep-plan hint for its
    TPU kernel ("crc" or "rc"); the result does not depend on it, and it is
    accepted and ignored here. ``err`` as for
    :func:`tpu_inspect_torch.ops.flood.propagate`."""
    fg = as_planes(fg, "label_components")
    if fg.device.type == "cpu":
        return label_components_plain(fg)
    u, h, w = fg.shape
    if u * h * w >= 2**31:
        raise ValueError(f"label_components: {u}x{h}x{w} too large for int32 indices")
    dev = fg.device
    out = torch.empty((u, h, w), dtype=torch.int32, device=dev)
    # parents are written at run starts only; no zeroing
    parent = torch.empty((u * h * w,), dtype=torch.int32, device=dev)
    bits = torch.empty((u * h * ((w + 31) // 32),), dtype=torch.int32, device=dev)
    flag = error_flag(dev) if err is None else err
    code = build.lib().tik_label(
        fg.data_ptr(), out.data_ptr(), parent.data_ptr(), bits.data_ptr(), flag.data_ptr(),
        u, h, w, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("label_components", code)
    _LABEL.launched()
    if err is None:
        build.check_bounded("label_components", flag)
    return out


def block_rank(h: int, w: int, device) -> torch.Tensor:
    """OpenCV's 2x2-block raster rank of every pixel: block index * 4 +
    position in the block. cv2 numbers 8-connected components by first
    appearance in this order, so an equal-area tie goes to the component
    with the smallest minimum rank (first pixels (3,0) vs (2,28): pixel
    raster says (2,28), cv2 says (3,0), because block (1,0) precedes block
    (1,14))."""
    yy = torch.arange(h, device=device, dtype=torch.int64)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.int64)[None, :]
    bw = (w + 1) // 2
    return ((yy >> 1) * bw + (xx >> 1)) * 4 + (yy & 1) * 2 + (xx & 1)


def largest_component(fg: torch.Tensor):
    """Largest 8-connected component per unit (max area, ties by OpenCV's
    block-raster order), in plain torch ops: it is part of kernel A's plain
    version and launches no kernel. Returns what :func:`component_stats`
    does."""
    return component_stats_plain(label_components_plain(fg), fg)


def component_stats_plain(labels: torch.Tensor, fg: torch.Tensor):
    """The plain PyTorch version of :func:`component_stats` (same
    contract); it launches no kernel."""
    u, h, w = fg.shape
    hw = h * w
    dev = fg.device
    lab = labels.to(torch.int64).reshape(u, hw)
    fgf = fg.reshape(u, hw)
    idx = torch.where(fgf, lab, hw)  # background -> spill bucket hw
    area = torch.zeros((u, hw + 1), dtype=torch.int64, device=dev)
    area.scatter_add_(1, idx, torch.ones_like(idx))
    rank = block_rank(h, w, dev).reshape(1, hw).expand(u, hw)
    first = torch.full((u, hw + 1), 2**62, dtype=torch.int64, device=dev)
    first.scatter_reduce_(1, idx, rank, reduce="amin")
    area, first = area[:, :hw], first[:, :hw]
    # max area, then min first-rank; (area << 32) - rank orders both at once
    score = torch.where(area > 0, (area << 32) - first, -1)
    best = score.argmax(dim=1)
    best_area = area.gather(1, best[:, None])[:, 0]
    mask = (lab == best[:, None]) & fgf & (best_area[:, None] > 0)
    mask = mask.reshape(u, h, w)

    ys = torch.arange(h, device=dev, dtype=torch.int64)
    xs = torch.arange(w, device=dev, dtype=torch.int64)
    m64 = mask.to(torch.int64)
    sx = (m64 * xs[None, None, :]).sum(dim=(1, 2))
    sy = (m64 * ys[None, :, None]).sum(dim=(1, 2))
    rows = mask.any(dim=2)
    cols = mask.any(dim=1)
    has = best_area > 0

    def lo_hi(any_along, n, coords):
        lo = torch.where(any_along, coords, n).amin(dim=1)
        hi = torch.where(any_along, coords + 1, 0).amax(dim=1)
        return lo, hi

    row_lo, row_hi = lo_hi(rows, h, ys[None, :])
    col_lo, col_hi = lo_hi(cols, w, xs[None, :])
    stats = torch.stack(
        [best_area, sx, sy, has.to(torch.int64), row_lo, row_hi, col_lo, col_hi],
        dim=1,
    )
    return mask, stats


@_CC_STATS
def component_stats(labels: torch.Tensor, fg: torch.Tensor, *, err=None):
    """Largest 8-connected component per unit from given labels; kernel F.

    ``labels`` [U, H, W] int32 are :func:`label_components`' (the
    raster-first pixel index of each component of ``fg``) and ``fg`` the
    [U, H, W] bool (or uint8) plane they label. The winner has the largest
    area, ties going to the smallest minimum :func:`block_rank` (OpenCV's
    order). Returns (mask [U, H, W] bool, stats [U, 8] int64) with the stats
    row (area, sx, sy, has_fg, row_lo, row_hi, col_lo, col_hi): sx/sy are
    exact coordinate sums (about 5e10 on a whole 4096x3000 plane); an empty
    unit gives (0, 0, 0, 0, H, 0, W, 0).

    Launches ``csrc/cc_stats.cu`` for CUDA tensors and runs
    :func:`component_stats_plain` for CPU tensors; ``err`` as for
    :func:`tpu_inspect_torch.ops.flood.propagate`."""
    fg = as_planes(fg, "component_stats fg")
    check_labels(labels, fg, "component_stats labels")
    if fg.device.type == "cpu":
        return component_stats_plain(labels, fg != 0)
    u, h, w = fg.shape
    if u * h * w >= 2**31 or u >= 65536:
        raise ValueError(f"component_stats: {u}x{h}x{w} too large for int32 indices")
    dev = fg.device
    mask = torch.empty((u, h, w), dtype=torch.uint8, device=dev)
    stats = torch.empty((u, 8), dtype=torch.int64, device=dev)
    # a row per unit, then one (area, rank) slot per 2x2 block: the block
    # of a component's root pixel is its own (the launcher zeroes it)
    scratch = torch.empty((u * (8 + ((h + 1) // 2) * ((w + 1) // 2)),), dtype=torch.int64,
                          device=dev)
    flag = error_flag(dev) if err is None else err
    code = build.lib().tik_component_stats(
        labels.data_ptr(), fg.data_ptr(), mask.data_ptr(), stats.data_ptr(),
        scratch.data_ptr(), flag.data_ptr(), u, h, w,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("component_stats", code)
    _CC_STATS.launched()
    if err is None:
        build.check_bounded("component_stats", flag)
    return mask.view(torch.bool), stats


def component_areas(labels: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Per-root pixel counts of :func:`label_components`' ``labels`` over
    ``fg``: [U, H*W] int32, 0 for non-roots. One torch ``scatter_add_``
    with a spill bucket for the background (XLA ops in the JAX package:
    no kernel)."""
    u, h, w = labels.shape
    hw = h * w
    idx = torch.where(fg.reshape(u, hw) != 0, labels.reshape(u, hw).to(torch.int64), hw)
    areas = torch.zeros((u, hw + 1), dtype=torch.int32, device=labels.device)
    areas.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return areas[:, :hw]


# the JAX package's tile shape for its tiled stats, kept for the signature
_TILE_HW = (315, 316)


def largest_component_sums_tiled(fg: torch.Tensor, labels: torch.Tensor,
                                 tile_hw: tuple[int, int] = _TILE_HW,
                                 use_tables: bool | None = None):
    """The JAX package's whole-image stats contract on given labels: kernel
    F (:func:`component_stats`). Returns (mask [U, H, W] bool, area [U]
    int32, sx [U], sy [U], has_fg [U] bool), sx/sy int32 where
    ``max(H, W) * H * W < 2**31`` and int64 otherwise, as the JAX package's
    sums. ``tile_hw`` and ``use_tables`` pick the JAX package's TPU tiling;
    the result does not depend on them, and they are accepted and ignored
    here. Raises ValueError unless ``U * H * W < 2**31 - 1``."""
    u, h, w = fg.shape
    if u * h * w >= 2**31 - 1:
        raise ValueError("tiled stats need u*h*w < 2^31")
    mask, stats = component_stats(labels, fg)
    sums = torch.int32 if max(h, w) * h * w < 2**31 else torch.int64
    return (mask, stats[:, 0].to(torch.int32), stats[:, 1].to(sums), stats[:, 2].to(sums),
            stats[:, 3] > 0)


# Kernel J runs one unit on a thread-block cluster: a unit above this many
# pixels (a whole capture) takes kernels E then F instead. The same size as
# the engine's whole-image gate (``engine.WHOLE_MIN_PX``).
LABEL_STATS_MAX_PX = 1 << 20


@functools.lru_cache(maxsize=None)
def _label_stats_device(index: int) -> tuple[int, int, int]:
    """Kernel J's launch attributes set on device ``index``, once; returns
    (the opt-in shared memory a block may use there, the largest cluster
    its launches may take, the SM count)."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        code = build.lib().tik_label_stats_setup(ctypes.addressof(out))
    build.check("largest_component_sums", code)
    return out[0], out[1], torch.cuda.get_device_properties(index).multi_processor_count


def label_stats_cluster(u: int, max_cluster: int, sms: int) -> int:
    """The CTAs a unit takes at most: the card's SMs shared by the ``u``
    units, 1 to ``max_cluster`` (one unit, the erosion preview, takes the
    most)."""
    return max(1, min(max_cluster, sms // max(1, u)))


@_LABEL_STATS
def largest_component_sums(fg: torch.Tensor, err=None):
    """Largest 8-connected component per unit from the plane itself; kernel
    J (the port of :func:`tpu_inspect.ops.cc.largest_component_sums` on its
    TPU branch, ``cc_pallas.py: largest_component_stats_pallas``).

    ``fg`` [U, H, W] bool (or uint8, nonzero = fg). Returns exactly what
    ``component_stats(label_components(fg), fg)`` does: (mask [U, H, W]
    bool, stats [U, 8] int64 (area, sx, sy, has_fg, row_lo, row_hi, col_lo,
    col_hi)), OpenCV's block-raster tie-break included, with no label plane
    in between. Launches ``csrc/label_stats.cu`` for CUDA tensors and runs
    :func:`largest_component` for CPU tensors; a unit above
    ``LABEL_STATS_MAX_PX`` pixels raises ValueError. ``err`` as for
    :func:`tpu_inspect_torch.ops.flood.propagate`."""
    fg = as_planes(fg, "largest_component_sums")
    u, h, w = fg.shape
    if h * w > LABEL_STATS_MAX_PX:
        raise ValueError(
            f"largest_component_sums: a {h}x{w} unit is above {LABEL_STATS_MAX_PX} px; "
            "use component_stats(label_components(fg), fg)"
        )
    if fg.device.type == "cpu":
        return largest_component(fg != 0)
    dev = fg.device
    optin, max_cluster, sms = _label_stats_device(dev.index)
    cmax = label_stats_cluster(u, max_cluster, sms)
    lib = build.lib()
    mask = torch.empty((u, h, w), dtype=torch.uint8, device=dev)
    stats = torch.empty((u, 8), dtype=torch.int64, device=dev)
    # the bands' parents, areas and bits, for units whose bands do not fit
    # a block's shared memory (none for the others)
    words = ctypes.c_longlong(0)
    build.check("largest_component_sums",
                lib.tik_label_stats_scratch(u, h, w, cmax, optin, ctypes.addressof(words)))
    scratch = torch.empty((words.value,), dtype=torch.int32, device=dev)
    flag = error_flag(dev) if err is None else err
    code = lib.tik_label_stats(
        fg.data_ptr(), mask.data_ptr(), stats.data_ptr(), scratch.data_ptr(), flag.data_ptr(),
        u, h, w, cmax, optin, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check("largest_component_sums", code)
    _LABEL_STATS.launched()
    if err is None:
        build.check_bounded("largest_component_sums", flag)
    return mask.view(torch.bool), stats
