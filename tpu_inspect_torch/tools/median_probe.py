"""Ablation sweep of the median residual's per-pixel window design on the
card (kernel L).

The port of ``tools/median_probe.py``, whose ``probe`` stripped pieces of
the TPU's histogram loop to attribute its time. Kernel L
(``csrc/median_probe.cu``) strips pieces of kernel B's earlier design (a
thread per output pixel counting its k x k window, ``csrc/median_window.cuh``)
instead, each at several tile shapes; kernel B itself now walks a sliding
histogram (``csrc/median_hist.cuh``), so L's baseline is that earlier
design, not B's current body:

- ``baseline``: the earlier design's computation (bit-exact against B's
  plain version);
- ``nofill``: no global -> shared tile fill;
- ``nocount``: no k x k count loop, the centre compare written instead;
- ``norows``: no ROI-row early exit.

The ablations are wrong by construction: they are timed, never compared,
and on the CPU they raise ValueError; there ``baseline`` runs
:func:`tpu_inspect_torch.ops.median.median_residual_mask_plain`.

Usage (on the card): ``python -m tpu_inspect_torch.tools.median_probe
[baseline nofill nocount norows]`` times each mode at each tile shape on
the standard workload's ROI rows at k = 21, thr = 24.
"""

from __future__ import annotations

import statistics
import sys

import torch

from tpu_inspect_torch.kernels import LAUNCHES, build, check_planes, check_vector
from tpu_inspect_torch.ops.median import _check_k, _row_bounds, median_residual_mask_plain

MODES = ("baseline", "nofill", "nocount", "norows")
# (threads along x, along y); (32, 8) was kernel B's tile in that design
TILES = ((32, 8), (32, 16), (64, 8), (16, 16))


def probe(x, k: int, thr: int, row_lo=None, row_hi=None, mode: str = "baseline",
          tile: tuple[int, int] = (32, 8)):
    """Kernel L: the per-pixel window median residual of x [U, H, W] uint8 in ablation
    ``mode`` at ``tile`` -> [U, H, W] uint8. Only ``baseline`` computes the
    median residual; it alone has a plain version, for CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"median_probe: unknown mode {mode!r}, expected one of {MODES}")
    if tuple(tile) not in TILES:
        raise ValueError(f"median_probe: tile {tile} not among {TILES}")
    check_planes(x, "median_probe")
    _check_k(k)
    u, h, w = x.shape
    row_lo, row_hi = _row_bounds(row_lo, row_hi, u, h, x.device)
    check_vector(row_lo, "median_probe row_lo", u, x.device)
    check_vector(row_hi, "median_probe row_hi", u, x.device)
    if x.device.type == "cpu":
        if mode != "baseline":
            raise ValueError(
                f"median_probe: mode {mode!r} is a timing ablation, wrong by construction, "
                "with no plain version: it runs on a CUDA tensor only"
            )
        return median_residual_mask_plain(x, k, thr, row_lo, row_hi)
    out = torch.empty_like(x)
    err = build.lib().tik_median_probe(
        x.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(), out.data_ptr(), u, h, w,
        int(k), int(thr), MODES.index(mode), int(tile[0]), int(tile[1]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("median_probe", err)
    LAUNCHES["median_probe"] += 1
    return out


def roi_rows():
    """The standard workload's crops on the card and its ROI row bounds
    (the reference capture's seg and ROI tails on kernel A)."""
    from tpu_inspect_torch import engine
    from tpu_inspect_torch.config import DefectParams, SegmentationParams
    from tpu_inspect_torch.imageio import gather_crops
    from tpu_inspect_torch.synthetic import standard_workload

    wl = standard_workload()
    image = torch.from_numpy(wl["image"]).to("cuda")
    crops = gather_crops(image, torch.from_numpy(wl["origins"]).to("cuda"), wl["unit_hw"])
    seg = SegmentationParams().validated()
    masks = engine._segment(crops, seg, wl["exclusions"], None, True)[0]
    _, st = engine._defect_roi(masks, DefectParams().validated().erode_px)
    return crops, st[:, 4].contiguous(), st[:, 5].contiguous()


def main(modes=MODES, tiles=TILES, n: int = 32, reps: int = 3) -> dict:
    """Time each mode at each tile shape on the card: ``n`` launches in a
    row between two CUDA events, median of ``reps`` (after a warm-up).
    Prints one line per mode and tile; returns {(mode, tile): ms per
    launch}."""
    from tpu_inspect_torch.device import resolve_device

    resolve_device("cuda")
    crops, row_lo, row_hi = roi_rows()
    u, h, w = crops.shape
    print(f"median probe on {torch.cuda.get_device_name(0)}: {u}x{h}x{w}, k 21, thr 24, "
          f"ROI rows {int((row_hi - row_lo).clamp(min=0).sum())}")
    table = {}
    for tile in tiles:
        for mode in modes:
            probe(crops, 21, 24, row_lo, row_hi, mode, tile)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    probe(crops, 21, 24, row_lo, row_hi, mode, tile)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / n)
            table[(mode, tuple(tile))] = statistics.median(times)
            print(f"{mode:10s} tile {tile[0]:2d}x{tile[1]:<2d} {table[(mode, tuple(tile))]:8.4f} ms "
                  f"(min {min(times):.4f})")
    return table


if __name__ == "__main__":
    main(sys.argv[1:] or MODES)
