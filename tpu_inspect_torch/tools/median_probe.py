"""Ablation sweep of kernel B's sliding-histogram walk on the card
(kernel L).

The port of ``tools/median_probe.py``, whose ``probe`` stripped pieces of
the TPU's row loop to attribute its median kernel's time to them. Kernel L
(``csrc/median_probe.cu``) is kernel B itself (``median_hist.cuh``:
``residual``, the same grid and 16-bit bins), templated on a mode that
strips one piece of the walk B and H run:

- ``baseline``: nothing, B's kernel (bit-exact against B's plain version);
- ``nowarm``: the warm-up rows, each strip starting from zeroed bins;
- ``noupdate``: the step down, every row querying the warm-up's bins;
- ``noatomic``: the shared atomics, each bin update a plain (racing)
  load-add-store;
- ``noquery``: the band query, the median emitted from registers.

The JAX probe's ``nomatmul`` and ``nomask`` strip the TPU's bf16 band
matmul and query mask, which the walk does not have: no counterpart. The
ablations are wrong by construction: they are timed, never compared, and
on the CPU they raise ValueError; there ``baseline`` runs
:func:`tpu_inspect_torch.ops.median.median_residual_mask_plain`.

Usage (on the card): ``python -m tpu_inspect_torch.tools.median_probe
[baseline nowarm noupdate noatomic noquery]`` times each mode (the baseline
always) at each strip length S on the standard workload's ROI rows at
k = 21, thr = 24, and prints beside each ablation its share of the baseline
at the same S, (baseline - mode) / baseline: the share of B's time that
piece takes.
"""

from __future__ import annotations

import statistics
import sys

import torch

from tpu_inspect_torch.kernels import Kernel, build, check_planes, check_vector
from tpu_inspect_torch.ops.median import _check_k, _row_bounds, median_residual_mask_plain

_MEDIAN_PROBE = Kernel("median_probe")

# in the order of csrc/median_hist.cuh's Mode, which the kernel takes as its index
MODES = ("baseline", "nowarm", "noupdate", "noatomic", "noquery")
# the strip rows S: ops/median.py's MIN_STRIP_ROWS up to twice
# RESIDUAL_STRIP_ROWS (32, kernel B's S on grid units)
STRIPS = (8, 16, 32, 64)


@_MEDIAN_PROBE
def probe(x, k: int, thr: int, row_lo=None, row_hi=None, mode: str = "baseline",
          strip: int = 32):
    """Kernel L: kernel B's median residual of x [U, H, W] uint8 in ablation
    ``mode`` with strips of ``strip`` rows -> [U, H, W] uint8. Only
    ``baseline`` computes the median residual; it alone has a plain
    version, for CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"median_probe: unknown mode {mode!r}, expected one of {MODES}")
    if strip not in STRIPS:
        raise ValueError(f"median_probe: strip {strip!r} not among {STRIPS}")
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
    if u >= 65536:
        raise ValueError(f"median_probe: {u} units beyond the kernel's grid")
    out = torch.empty_like(x)
    err = build.lib().tik_median_probe(
        x.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(), out.data_ptr(), u, h, w,
        int(k), int(thr), MODES.index(mode), int(strip),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check("median_probe", err)
    _MEDIAN_PROBE.launched()
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


def shares(table: dict) -> dict:
    """{(mode, strip): (baseline - mode) / baseline} for each ablation timed
    beside the baseline at its strip, from :func:`main`'s table."""
    return {(m, s): (table[("baseline", s)] - ms) / table[("baseline", s)]
            for (m, s), ms in table.items() if m != "baseline" and ("baseline", s) in table}


def main(modes=MODES, strips=STRIPS, n: int = 32, reps: int = 3) -> dict:
    """Time each mode (the baseline always, first) at each strip length on
    the card: ``n`` launches in a row between two CUDA events, median of
    ``reps`` (after a warm-up). Prints one line per mode and strip, each
    ablation with its share of the baseline at that strip; returns
    {(mode, strip): ms per launch}."""
    from tpu_inspect_torch.device import resolve_device

    resolve_device("cuda")
    bad = [m for m in modes if m not in MODES]
    if bad:
        raise ValueError(f"median_probe: unknown modes {bad}, expected some of {MODES}")
    modes = ("baseline", *(m for m in MODES[1:] if m in modes))
    crops, row_lo, row_hi = roi_rows()
    u, h, w = crops.shape
    print(f"median probe on {torch.cuda.get_device_name(0)}: {u}x{h}x{w}, k 21, thr 24, "
          f"ROI rows {int((row_hi - row_lo).clamp(min=0).sum())}")
    table = {}
    for strip in strips:
        for mode in modes:
            probe(crops, 21, 24, row_lo, row_hi, mode, strip)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    probe(crops, 21, 24, row_lo, row_hi, mode, strip)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / n)
            ms = table[(mode, strip)] = statistics.median(times)
            base = table[("baseline", strip)]
            print(f"{mode:9s} S {strip:2d} {ms:8.4f} ms (min {min(times):.4f})"
                  + ("" if mode == "baseline" else
                     f", share of the baseline {(base - ms) / base:+.4f}"))
        # nowarm's wrong counts drive its band loop to its bound, so the
        # warm-up's share shows as what the step and the query leave
        sh = shares(table)
        if ("noupdate", strip) in sh and ("noquery", strip) in sh:
            print(f"S {strip:2d}: the rest of the baseline (the warm-up, the launch, the zero "
                  f"rows), 1 - noupdate's - noquery's share: "
                  f"{1 - sh[('noupdate', strip)] - sh[('noquery', strip)]:+.4f}")
    return table


if __name__ == "__main__":
    main(sys.argv[1:] or MODES)
