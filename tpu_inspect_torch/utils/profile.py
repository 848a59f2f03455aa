"""Device self-time per kernel and op under ``torch.profiler``.

The port's counterpart of the JAX package's trace reader
(``tpu_inspect/utils/xprof.py``, ``device_op_totals``) and of
``tools/profile_selftime.py``: it runs a callable under the profiler with
the CPU and CUDA activities and sums, per name, the device-side events
(kernels, memcpys, memsets) only, so an aten op's row never repeats the
device time of the kernels it launched. ``python -m tpu_inspect_torch.cli
profile`` prints the table for the standard workload; ``chip_smoke.py``
prints it for every path it times.

Without a CUDA device nothing runs on a device, so the table is empty: a
host run is never reported as device time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass
class DeviceProfile:
    iters: int
    wall_ms: float  # host wall per iteration, under the profiler
    rows: list[tuple[str, float, float]]  # (name, device ms, launches), per iteration

    @property
    def busy_ms(self) -> float:
        """Device time per iteration, summed over every kernel and copy."""
        return sum(ms for _, ms, _ in self.rows)

    @property
    def idle_share(self) -> float:
        """1 - busy / wall: an upper bound, since the profiler adds host cost."""
        return 1.0 - self.busy_ms / self.wall_ms if self.wall_ms > 0 else 0.0


def profile_device(run, iters: int = 5) -> DeviceProfile:
    """Call ``run`` once to warm up, then ``iters`` times under
    ``torch.profiler``; returns the device time per name and iteration,
    largest first, and the host wall per iteration of the profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    run()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key.startswith("Activity"):
            continue
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((ev.key, us / iters / 1e3, ev.count / iters))
    rows.sort(key=lambda r: r[1], reverse=True)
    return DeviceProfile(iters=iters, wall_ms=wall, rows=rows)
