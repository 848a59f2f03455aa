"""The device trace of a ``--trace 1`` run: two slices of the window under
``torch.profiler``, each starting with nothing in flight and ending once
its frames are done, so every device operation in a slice belongs to its
frames.

- Slice ``device`` records the card alone (CUPTI: kernels, copies, sets),
  which adds next to nothing to the host's work: the device's busy time
  (the union of its operations' intervals), the idle share, the operations
  and the kernels' times per frame come from it.
- Slice ``host`` records the host's operations too, for the breakdown's
  idle gaps: what the host was doing while the card idled. The profiler's
  own cost on the host lengthens those gaps, so no metric reads this
  slice.

The device slice starts once ``START_SHARE`` of the window has passed and
takes ``DEVICE_SLICE_FRAMES`` frames, the host slice the next
``HOST_SLICE_FRAMES``. :func:`warm` runs the profiler once in set-up, so
neither slice pays its first start.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.loop import clock

START_SHARE = 0.3
DEVICE_SLICE_FRAMES = 256
HOST_SLICE_FRAMES = 48
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}


def op_name(name: str) -> str:
    """A device operation's name without its return type, namespaces,
    template arguments and parameters: ``void ns::k<8, (anonymous
    namespace)::T>(int const*)`` -> ``k``."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    name = name.replace("(anonymous namespace)", "anon")
    depth, base = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            base.append(ch)
    words = "".join(base).split()
    return words[-1].split("::")[-1] if words else name


@dataclass
class Slice:
    frames: int = 0
    wall_s: float = 0.0
    device: list = field(default_factory=list)  # (name, start_us, dur_us)
    host: list = field(default_factory=list)  # (name, cat, start_us, dur_us)

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals (us), in order."""
        out: list[list[float]] = []
        for _, s, d in sorted(self.device, key=lambda e: e[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s + d)
            else:
                out.append([s, s + d])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def kernel_s(self, names) -> float:
        return sum(d for n, _, d in self.device if op_name(n) in names) * 1e-6


def _activities(name: str) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():  # the CPU tests rehearse a trace with no card
        acts = [torch.profiler.ProfilerActivity.CUDA] + (acts if name == "host" else [])
    return acts


def warm(step) -> None:
    """Run ``step()`` under the profiler once, with both slices'
    activities, and drop the trace."""
    with torch.profiler.profile(activities=_activities("host")):
        step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _read(prof) -> tuple[list, list]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0))))
        elif cat in _HOST_CATS:
            host.append((e.get("name", ""), cat, float(e["ts"]), float(e.get("dur", 0))))
    return dev, host


class Tracer:
    """Takes the two slices of a loop's window; the loop calls
    :meth:`before_dispatch` before each frame."""

    def __init__(self, loop, seconds: float):
        self.loop, self.seconds = loop, seconds
        self.t0 = None
        self.first = None  # when the first slice began
        self.slices: dict[str, Slice] = {}
        self.in_slice: set[int] = set()  # frame indices dispatched in a slice
        self._order = [("device", DEVICE_SLICE_FRAMES), ("host", HOST_SLICE_FRAMES)]
        self._prof = None
        self._cur = None

    def annotate(self, name: str):
        if self._cur == "host":
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def before_dispatch(self) -> None:
        now = clock()
        if self.t0 is None:
            self.t0 = now
        if self._prof is not None:
            s = self.slices[self._cur]
            if s.frames >= self._length:
                self._stop(s)
            else:
                s.frames += 1
                self.in_slice.add(len(self.loop.frames))
                return
        if self._order and now - self.t0 >= START_SHARE * self.seconds:
            name, self._length = self._order.pop(0)
            self._begin(name)
            self.slices[name].frames += 1
            self.in_slice.add(len(self.loop.frames))

    def _sync(self) -> None:
        self.loop.drain(60.0)
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _begin(self, name: str) -> None:
        if self.first is None:
            self.first = clock()
        self._sync()
        self._prof = torch.profiler.profile(activities=_activities(name))
        self._prof.__enter__()
        self._cur = name
        self.slices[name] = Slice()
        self._start = clock()

    def _stop(self, s: Slice) -> None:
        self._sync()
        s.wall_s = clock() - self._start
        self._prof.__exit__(None, None, None)
        s.device, s.host = _read(self._prof)
        self._prof, self._cur = None, None

    def finish(self) -> None:
        if self._prof is not None:
            self._stop(self.slices[self._cur])


def breakdown(slices: dict[str, Slice]) -> dict:
    """The result line's ``breakdown``: the device operations that took
    the most time in the device slice (seconds summed over it), and the
    host slice's idle seconds by what the host was doing (the harness's
    phase and the host operation that overlaps the gap most)."""
    out = {}
    dev = slices.get("device")
    if dev and dev.device:
        tot: dict[str, float] = {}
        for n, _, d in dev.device:
            tot[op_name(n)] = tot.get(op_name(n), 0.0) + d * 1e-6
        out["device_ops"] = sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:10]
    host = slices.get("host")
    if host and host.device and host.host:
        out["idle_gaps"] = _idle_gaps(host)
    return out


def _idle_gaps(sl: Slice) -> list:
    """Idle seconds of the card in slice ``sl`` by what the host was doing:
    each gap between busy intervals is put under the harness's phase and
    the host operation that overlap it most."""
    busy = sl.busy()
    g0 = np.array([a[1] for a in busy[:-1]])
    g1 = np.array([b[0] for b in busy[1:]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    best = {True: np.zeros(len(g0)), False: np.zeros(len(g0))}
    name = {True: [""] * len(g0), False: [""] * len(g0)}
    for n, cat, s, d in sl.host:
        phase = cat == "user_annotation" and n.startswith("bench.")
        lo = int(np.searchsorted(g1, s, side="right"))
        hi = int(np.searchsorted(g0, s + d, side="left"))
        for k in range(lo, hi):
            ov = min(g1[k], s + d) - max(g0[k], s)
            if ov > best[phase][k]:
                best[phase][k], name[phase][k] = ov, n
    by: dict[str, float] = {}
    for k in range(len(g0)):
        key = f"{name[True][k] or 'bench.?'}: {op_name(name[False][k]) if name[False][k] else 'none'}"
        by[key] = by.get(key, 0.0) + float(g1[k] - g0[k]) * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:10]
